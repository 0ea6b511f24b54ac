"""Auxiliary fake services backing the L2 providers.

A copy of the JAX package's `cloud/services.py`: the analogs of Karpenter's
non-EC2 fakes (karpenter:pkg/fake/{iamapi,ssmapi,pricingapi,eksapi}.go) —
an identity service for instance profiles, a parameter store for image
resolution, an on-demand price list, and a control-plane version endpoint.
Each counts calls and supports one-shot error injection like FakeCloud.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from .fake import CloudError


class _Service:
    def __init__(self):
        self._lock = threading.RLock()
        self.calls: Dict[str, int] = {}
        self.next_error: Optional[Exception] = None

    def _count(self, api: str):
        self.calls[api] = self.calls.get(api, 0) + 1

    def _maybe_raise(self):
        if self.next_error is not None:
            err, self.next_error = self.next_error, None
            raise err


class FakeIAM(_Service):
    """Instance-profile store (karpenter:pkg/fake/iamapi.go)."""

    def __init__(self):
        super().__init__()
        self.profiles: Dict[str, Dict[str, str]] = {}  # name → {role, ...tags}

    def create_instance_profile(self, name: str, tags: Dict[str, str]) -> None:
        with self._lock:
            self._count("create_instance_profile")
            self._maybe_raise()
            if name in self.profiles:
                raise CloudError("EntityAlreadyExists", name)
            self.profiles[name] = {"_roles": "", **(tags or {})}

    def get_instance_profile(self, name: str) -> Dict[str, str]:
        with self._lock:
            self._count("get_instance_profile")
            self._maybe_raise()
            if name not in self.profiles:
                raise CloudError("NoSuchEntity", name)
            return dict(self.profiles[name])

    def add_role_to_instance_profile(self, name: str, role: str) -> None:
        with self._lock:
            self._count("add_role_to_instance_profile")
            self._maybe_raise()
            if name not in self.profiles:
                raise CloudError("NoSuchEntity", name)
            if self.profiles[name]["_roles"]:
                raise CloudError("LimitExceeded", "profile already has a role")
            self.profiles[name]["_roles"] = role

    def remove_role_from_instance_profile(self, name: str, role: str) -> None:
        with self._lock:
            self._count("remove_role_from_instance_profile")
            self._maybe_raise()
            if name in self.profiles:
                self.profiles[name]["_roles"] = ""

    def delete_instance_profile(self, name: str) -> None:
        with self._lock:
            self._count("delete_instance_profile")
            self._maybe_raise()
            if name not in self.profiles:
                raise CloudError("NoSuchEntity", name)
            del self.profiles[name]


class FakeParameterStore(_Service):
    """Published-image parameter store — the SSM analog the image resolver
    queries (karpenter:pkg/fake/ssmapi.go)."""

    def __init__(self):
        super().__init__()
        self.parameters: Dict[str, str] = {}

    def get_parameter(self, name: str) -> str:
        with self._lock:
            self._count("get_parameter")
            self._maybe_raise()
            if name not in self.parameters:
                raise CloudError("ParameterNotFound", name)
            return self.parameters[name]


class FakePricingAPI(_Service):
    """On-demand price list (karpenter:pkg/fake/pricingapi.go)."""

    def __init__(self):
        super().__init__()
        self.on_demand: Dict[str, float] = {}  # instance type → $/h

    def list_prices(self) -> Dict[str, float]:
        with self._lock:
            self._count("list_prices")
            self._maybe_raise()
            return dict(self.on_demand)


class FakeControlPlane(_Service):
    """Cluster control-plane endpoint (karpenter:pkg/fake/eksapi.go +
    the kube version the version provider caches)."""

    def __init__(self, version: str = "1.28", endpoint: str = "https://cluster.local",
                 kube_dns_ip: str = "10.100.0.10"):
        super().__init__()
        self.version = version
        self.endpoint = endpoint
        # the kube-dns service address: IPv4 by default; an IPv6 (single-
        # stack) cluster publishes an IPv6 service IP here (the reference
        # discovers it from the kube-dns Service, operator.go:248-261)
        self.kube_dns_ip = kube_dns_ip

    def server_version(self) -> str:
        with self._lock:
            self._count("server_version")
            self._maybe_raise()
            return self.version

    def describe_cluster(self) -> Dict[str, str]:
        with self._lock:
            self._count("describe_cluster")
            self._maybe_raise()
            return {"endpoint": self.endpoint, "version": self.version}

    def kube_dns(self) -> str:
        with self._lock:
            self._count("kube_dns")
            self._maybe_raise()
            return self.kube_dns_ip
