"""Image-family resolver + per-family bootstrap userdata.

A copy of the JAX package's `providers/imagefamily.py`, which
re-implements karpenter:pkg/providers/amifamily/:
  * image resolution — explicit selector terms, else the family's published
    parameter-store path for the control-plane version
    (`Provider.Get` ami.go:116-136, SSM paths in al2.go/bottlerocket.go);
  * newest-image-per-architecture mapping of images → compatible instance
    types (`MapToInstanceTypes` ami.go:92);
  * `Resolver.resolve` — group a launch's instance types by image and
    produce per-group LaunchSpecs with generated bootstrap userdata
    (resolver.go:118-177);
  * bootstrap generators per family: the `script` family merges custom
    userdata as MIME multipart ahead of the bootstrap script
    (bootstrap/eksbootstrap.go:40-123), the `config` family merges TOML-style
    key=value settings (bottlerocket.go), `custom` passes userdata through
    untouched (custom.go).
"""

from __future__ import annotations

import email
import json
from dataclasses import dataclass, field
from email.mime.multipart import MIMEMultipart
from email.mime.text import MIMEText
from typing import Dict, List, Optional, Sequence, Tuple

from ..api import labels as wk
from ..api.objects import KubeletConfiguration, NodeClass
from ..catalog.instancetype import InstanceType
from ..cloud.fake import CloudError, ImageInfo
from . import matches_selector
from .version import VersionProvider

FAMILIES = ("standard", "config", "custom")
# published parameter paths per (family, arch) — SSM path analog
# (al2.go: /aws/service/eks/optimized-ami/$version/amazon-linux-2/...)
PARAM_PATH = "/karpenter-tpu/images/{family}/{version}/{arch}/latest"


@dataclass
class LaunchSpec:
    """One resolved (image × userdata × instance-type-group) launch shape —
    the reference's amifamily.LaunchTemplate options (resolver.go:118-177)."""
    image: ImageInfo
    user_data: str
    instance_types: List[InstanceType]
    security_group_ids: Tuple[str, ...] = ()
    instance_profile: str = ""
    block_device_gib: int = 20
    block_device_mappings: tuple = ()
    metadata_options: tuple = ()         # sorted (key, value) pairs
    detailed_monitoring: bool = False
    instance_store_policy: str = ""
    associate_public_ip: Optional[bool] = None
    tags: Dict[str, str] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Bootstrap userdata generation (bootstrap/ package analog)
# ---------------------------------------------------------------------------

def _resolve_dns(kubelet: Optional[KubeletConfiguration],
                 cluster_dns: str) -> str:
    """Pool kubelet config wins; else the cluster's discovered kube-dns IP
    (v4 or v6 — IPv6 clusters bootstrap with their v6 service address).
    The ONE copy of the precedence rule for every userdata family."""
    if kubelet is not None and kubelet.cluster_dns:
        return kubelet.cluster_dns[0]
    return cluster_dns


def _bootstrap_script(cluster_name: str, endpoint: str, labels: Dict[str, str],
                      taints: Sequence, max_pods: Optional[int],
                      dns: str = "") -> str:
    """The family's node-join script (eksbootstrap.go bootstrap flags)."""
    args = [f"--cluster {cluster_name}", f"--endpoint {endpoint}"]
    if labels:
        kv = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
        args.append(f"--node-labels {kv}")
    if taints:
        ts = ",".join(f"{t.key}={t.value}:{t.effect}" for t in taints)
        args.append(f"--register-with-taints {ts}")
    if max_pods is not None:
        args.append(f"--max-pods {max_pods}")
    if dns:
        args.append(f"--cluster-dns {dns}")
    joined = " \\\n  ".join(args)
    return f"#!/bin/bash\nset -euo pipefail\n/opt/node/bootstrap.sh \\\n  {joined}\n"


def merge_mime(custom: str, bootstrap: str) -> str:
    """MIME-multipart merge: custom part(s) first, bootstrap last, so user
    hooks run before node join (eksbootstrap.go:40-123 mergeCustomUserData)."""
    mm = MIMEMultipart("mixed", boundary="//KARPENTER-TPU//")
    parts: List[Tuple[str, str]] = []
    if custom.strip():
        head = "\n".join(custom.splitlines()[:3])
        if "MIME-Version" in head or "Content-Type: multipart" in head:
            msg = email.message_from_string(custom)
            for part in msg.walk():
                if part.get_content_maintype() == "multipart":
                    continue
                parts.append((part.get_content_type(),
                              part.get_payload(decode=False)))
        else:
            parts.append(("text/x-shellscript", custom))
    parts.append(("text/x-shellscript", bootstrap))
    for ctype, payload in parts:
        sub = MIMEText(payload, ctype.split("/", 1)[1])  # 7bit, human-readable
        sub.replace_header("Content-Type", f'{ctype}; charset="us-ascii"')
        mm.attach(sub)
    return mm.as_string()


def merge_config(custom: str, settings: Dict[str, str]) -> str:
    """TOML-style `key = "value"` merge where generated settings win on
    conflict (bottlerocket.go userdata merge)."""
    out: Dict[str, str] = {}
    for line in custom.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        k, v = line.split("=", 1)
        out[k.strip()] = v.strip().strip('"')
    out.update(settings)
    return "\n".join(f'{k} = "{v}"' for k, v in sorted(out.items())) + "\n"


def generate_user_data(family: str, cluster_name: str, endpoint: str,
                       custom: str = "", labels: Optional[Dict[str, str]] = None,
                       taints: Sequence = (), kubelet=None,
                       max_pods: Optional[int] = None,
                       cluster_dns: str = "") -> str:
    if family == "custom":
        return custom  # verbatim; operator owns the whole bootstrap (custom.go)
    if family == "config":
        settings = {"cluster.name": cluster_name, "cluster.endpoint": endpoint}
        for k, v in sorted((labels or {}).items()):
            settings[f"node.labels.{k}"] = v
        for t in taints:
            settings[f"node.taints.{t.key}"] = f"{t.value}:{t.effect}"
        if max_pods is not None:
            settings["node.max-pods"] = str(max_pods)
        dns = _resolve_dns(kubelet, cluster_dns)
        if dns:
            settings["node.cluster-dns-ip"] = dns
        return merge_config(custom, settings)
    script = _bootstrap_script(cluster_name, endpoint, labels or {}, taints,
                               max_pods, _resolve_dns(kubelet, cluster_dns))
    return merge_mime(custom, script)


# ---------------------------------------------------------------------------
# Image resolution
# ---------------------------------------------------------------------------

class ImageProvider:
    """Resolves a nodeclass to concrete images (ami.go Provider.Get:116-136),
    TTL-cached per (family, version, selector) so per-launch resolution stays
    off the I/O path (the reference caches AMI resolution the same way)."""

    IMAGE_CACHE_TTL = 60.0

    def __init__(self, cloud, params, version_provider: VersionProvider,
                 clock=None):
        self.cloud = cloud
        self.params = params
        self.version_provider = version_provider
        from ..cloud.cache import TTLCache
        self._cache = TTLCache(self.IMAGE_CACHE_TTL,
                               **({"clock": clock} if clock else {}))

    def get(self, nodeclass: NodeClass, archs: Sequence[str] = ("amd64", "arm64")
            ) -> List[ImageInfo]:
        # the control-plane version is part of the published path, so it is
        # part of the key; empty resolutions are NOT cached (a transient
        # failure must not block launches for a whole TTL)
        key = (nodeclass.image_family, self.version_provider.get(),
               tuple(archs), tuple(sorted(nodeclass.image_selector.items())))
        cached = self._cache.get(key)
        if cached is not None:
            return list(cached)
        out = self._resolve(nodeclass, archs)
        if out:
            self._cache.set(key, out)
        return list(out)

    def reset_cache(self):
        self._cache.flush()

    def _resolve(self, nodeclass: NodeClass, archs: Sequence[str]
                 ) -> List[ImageInfo]:
        if nodeclass.image_selector:
            images = [i for i in self.cloud.describe_images()
                      if matches_selector(i.id, i.tags, nodeclass.image_selector,
                                          obj_name=i.name) and not i.deprecated]
            return sorted(images, key=lambda i: (-i.creation_ts, i.id))
        version = self.version_provider.get()
        out = []
        for arch in archs:
            path = PARAM_PATH.format(family=nodeclass.image_family,
                                     version=version, arch=arch)
            try:
                image_id = self.params.get_parameter(path)
            except CloudError:
                continue
            found = self.cloud.describe_images(ids=[image_id])
            out.extend(i for i in found if not i.deprecated)
        return sorted(out, key=lambda i: (-i.creation_ts, i.id))


def map_to_instance_types(images: Sequence[ImageInfo],
                          instance_types: Sequence[InstanceType]
                          ) -> Dict[str, List[InstanceType]]:
    """image id → compatible instance types; newest image per architecture
    wins (ami.go MapToInstanceTypes:92)."""
    newest_per_arch: Dict[str, ImageInfo] = {}
    for img in images:  # images arrive newest-first
        newest_per_arch.setdefault(img.architecture, img)
    out: Dict[str, List[InstanceType]] = {}
    for it in instance_types:
        arch_req = it.requirements.get(wk.ARCH)
        for arch, img in newest_per_arch.items():
            if arch_req is None or arch_req.has(arch):
                out.setdefault(img.id, []).append(it)
                break
    return out


class Resolver:
    """amifamily.Resolver (resolver.go:118-177): nodeclass + claim context →
    LaunchSpecs grouped by image."""

    def __init__(self, image_provider: ImageProvider, cluster_name: str,
                 endpoint: str, cluster_dns: str = ""):
        self.image_provider = image_provider
        self.cluster_name = cluster_name
        self.endpoint = endpoint
        # discovered kube-dns service IP (v4 or v6) — the bootstrap default
        # when a pool's kubelet config doesn't pin its own cluster-dns
        # (reference kubeDNSIP discovery, operator.go:248-261)
        self.cluster_dns = cluster_dns

    def resolve(self, nodeclass: NodeClass, instance_types: Sequence[InstanceType],
                labels: Optional[Dict[str, str]] = None, taints: Sequence = (),
                kubelet=None, max_pods: Optional[int] = None,
                security_group_ids: Tuple[str, ...] = (),
                instance_profile: str = "") -> List[LaunchSpec]:
        images = self.image_provider.get(nodeclass)
        if not images:
            raise CloudError("ImageNotFound",
                             f"no images for family {nodeclass.image_family}")
        by_image = map_to_instance_types(images, instance_types)
        img_index = {i.id: i for i in images}
        specs = []
        for image_id, its in by_image.items():
            user_data = generate_user_data(
                nodeclass.image_family, self.cluster_name, self.endpoint,
                custom=nodeclass.user_data, labels=labels, taints=taints,
                kubelet=kubelet, max_pods=max_pods,
                cluster_dns=self.cluster_dns)
            specs.append(LaunchSpec(
                image=img_index[image_id], user_data=user_data,
                instance_types=its, security_group_ids=security_group_ids,
                instance_profile=instance_profile,
                block_device_gib=nodeclass.block_device_gib,
                block_device_mappings=tuple(
                    json.dumps(m, sort_keys=True)
                    for m in nodeclass.block_device_mappings),
                metadata_options=tuple(
                    sorted(nodeclass.metadata_options.items())),
                detailed_monitoring=nodeclass.detailed_monitoring,
                instance_store_policy=nodeclass.instance_store_policy,
                associate_public_ip=nodeclass.associate_public_ip,
                tags=dict(nodeclass.tags)))
        return specs
