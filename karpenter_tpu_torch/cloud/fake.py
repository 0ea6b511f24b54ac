"""In-memory fake cloud.

A copy of the JAX package's `cloud/fake.py` (the analog of Karpenter's
test backend, pkg/fake/ec2api.go:40-120: a thread-safe instance store, a
stateful CreateFleet that launches in-memory instances, and an
`insufficient_capacity_pools` knob injecting ICE per (type, zone,
capacityType)), trimmed to the launch path: the network inventory, the
interruption queue, chaos injection and the warm-restart export are left
out."""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

ICE_CODE = "InsufficientInstanceCapacity"


class CloudError(Exception):
    def __init__(self, code: str, message: str = ""):
        super().__init__(f"{code}: {message}")
        self.code = code


@dataclass
class CloudInstance:
    id: str
    instance_type: str
    zone: str
    capacity_type: str
    price: float
    tags: Dict[str, str] = field(default_factory=dict)
    state: str = "running"
    launched_at: float = field(default_factory=time.time)
    subnet_id: str = ""
    image_id: str = ""
    launch_template: str = ""


@dataclass
class FleetOverride:
    """One (instanceType × zone × capacityType) launch candidate, price-ordered
    — the CreateFleet override list
    (karpenter:pkg/providers/instance/instance.go:327-367)."""
    instance_type: str
    zone: str
    capacity_type: str
    price: float
    subnet_id: str = ""
    launch_template: str = ""
    image_id: str = ""


@dataclass
class FleetError:
    override: FleetOverride
    code: str


@dataclass
class FleetResult:
    instances: List[CloudInstance]
    errors: List[FleetError]


class FakeCloud:
    """The cloud API the provider talks to.  Thread-safe; failure injection
    via `insufficient_capacity_pools`, `next_error` and `throttle_until`."""

    def __init__(self, clock: Callable[[], float] = time.time):
        self.clock = clock
        self._lock = threading.RLock()
        self._instances: Dict[str, CloudInstance] = {}
        self._ids = itertools.count(1)
        # (capacity_type, instance_type, zone) pools that ICE
        self.insufficient_capacity_pools: Set[Tuple[str, str, str]] = set()
        self.next_error: Optional[Exception] = None
        self.calls: Dict[str, int] = {}
        # every API call fails with RequestLimitExceeded while
        # clock() < throttle_until (API throttle burst injection)
        self.throttle_until: float = 0.0

    # ---- test knobs ----
    def reset(self):
        with self._lock:
            self._instances.clear()
            self.insufficient_capacity_pools.clear()
            self.next_error = None
            self.calls.clear()
            self.throttle_until = 0.0

    def _count(self, api: str):
        self.calls[api] = self.calls.get(api, 0) + 1

    def _maybe_raise(self):
        if self.next_error is not None:
            err, self.next_error = self.next_error, None
            raise err
        if self.clock() < self.throttle_until:
            raise CloudError("RequestLimitExceeded", "throttle window open")

    # ---- APIs ----
    def create_fleet(self, overrides: Sequence[FleetOverride], count: int = 1,
                     tags: Optional[Dict[str, str]] = None) -> FleetResult:
        """Launch `count` instances from the cheapest non-ICE'd override —
        CreateFleet(instant) semantics incl. partial-failure reporting
        (karpenter:pkg/providers/instance/instance.go:369-375,522-536)."""
        with self._lock:
            self._count("create_fleet")
            self._maybe_raise()
            errors: List[FleetError] = []
            usable: List[FleetOverride] = []
            seen_ice: Set[Tuple[str, str, str]] = set()
            for ov in sorted(overrides, key=lambda o: (o.price, o.instance_type, o.zone)):
                pool = (ov.capacity_type, ov.instance_type, ov.zone)
                if pool in self.insufficient_capacity_pools:
                    if pool not in seen_ice:
                        errors.append(FleetError(ov, ICE_CODE))
                        seen_ice.add(pool)
                    continue
                usable.append(ov)
            instances = []
            if usable:
                ov = usable[0]
                for _ in range(count):
                    iid = f"i-{next(self._ids):017x}"
                    inst = CloudInstance(
                        id=iid, instance_type=ov.instance_type, zone=ov.zone,
                        capacity_type=ov.capacity_type, price=ov.price,
                        tags=dict(tags or {}), launched_at=self.clock(),
                        subnet_id=ov.subnet_id, image_id=ov.image_id,
                        launch_template=ov.launch_template)
                    self._instances[iid] = inst
                    instances.append(inst)
            return FleetResult(instances=instances, errors=errors)

    def describe_instances(self, ids: Optional[Sequence[str]] = None,
                           tag_filter: Optional[Dict[str, str]] = None,
                           include_terminated: bool = False) -> List[CloudInstance]:
        with self._lock:
            self._count("describe_instances")
            self._maybe_raise()
            out = []
            for inst in self._instances.values():
                if ids is not None and inst.id not in ids:
                    continue
                if not include_terminated and inst.state != "running":
                    continue
                if tag_filter and any(inst.tags.get(k) != v for k, v in tag_filter.items()):
                    continue
                out.append(inst)
            return out

    def get_instance(self, iid: str) -> CloudInstance:
        with self._lock:
            self._count("get_instance")
            inst = self._instances.get(iid)
            if inst is None or inst.state != "running":
                raise CloudError("InstanceNotFound", iid)
            return inst

    def terminate_instances(self, ids: Sequence[str]) -> List[str]:
        with self._lock:
            self._count("terminate_instances")
            self._maybe_raise()
            done = []
            for iid in ids:
                inst = self._instances.get(iid)
                if inst is not None and inst.state == "running":
                    inst.state = "terminated"
                    done.append(iid)
            return done

    def create_tags(self, iid: str, tags: Dict[str, str]) -> None:
        with self._lock:
            self._count("create_tags")
            self._maybe_raise()
            inst = self._instances.get(iid)
            if inst is None:
                raise CloudError("InstanceNotFound", iid)
            inst.tags.update(tags)

    def running(self) -> List[CloudInstance]:
        return self.describe_instances()
