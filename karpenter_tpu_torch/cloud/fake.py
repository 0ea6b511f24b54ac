"""In-memory fake cloud.

A copy of the JAX package's `cloud/fake.py` (the analog of Karpenter's
test backend, pkg/fake/ec2api.go:40-120: a thread-safe instance store, a
stateful CreateFleet that launches in-memory instances, and an
`insufficient_capacity_pools` knob injecting ICE per (type, zone,
capacityType)), with the interruption queue's publishing side (a spot
interruption's warning and its clock-scheduled reclaim), the network and
image inventories the providers discover (subnets, security groups,
images, spot price history), the launch-template API, and the chaos
injector's `cloud.api` seam (utils/chaos.py, keyed on the API name), and
the warm-restart export (`snapshot_state` / `restore_state`, read by
state/snapshot.py) that lets a resumed run replay the same launch and
reclaim stream."""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..analysis.lockorder import named_lock
from ..utils.chaos import CHAOS

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


@dataclass
class SubnetInfo:
    """A network placement target — subnet analog with free-IP accounting
    (karpenter:pkg/providers/subnet/subnet.go:59,110-147)."""
    id: str
    zone: str
    available_ip_count: int
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class SecurityGroupInfo:
    """A firewall group discoverable by id/name/tags
    (karpenter:pkg/providers/securitygroup/securitygroup.go:54-76)."""
    id: str
    name: str
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class ImageInfo:
    """A bootable node image — AMI analog
    (karpenter:pkg/providers/amifamily/ami.go:116-136)."""
    id: str
    name: str
    architecture: str = "amd64"
    creation_ts: float = 0.0
    deprecated: bool = False
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class LaunchTemplateInfo:
    """A stored launch template
    (karpenter:pkg/providers/launchtemplate/launchtemplate.go:233)."""
    name: str
    image_id: str
    user_data: str = ""
    security_group_ids: Tuple[str, ...] = ()
    block_device_gib: int = 20
    block_device_mappings: Tuple[str, ...] = ()   # canonical JSON strings
    metadata_options: Tuple = ()                  # sorted (key, value) pairs
    detailed_monitoring: bool = False
    instance_store_policy: str = ""
    associate_public_ip: object = None            # None == subnet default
    instance_profile: str = ""
    tags: Dict[str, str] = field(default_factory=dict)


class FakeCloud:
    """The cloud API the provider talks to.  Thread-safe; failure injection
    via `insufficient_capacity_pools`, `next_error` (the next call of any
    API), `throttle_until` and the chaos injector's `cloud.api` rules."""

    def __init__(self, clock: Callable[[], float] = time.time,
                 queue=None):
        self.clock = clock
        self._lock = named_lock("cloud", threading.RLock)
        self._instances: Dict[str, CloudInstance] = {}  # guarded-by: _lock
        self._ids = itertools.count(1)
        # (capacity_type, instance_type, zone) pools that ICE
        self.insufficient_capacity_pools: Set[Tuple[str, str, str]] = set()
        self.next_error: Optional[Exception] = None
        self.calls: Dict[str, int] = {}
        self.queue = queue  # interruption events go here when attached
        # network inventory (seeded by tests / the operator's callers)
        self.subnets: List[SubnetInfo] = []
        self.security_groups: List[SecurityGroupInfo] = []
        self.images: List[ImageInfo] = []
        self.launch_templates: Dict[str, LaunchTemplateInfo] = {}
        # (instance_type, zone) → spot price history, newest wins
        self.spot_prices: Dict[Tuple[str, str], float] = {}
        # clock-scheduled deliveries: an (at, seq, action, instance_id)
        # heap drained by deliver_due() — the virtual-time interruption
        # pipeline (the warning at T-120, the reclaim at T)
        self._scheduled: List[Tuple[float, int, str, str]] = []  # guarded-by: _lock
        self._sched_seq = itertools.count(1)
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
            self._scheduled.clear()
            self.throttle_until = 0.0

    def _count(self, api: str):
        self.calls[api] = self.calls.get(api, 0) + 1

    def _maybe_raise(self, api: str = ""):
        if self.next_error is not None:
            err, self.next_error = self.next_error, None
            raise err
        if self.clock() < self.throttle_until:
            raise CloudError("RequestLimitExceeded", "throttle window open")
        # chaos seam: rules targeting point "cloud.api" key on the API name
        # (utils/chaos.py); a no-op unless the injector is armed
        CHAOS.inject("cloud.api", key=api)

    # ---- APIs ----
    def create_fleet(self, overrides: Sequence[FleetOverride], count: int = 1,
                     tags: Optional[Dict[str, str]] = None) -> FleetResult:
        """Launch `count` instances from the cheapest non-ICE'd override —
        CreateFleet(instant) semantics incl. partial-failure reporting
        (karpenter:pkg/providers/instance/instance.go:369-375,522-536)."""
        with self._lock:
            self._count("create_fleet")
            self._maybe_raise("create_fleet")
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
            self._maybe_raise("describe_instances")
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
            self._maybe_raise("terminate_instances")
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
            self._maybe_raise("create_tags")
            inst = self._instances.get(iid)
            if inst is None:
                raise CloudError("InstanceNotFound", iid)
            inst.tags.update(tags)

    def describe_subnets(self) -> List[SubnetInfo]:
        with self._lock:
            self._count("describe_subnets")
            self._maybe_raise("describe_subnets")
            return list(self.subnets)

    def describe_security_groups(self) -> List[SecurityGroupInfo]:
        with self._lock:
            self._count("describe_security_groups")
            self._maybe_raise("describe_security_groups")
            return list(self.security_groups)

    def describe_images(self, ids: Optional[Sequence[str]] = None
                        ) -> List[ImageInfo]:
        with self._lock:
            self._count("describe_images")
            self._maybe_raise("describe_images")
            if ids is None:
                return list(self.images)
            want = set(ids)
            return [i for i in self.images if i.id in want]

    def create_launch_template(self, lt: LaunchTemplateInfo
                               ) -> LaunchTemplateInfo:
        with self._lock:
            self._count("create_launch_template")
            self._maybe_raise("create_launch_template")
            if lt.name in self.launch_templates:
                raise CloudError(
                    "InvalidLaunchTemplateName.AlreadyExistsException",
                    lt.name)
            self.launch_templates[lt.name] = lt
            return lt

    def describe_launch_templates(self, tag_filter: Optional[Dict[str, str]]
                                  = None) -> List[LaunchTemplateInfo]:
        with self._lock:
            self._count("describe_launch_templates")
            self._maybe_raise("describe_launch_templates")
            out = []
            for lt in self.launch_templates.values():
                if tag_filter and any(lt.tags.get(k) != v
                                      for k, v in tag_filter.items()):
                    continue
                out.append(lt)
            return out

    def delete_launch_template(self, name: str) -> None:
        with self._lock:
            self._count("delete_launch_template")
            self._maybe_raise("delete_launch_template")
            if name not in self.launch_templates:
                raise CloudError("InvalidLaunchTemplateId.NotFound", name)
            del self.launch_templates[name]

    def describe_spot_price_history(self) -> Dict[Tuple[str, str], float]:
        """(type, zone) → latest spot price
        (karpenter:pkg/providers/pricing/pricing.go:308+)."""
        with self._lock:
            self._count("describe_spot_price_history")
            self._maybe_raise("describe_spot_price_history")
            return dict(self.spot_prices)

    # ---- interruptions ----
    def _publish(self, kind: str, ids, state: str = ""):
        if self.queue is not None:
            from .queue import make_event_body
            self.queue.send(make_event_body(kind, ids, state=state,
                                            ts=self.clock()))

    def interrupt(self, iid: str, at: Optional[float] = None,
                  warning_s: float = 120.0) -> CloudInstance:
        """Spot-interrupt an instance.

        With ``at`` given the whole pipeline is clock-scheduled: the
        two-minute warning publishes at ``at - warning_s`` (clamped to now)
        and the capacity is pulled at ``at``, both fired by `deliver_due()`
        once the clock reaches them.  Without ``at`` and with a queue
        attached, the warning publishes now and the reclaim is scheduled
        ``warning_s`` out (`deliver_due()` fires it; a caller that never
        drains may still `reclaim()` by hand).  Without a queue nobody can
        be warned, so the capacity is reclaimed at once."""
        with self._lock:
            inst = self._instances.get(iid)
            if inst is None:
                raise CloudError("InstanceNotFound", iid)
            if self.queue is None:
                inst.state = "terminated"
                return inst
            if at is not None:
                now = self.clock()
                heapq.heappush(self._scheduled,
                               (max(now, at - warning_s),
                                next(self._sched_seq), "warn", iid))
                heapq.heappush(self._scheduled,
                               (at, next(self._sched_seq), "reclaim", iid))
                return inst
            heapq.heappush(self._scheduled,
                           (self.clock() + warning_s,
                            next(self._sched_seq), "reclaim", iid))
        from .queue import SPOT_INTERRUPTION
        self._publish(SPOT_INTERRUPTION, [iid])
        return inst

    def next_due(self) -> Optional[float]:
        """The earliest clock-scheduled delivery, or None."""
        with self._lock:
            return self._scheduled[0][0] if self._scheduled else None

    def deliver_due(self) -> List[Dict]:
        """Fire every scheduled delivery whose time has come.  One record
        per firing: ``spot_warning`` publishes the warning for a running
        instance; ``spot_reclaim`` pulls the capacity — ``honored=True``
        when the controllers drained the node first (the instance was
        already gone), ``False`` when the reclaim had to kill it."""
        from .queue import SPOT_INTERRUPTION, STATE_CHANGE
        fired: List[Dict] = []
        publish: List[Tuple[str, str, str]] = []
        with self._lock:
            now = self.clock()
            while self._scheduled and self._scheduled[0][0] <= now:
                at, _, action, iid = heapq.heappop(self._scheduled)
                inst = self._instances.get(iid)
                running = inst is not None and inst.state == "running"
                if action == "warn":
                    if running:
                        publish.append((SPOT_INTERRUPTION, iid, ""))
                        fired.append({"at": at, "action": "spot_warning",
                                      "instance": iid})
                    continue
                if running:
                    inst.state = "terminated"
                    publish.append((STATE_CHANGE, iid, "terminated"))
                fired.append({"at": at, "action": "spot_reclaim",
                              "instance": iid, "honored": not running})
        for kind, iid, state in publish:
            self._publish(kind, [iid], state=state)
        return fired

    def reclaim(self, iid: str) -> None:
        """The interruption deadline passed: the capacity is pulled and a
        state-change event fires."""
        with self._lock:
            inst = self._instances.get(iid)
            if inst is not None:
                inst.state = "terminated"
        from .queue import STATE_CHANGE
        self._publish(STATE_CHANGE, [iid], state="terminated")

    def running(self) -> List[CloudInstance]:
        return self.describe_instances()

    # ---- warm restart (state/snapshot.py) ----
    def snapshot_state(self) -> Dict:
        """Round-trippable export of the whole fake-cloud world: a resumed
        run replays the same launches after restore, so the instance and
        sequence counters transfer by probe-and-reset (read the next
        value, recreate the counter at it: net zero draws)."""
        with self._lock:
            next_id = next(self._ids)
            self._ids = itertools.count(next_id)
            next_seq = next(self._sched_seq)
            self._sched_seq = itertools.count(next_seq)
            return {
                "instances": dict(self._instances),
                "ice_pools": set(self.insufficient_capacity_pools),
                "calls": dict(self.calls),
                "subnets": list(self.subnets),
                "security_groups": list(self.security_groups),
                "images": list(self.images),
                "launch_templates": dict(self.launch_templates),
                "spot_prices": dict(self.spot_prices),
                "scheduled": list(self._scheduled),
                "throttle_until": self.throttle_until,
                "next_id": next_id,
                "next_sched_seq": next_seq,
            }

    def restore_state(self, data: Dict) -> None:
        with self._lock:
            self._instances = dict(data["instances"])
            self.insufficient_capacity_pools = set(data["ice_pools"])
            self.calls = dict(data["calls"])
            self.subnets = list(data["subnets"])
            self.security_groups = list(data["security_groups"])
            self.images = list(data["images"])
            self.launch_templates = dict(data["launch_templates"])
            self.spot_prices = dict(data["spot_prices"])
            self._scheduled = list(data["scheduled"])
            heapq.heapify(self._scheduled)
            self.throttle_until = float(data["throttle_until"])
            self._ids = itertools.count(int(data["next_id"]))
            self._sched_seq = itertools.count(int(data["next_sched_seq"]))
