"""L1 throughput substrate: the windowed request batcher.

A copy of the JAX package's `cloud/batcher.py`, which re-expresses
Karpenter's generic batcher (karpenter:pkg/batcher/batcher.go:52-197):
callers `add()` requests which are hashed into buckets; a bucket's window
closes when the stream goes idle for `idle_timeout`, when `max_timeout`
elapses since the first request, or when `max_items` accumulate; then one
`batch_executor` call fans results back to every caller.

Three concrete batchers mirror the reference's instances:
  * CreateFleetBatcher     — 35ms idle / 1s max / ≤1000; merges N
    single-capacity requests into one fleet call and splits the launched
    instance ids back one per caller (karpenter:pkg/batcher/
    createfleet.go:33-90).
  * DescribeInstancesBatcher — 100ms idle / 1s max / ≤500; unions id sets,
    fans each caller its own instances (describeinstances.go:39-41).
  * TerminateInstancesBatcher — same window; unions ids
    (terminateinstances.go:38-40).

A thread per bucket with condition variables; `add()` blocks the calling
thread until its result is fanned back, which matches how the synchronous
controllers consume it.  Left out: the reference's `batcher.flush` span and
its batch-size / window histograms (ROADMAP.md queue B); `BatchStats` keeps
the recent windows on the object.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Generic, Hashable, List, Optional, Sequence, Tuple, TypeVar

from ..analysis.lockorder import named_lock

Req = TypeVar("Req")
Res = TypeVar("Res")

# Window constants (reference createfleet.go:36-39, describeinstances.go:39-41).
CREATE_FLEET_IDLE = 0.035
CREATE_FLEET_MAX = 1.0
CREATE_FLEET_MAX_ITEMS = 1000
DESCRIBE_IDLE = 0.100
DESCRIBE_MAX = 1.0
DESCRIBE_MAX_ITEMS = 500
TERMINATE_IDLE = 0.100
TERMINATE_MAX = 1.0
TERMINATE_MAX_ITEMS = 500


@dataclass
class BatchStats:
    """Per-batcher observability (batch_size / window_duration histograms,
    karpenter:pkg/batcher/metrics.go:40-47).  Bounded: only the most
    recent windows are retained (full distributions live in the metrics
    histograms)."""
    batches: int = 0
    requests: int = 0
    sizes: "deque" = field(default_factory=lambda: deque(maxlen=1024))
    window_durations: "deque" = field(default_factory=lambda: deque(maxlen=1024))


@dataclass
class Options:
    """Batching window policy (batcher.go Options)."""
    name: str
    idle_timeout: float
    max_timeout: float
    max_items: int
    request_hasher: Callable[[Any], Hashable]
    batch_executor: Callable[[Sequence[Any]], Sequence[Any]]


class _Bucket:
    """One in-flight window of same-hash requests."""

    def __init__(self):
        self.requests: List[Any] = []
        self.results: Optional[List[Any]] = None
        self.error: Optional[BaseException] = None
        self.opened: float = 0.0
        self.last_add: float = 0.0
        self.closed = False
        self.closed_event = threading.Event()  # wakes the flusher on early close
        self.done = threading.Condition()


class Batcher(Generic[Req, Res]):
    """Generic windowed batcher (batcher.go:52-197)."""

    def __init__(self, options: Options, clock: Callable[[], float] = time.monotonic):
        self.options = options
        self.clock = clock
        self._lock = named_lock("batcher")
        self.stats = BatchStats()               # guarded-by: _lock
        self._open: Dict[Hashable, _Bucket] = {}  # guarded-by: _lock

    def add(self, request: Req) -> Res:
        """Join the open window for this request's hash (opening one and its
        flusher thread if needed) and block until the executor fans the
        result back (batcher.go Add:99 + waitForIdle:161)."""
        key = self.options.request_hasher(request)
        with self._lock:
            bucket = self._open.get(key)
            if bucket is None or bucket.closed:
                bucket = _Bucket()
                bucket.opened = self.clock()
                self._open[key] = bucket
                threading.Thread(target=self._flusher, args=(key, bucket),
                                 daemon=True).start()
            idx = len(bucket.requests)
            bucket.requests.append(request)
            bucket.last_add = self.clock()
            if len(bucket.requests) >= self.options.max_items:
                self._close(key, bucket)
        with bucket.done:
            while bucket.results is None and bucket.error is None:
                bucket.done.wait()
        if bucket.error is not None:
            raise bucket.error
        return bucket.results[idx]

    def _close(self, key: Hashable, bucket: _Bucket) -> None:  # graftlint: holds(_lock)
        if not bucket.closed:
            bucket.closed = True
            bucket.closed_event.set()
            if self._open.get(key) is bucket:
                del self._open[key]

    def _flusher(self, key: Hashable, bucket: _Bucket) -> None:
        """Window clock: wake at the earlier of idle/max deadline, then run
        the batch (batcher.go waitForIdle:161-182 + runCalls:184).

        The computed wait is in CLOCK seconds, which for an injected
        fake/test clock bears no relation to real time — so the sleep is
        capped at a 50ms real-time slice and the deadline re-checked against
        the clock on every wake.  Real-clock windows here are 35ms-1s, so
        the cap costs at most ~20 wakeups/s per open bucket (buckets live
        one window) while bounding any injected clock's deadline latency to
        one slice; no clock-kind heuristic that a fake clock's step pattern
        could defeat.  Early close on max_items is signaled via
        closed_event."""
        while True:
            with self._lock:
                if bucket.closed:
                    break
                now = self.clock()
                idle_deadline = bucket.last_add + self.options.idle_timeout
                max_deadline = bucket.opened + self.options.max_timeout
                deadline = min(idle_deadline, max_deadline)
                if now >= deadline:
                    self._close(key, bucket)
                    break
                wait = deadline - now
            bucket.closed_event.wait(timeout=min(wait, 0.05))
        self._run(bucket)

    def _run(self, bucket: _Bucket) -> None:
        from ..utils import tracing
        with tracing.span("batcher.flush", batcher=self.options.name,
                          size=len(bucket.requests)) as sp:
            try:
                results = list(self.options.batch_executor(list(bucket.requests)))
                if len(results) != len(bucket.requests):
                    raise RuntimeError(
                        f"batcher {self.options.name}: executor returned "
                        f"{len(results)} results for {len(bucket.requests)} requests")
                error = None
            except BaseException as e:  # fan the failure back to every caller
                results, error = None, e
            window = self.clock() - bucket.opened
            sp.annotate(window_s=round(window, 4), error=bool(error))
        # shared stats guarded by the batcher lock, not the per-bucket one —
        # concurrent buckets flush in parallel
        with self._lock:
            self.stats.batches += 1
            self.stats.requests += len(bucket.requests)
            self.stats.sizes.append(len(bucket.requests))
            self.stats.window_durations.append(window)
        with bucket.done:
            bucket.results = results
            bucket.error = error
            bucket.done.notify_all()
        from ..utils import metrics
        labels = {"batcher": self.options.name}
        metrics.batch_size().observe(len(bucket.requests), labels)
        metrics.batch_window_duration().observe(window, labels)


# ---------------------------------------------------------------------------
# Concrete batchers over the cloud substrate
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FleetRequest:
    """One caller's single-capacity fleet ask; hashed on its launch shape so
    identical asks merge (createfleet.go FleetRequestHasher)."""
    overrides: Tuple  # Tuple[FleetOverride, ...]
    tags: Tuple[Tuple[str, str], ...]

    def shape(self) -> Hashable:
        # every field that affects what gets launched must hash (the
        # reference hashes the full fleet input, batcher DefaultHasher)
        return (tuple((ov.instance_type, ov.zone, ov.capacity_type, ov.price,
                       ov.subnet_id, ov.launch_template, ov.image_id)
                      for ov in self.overrides), self.tags)


class CreateFleetBatcher:
    """Merges same-shape single-instance fleet requests into one
    `create_fleet(count=N)` and deals the launched instances back one per
    caller; callers beyond the fulfilled count get the fleet errors
    (createfleet.go:52-90)."""

    def __init__(self, cloud, clock: Callable[[], float] = time.monotonic,
                 idle: float = CREATE_FLEET_IDLE, max_timeout: float = CREATE_FLEET_MAX,
                 max_items: int = CREATE_FLEET_MAX_ITEMS):
        self.cloud = cloud
        self.batcher: Batcher = Batcher(Options(
            name="create_fleet", idle_timeout=idle, max_timeout=max_timeout,
            max_items=max_items, request_hasher=lambda r: r.shape(),
            batch_executor=self._execute), clock=clock)

    def create_fleet(self, overrides, tags: Dict[str, str]):
        req = FleetRequest(tuple(overrides), tuple(sorted(tags.items())))
        return self.batcher.add(req)

    def _execute(self, requests: Sequence[FleetRequest]):
        from .fake import FleetResult
        req = requests[0]
        result = self.cloud.create_fleet(
            list(req.overrides), count=len(requests), tags=dict(req.tags))
        out = []
        for i in range(len(requests)):
            if i < len(result.instances):
                out.append(FleetResult(instances=[result.instances[i]],
                                       errors=list(result.errors)))
            else:
                out.append(FleetResult(instances=[], errors=list(result.errors)))
        return out


class DescribeInstancesBatcher:
    """Unions many id-filtered describes into one call; each caller gets only
    its own instances back (describeinstances.go:39-41)."""

    def __init__(self, cloud, clock: Callable[[], float] = time.monotonic,
                 idle: float = DESCRIBE_IDLE, max_timeout: float = DESCRIBE_MAX,
                 max_items: int = DESCRIBE_MAX_ITEMS):
        self.cloud = cloud
        self.batcher: Batcher = Batcher(Options(
            name="describe_instances", idle_timeout=idle,
            max_timeout=max_timeout, max_items=max_items,
            request_hasher=lambda r: "describe",
            batch_executor=self._execute), clock=clock)

    def describe_instances(self, ids: Sequence[str]):
        return self.batcher.add(tuple(ids))

    def _execute(self, requests: Sequence[Tuple[str, ...]]):
        all_ids = sorted({i for req in requests for i in req})
        found = {inst.id: inst for inst in self.cloud.describe_instances(ids=all_ids)}
        return [[found[i] for i in req if i in found] for req in requests]


class TerminateInstancesBatcher:
    """Unions termination ids into one call (terminateinstances.go:38-40)."""

    def __init__(self, cloud, clock: Callable[[], float] = time.monotonic,
                 idle: float = TERMINATE_IDLE, max_timeout: float = TERMINATE_MAX,
                 max_items: int = TERMINATE_MAX_ITEMS):
        self.cloud = cloud
        self.batcher: Batcher = Batcher(Options(
            name="terminate_instances", idle_timeout=idle,
            max_timeout=max_timeout, max_items=max_items,
            request_hasher=lambda r: "terminate",
            batch_executor=self._execute), clock=clock)

    def terminate_instances(self, ids: Sequence[str]) -> List[str]:
        return self.batcher.add(tuple(ids))

    def _execute(self, requests: Sequence[Tuple[str, ...]]):
        all_ids = sorted({i for req in requests for i in req})
        done = set(self.cloud.terminate_instances(all_ids))
        return [[i for i in req if i in done] for req in requests]


class BatchedCloud:
    """Facade wrapping a cloud substrate with the three batchers — the
    `batcher.EC2(ctx, api)` analog (karpenter:pkg/batcher/ec2api.go:23-29).
    Non-batched calls pass through."""

    def __init__(self, cloud, **kw):
        self._cloud = cloud
        self.fleet = CreateFleetBatcher(cloud, **kw)
        self.describe = DescribeInstancesBatcher(cloud, **kw)
        self.terminate = TerminateInstancesBatcher(cloud, **kw)

    def create_fleet(self, overrides, count: int = 1, tags: Optional[Dict[str, str]] = None):
        if count != 1:  # only single-capacity requests merge (createfleet.go:44)
            return self._cloud.create_fleet(overrides, count=count, tags=tags or {})
        return self.fleet.create_fleet(overrides, tags or {})

    def describe_instances(self, ids=None, tag_filter=None):
        if ids is None or tag_filter is not None:
            return self._cloud.describe_instances(ids=ids, tag_filter=tag_filter)
        return self.describe.describe_instances(ids)

    def terminate_instances(self, ids: Sequence[str]) -> List[str]:
        return self.terminate.terminate_instances(ids)

    def __getattr__(self, name):
        return getattr(self._cloud, name)
