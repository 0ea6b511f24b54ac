"""Per-pod-class demand series: the forecaster's observation stream.

A copy of the JAX package's `forecast/series.py`.

A `DemandSeries` is the `Cluster.observer` hook target: every pod
admission, deletion, and first bind lands here (headroom placeholders are
excluded — the forecaster must never learn from its own output).  The
series tracks live concurrency per pod class and, on each bucket boundary
of the injectable clock, appends the current concurrency to a bounded ring
— so `values(cls)` is a fixed-cadence concurrency time series the models
in `model.py` consume directly.

Pod classes come from the workload's own identity label when present (the
simulator stamps ``sim.karpenter.sh/wave``; a live deployment can reuse
it) and otherwise from a power-of-two resource-shape bucket, so arbitrary
request mixes collapse into a bounded class set.
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from ..utils import metrics
from .headroom import is_headroom

# the simulator's wave identity label doubles as the class key; any live
# workload labelled the same way gets per-stream forecasts for free
WAVE_LABEL = "sim.karpenter.sh/wave"

# classes beyond the cap fold into one bucket so memory stays bounded no
# matter how many distinct shapes arrive
OVERFLOW_CLASS = "other"

# default ring: 24h of 60s buckets
DEFAULT_BUCKET_S = 60.0
DEFAULT_CAPACITY = 1440


def pod_class(pod) -> str:
    """Stable demand-class key for a pod: its wave label when present,
    else a log2 resource-shape bucket (cpu millicores × memory MiB)."""
    wave = pod.labels.get(WAVE_LABEL, "")
    if wave:
        return wave
    cpu = max(1.0, float(pod.requests.get("cpu", 0)))
    mem = max(1.0, float(pod.requests.get("memory", 0)) / 2 ** 20)
    return f"c{int(math.log2(cpu))}m{int(math.log2(mem))}"


class DemandSeries:
    """Bounded ring of per-class concurrency samples on the injectable
    clock.  All mutation happens through the observer interface
    (`pod_added`/`pod_removed`/`pod_bound`), called by `Cluster` under the
    operator's state lock — no locking of its own."""

    def __init__(self, bucket_s: float = DEFAULT_BUCKET_S,
                 capacity: int = DEFAULT_CAPACITY,
                 clock: Callable[[], float] = time.time,
                 max_classes: int = 64):
        self.bucket_s = float(bucket_s)
        self.capacity = int(capacity)
        self.clock = clock
        self.max_classes = int(max_classes)
        self._live: Dict[str, int] = {}          # class → live concurrency
        self._ring: Dict[str, Deque[float]] = {}  # class → closed buckets
        self._req: Dict[str, List[float]] = {}   # class → [cpu_sum, mem_sum, n]
        self._bind_latency: Deque[float] = deque(maxlen=256)
        self._bucket_end: Optional[float] = None

    # ------------------------------------------------------------------
    # bucket bookkeeping
    # ------------------------------------------------------------------
    def advance(self, now: Optional[float] = None) -> None:
        """Roll the ring forward to `now`: every elapsed bucket boundary
        closes with the concurrency that was live at its end.  Catch-up is
        bounded by the ring capacity — older buckets would roll off anyway."""
        now = self.clock() if now is None else now
        if self._bucket_end is None:
            self._bucket_end = \
                (math.floor(now / self.bucket_s) + 1) * self.bucket_s
            return
        steps = 0
        while now >= self._bucket_end and steps < self.capacity:
            for cls, ring in self._ring.items():
                ring.append(float(self._live.get(cls, 0)))
            self._bucket_end += self.bucket_s
            steps += 1
        if now >= self._bucket_end:
            self._bucket_end = \
                (math.floor(now / self.bucket_s) + 1) * self.bucket_s

    def _class_for(self, pod) -> str:
        cls = pod_class(pod)
        if cls not in self._ring and len(self._ring) >= self.max_classes:
            return OVERFLOW_CLASS
        return cls

    def _ensure(self, cls: str) -> None:
        if cls not in self._ring:
            self._ring[cls] = deque(maxlen=self.capacity)
            self._live.setdefault(cls, 0)

    # ------------------------------------------------------------------
    # observer interface (Cluster.observer)
    # ------------------------------------------------------------------
    def pod_added(self, pod) -> None:
        if is_headroom(pod):
            return
        self.advance()
        cls = self._class_for(pod)
        self._ensure(cls)
        self._live[cls] = self._live.get(cls, 0) + 1
        req = self._req.setdefault(cls, [0.0, 0.0, 0.0])
        req[0] += float(pod.requests.get("cpu", 0))
        req[1] += float(pod.requests.get("memory", 0))
        req[2] += 1.0
        metrics.forecast_series_observations().inc({"kind": "arrival"})

    def pod_removed(self, pod) -> None:
        if is_headroom(pod):
            return
        self.advance()
        cls = self._class_for(pod)
        if cls in self._live:
            self._live[cls] = max(0, self._live[cls] - 1)
        metrics.forecast_series_observations().inc({"kind": "departure"})

    def pod_bound(self, pod) -> None:
        if is_headroom(pod):
            return
        self._bind_latency.append(
            max(0.0, self.clock() - pod.created_at))
        metrics.forecast_series_observations().inc({"kind": "bind"})

    # ------------------------------------------------------------------
    # read side (HeadroomController / models)
    # ------------------------------------------------------------------
    def classes(self) -> List[str]:
        return sorted(self._ring)

    def live(self, cls: str) -> int:
        return self._live.get(cls, 0)

    def values(self, cls: str) -> np.ndarray:
        """Closed buckets plus the in-flight bucket's live count as the
        freshest sample, as float64 — the models' input."""
        ring = self._ring.get(cls)
        vals = list(ring) if ring else []
        vals.append(float(self._live.get(cls, 0)))
        return np.asarray(vals, dtype=np.float64)

    def mean_request(self, cls: str) -> Tuple[float, float]:
        """Running mean (cpu millicores, memory bytes) of the class's
        observed requests — the placeholder sizing signal."""
        req = self._req.get(cls)
        if not req or req[2] <= 0:
            return (0.0, 0.0)
        return (req[0] / req[2], req[1] / req[2])

    def recent_bind_latency(self) -> float:
        """Mean of the recent first-bind latencies — how long reactive
        provisioning is currently taking, a diagnostic for lead tuning."""
        if not self._bind_latency:
            return 0.0
        return sum(self._bind_latency) / len(self._bind_latency)

    # ------------------------------------------------------------------
    # warm restart (state/snapshot.py)
    # ------------------------------------------------------------------
    def snapshot_state(self) -> Dict:
        """Plain-data export of the whole observation state — rings as
        lists (deque maxlen re-applies on restore)."""
        return {
            "live": dict(self._live),
            "ring": {cls: list(ring) for cls, ring in self._ring.items()},
            "req": {cls: list(v) for cls, v in self._req.items()},
            "bind_latency": list(self._bind_latency),
            "bucket_end": self._bucket_end,
        }

    def restore_state(self, data: Dict) -> None:
        self._live = dict(data["live"])
        self._ring = {cls: deque(vals, maxlen=self.capacity)
                      for cls, vals in data["ring"].items()}
        self._req = {cls: list(v) for cls, v in data["req"].items()}
        self._bind_latency = deque(data["bind_latency"], maxlen=256)
        self._bucket_end = data["bucket_end"]
