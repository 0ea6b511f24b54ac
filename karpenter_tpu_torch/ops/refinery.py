"""Asynchronous LP-guide refinery: column generation off the tick.

The port of the JAX package's `ops/refinery.py`.  `solve_guided` hands a
mix-cache miss here as a (key, job) pair and answers the tick immediately —
with the freshest stale mix whose catalog fingerprint still matches
(bounded staleness window) or, failing that, the greedy plan.  A worker
thread runs the job (ops/lpguide._refine_job: mask → dedup → warm-started
colgen → rounding), lands the refined mix in the content-keyed cache so the
next solve of the same signature is a warm hit, and prices the greedy
alternative; when the refined mix beats it by more than
`upgrade_threshold`, a one-shot upgrade hint is raised.

Every failure mode — worker crash, queue overflow, job exception — leaves
the provisioning path where it would be with no refinery at all: greedy
solves that still bind every pod.  Exceptions are logged and swallowed,
and counted in karpenter_refinery_errors_total.  A job runs under a
`refinery.refine` span parented to the submitting solve's span.  The
reference's lock-order recorder is left out.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Optional

from ..analysis.lockorder import named_lock
from ..utils import metrics, tracing

log = logging.getLogger("karpenter_tpu_torch.refinery")


class GuideRefinery:
    """Bounded, deduplicating background refinement queue.

    `clock` feeds the staleness window; `monotonic` feeds the drain
    deadline — both injectable.  `start=False` leaves the worker unstarted
    (jobs accumulate until `start()`), which tests use to observe the
    cold/stale tick behavior deterministically.
    """

    def __init__(self, max_queue: int = 64, stale_ttl: float = 300.0,
                 upgrade_threshold: float = 0.03,
                 clock: Callable[[], float] = time.monotonic,
                 monotonic: Callable[[], float] = time.monotonic,
                 start: bool = True, device_lp: bool = False,
                 lp_health=None):
        self.stale_ttl = stale_ttl
        self.upgrade_threshold = upgrade_threshold
        self.clock = clock
        self.monotonic = monotonic
        # DeviceLP wiring: with device_lp on and the lp_health ladder
        # healthy, solve_guided refines a miss synchronously on the PDHG
        # kernel instead of enqueueing here
        self.device_lp = bool(device_lp)
        self.lp_health = lp_health
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._lock = named_lock("refinery.inflight")
        self._inflight: set = set()     # guarded-by: _lock
        self._stop = threading.Event()
        self._upgrade = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._work, daemon=True,
                                        name="lpguide-refinery")
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def submit(self, key, job: Callable[[], Optional[dict]]) -> bool:
        """Enqueue one refine job, deduplicated on the exact problem
        signature.  A full queue drops the job — the caller already has
        its greedy/stale answer, so dropping only delays refinement."""
        with self._lock:
            if key in self._inflight:
                return False
            self._inflight.add(key)
        ctx = tracing.TRACER.capture()
        try:
            self._q.put_nowait((key, job, ctx))
        except queue.Full:
            with self._lock:
                self._inflight.discard(key)
            metrics.refinery_errors().inc({"reason": "queue_full"})
            return False
        metrics.refinery_queue_depth().set(len(self._inflight))
        return True

    def _work(self) -> None:
        while not self._stop.is_set():
            try:
                key, job, ctx = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            t0 = time.perf_counter()
            res = None
            try:
                with tracing.TRACER.attach(ctx), \
                        tracing.span("refinery.refine") as sp:
                    res = job()
                    if res:
                        sp.annotate(z_lp=res.get("z_lp"),
                                    greedy_total=res.get("greedy_total"))
            except Exception:
                metrics.refinery_errors().inc({"reason": "exception"})
                log.exception("refine job failed; tick stays on greedy")
            finally:
                # the upgrade is raised before the job leaves the in-flight
                # set, so a drain() that saw the set empty sees it too
                if res and res.get("greedy_total", 0.0) > 0:
                    saving = 1.0 - res["z_lp"] / res["greedy_total"]
                    if saving > self.upgrade_threshold:
                        metrics.refinery_cost_delta().inc(
                            by=res["greedy_total"] - res["z_lp"])
                        self._upgrade.set()
                with self._lock:
                    self._inflight.discard(key)
                metrics.refinery_queue_depth().set(len(self._inflight))
                metrics.refinery_refine_duration().observe(
                    time.perf_counter() - t0)
                self._q.task_done()

    def take_upgrade(self) -> bool:
        """One-shot: True exactly once per refined-mix-beats-greedy
        event."""
        if self._upgrade.is_set():
            self._upgrade.clear()
            return True
        return False

    def pending(self) -> int:
        with self._lock:
            return len(self._inflight)

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every submitted job finished; True if the queue
        drained within the timeout.  The deadline runs on the injected
        `monotonic` clock; the 5 ms poll is a thread yield to the worker."""
        deadline = self.monotonic() + timeout
        while self.monotonic() < deadline:
            if self.pending() == 0:
                return True
            time.sleep(0.005)
        return self.pending() == 0
