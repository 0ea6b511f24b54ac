"""HeadroomController: forecast envelope → low-priority placeholder claims.

A copy of the JAX package's `forecast/headroom.py`, with its metric and
span calls and its cost-ledger reservations (obs/ledger.py).  The dry-run
solve runs on the Provisioner's device, so placeholders reach the same
kernels real pods do; a fault of the card or a kernel (`DEVICE_FAULTS`) is
raised out of `reconcile()` before anything is admitted, never skipped
like a failed solve.

The proactive half of the forecast subsystem.  Each reconcile:

  1. expires placeholders whose TTL lapsed (their nodes drain back through
     the normal emptiness sweep);
  2. forecasts each demand class over [lead, lead + horizon] and targets
     the upper confidence band;
  3. materializes the shortfall as *placeholder pods* — ownerless,
     negative-priority, TTL-annotated — sized from the class's observed
     request mean, steered to on-demand capacity when the spot-risk prior
     says the pool's reclaim rate is hot;
  4. budget-checks the batch with a dry-run `Provisioner.solve` against a
     node snapshot (the same batched classpack path real pods take, so
     headroom is cost-optimal) and trims deterministically to the cost cap;
  5. admits the survivors as pending pods — the very next provisioning
     tick places them like any other workload.

Placeholders yield instantly: the manager calls `preempt_for_pending()`
right before every provisioning solve, deleting pending placeholders and
evicting bound ones until the freed capacity covers the real pending
demand.  Unexpired placeholders block the disruption sweep
(protected-by-TTL, see controllers/disruption.py) so consolidation never
reaps capacity the forecaster just bought.
"""

from __future__ import annotations

import itertools
import logging
import math
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..api import labels as wk
from ..api.objects import Pod
from ..api.resources import CPU, MEMORY, ResourceList
from ..ops.classpack import DEVICE_FAULTS
from ..utils import metrics, tracing
from ..utils.events import Event

log = logging.getLogger("karpenter_tpu_torch.forecast")

# identity + protection markers on placeholder pods
HEADROOM_LABEL = "karpenter.sh/headroom"
HEADROOM_CLASS_LABEL = "karpenter.sh/headroom-class"
HEADROOM_EXPIRY_ANNOTATION = "karpenter.sh/headroom-expiry"
# below every real workload: anything outranks a placeholder
HEADROOM_PRIORITY = -1000

_SAFE_NAME = re.compile(r"[^a-z0-9-]+")


def is_headroom(pod) -> bool:
    return pod.labels.get(HEADROOM_LABEL, "") == "true"


def headroom_expiry(pod) -> Optional[float]:
    """TTL deadline of a placeholder (virtual-time float), None for real
    pods or malformed annotations."""
    raw = pod.annotations.get(HEADROOM_EXPIRY_ANNOTATION)
    if raw is None:
        return None
    try:
        return float(raw)
    except (TypeError, ValueError):
        return None


@dataclass
class HeadroomConfig:
    """Tuning knobs (docs/forecast.md#tuning); defaults mirror
    operator/options.py so CLI flags and scenario specs agree."""
    horizon_s: float = 900.0        # forecast window length
    lead_s: float = 180.0           # how far ahead the window starts
    ttl_s: float = 600.0            # placeholder lifetime
    bucket_s: float = 60.0          # series bucket (envelope step size)
    confidence: float = 1.64        # z for the upper band (~p95)
    max_cost_frac: float = 0.10     # new-node $/h cap vs current rate
    min_budget_per_h: float = 1.0   # absolute floor so cold clusters warm up
    model: str = "holtwinters"
    season_s: float = 86_400.0      # diurnal by default
    spot_risk_threshold: float = 0.15   # reclaims per spot node-hour
    max_placeholders_per_class: int = 50
    # issuance smoothing: cap placeholders admitted per reconcile so the
    # dry-run solves small batches — small batches pack onto small, cheap,
    # easily-reaped instances instead of tempting the solver into large
    # ones that sit half-empty after the burst passes
    max_issue_per_reconcile: int = 6


@dataclass
class ForecastResult:
    """One reconcile's outcome (the manager's results map entry)."""
    issued: int = 0
    expired: int = 0
    trimmed: int = 0
    targets: Dict[str, float] = field(default_factory=dict)


class SpotRiskPrior:
    """Per-nodepool spot reclaim-rate belief: observed reclaims over
    accrued spot node-hours with a Beta-style prior (a0 reclaims / b0
    hours), so a pool with no history starts at a low rate instead of
    zero or infinity.  Reclaim observations arrive via the interruption
    controller's `on_spot_reclaim` hook; hours accrue each reconcile."""

    def __init__(self, prior_reclaims: float = 1.0,
                 prior_node_hours: float = 20.0):
        self.a0 = float(prior_reclaims)
        self.b0 = float(prior_node_hours)
        self._reclaims: Dict[str, int] = {}
        self._node_hours: Dict[str, float] = {}
        self._last_accrue: Optional[float] = None

    def observe_reclaim(self, src) -> None:
        """Hook target: `src` is the interrupted Node or NodeClaim."""
        pool = getattr(src, "nodepool", "") or "default"
        self._reclaims[pool] = self._reclaims.get(pool, 0) + 1

    def accrue(self, nodes, now: float) -> None:
        if self._last_accrue is None:
            self._last_accrue = now
            return
        dt_h = max(0.0, now - self._last_accrue) / 3600.0
        self._last_accrue = now
        if dt_h <= 0:
            return
        for n in nodes:
            if n.capacity_type == wk.CAPACITY_TYPE_SPOT:
                pool = n.nodepool or "default"
                self._node_hours[pool] = \
                    self._node_hours.get(pool, 0.0) + dt_h

    def rate(self, pool: str) -> float:
        return (self._reclaims.get(pool, 0) + self.a0) / \
            (self._node_hours.get(pool, 0.0) + self.b0)

    def max_rate(self) -> float:
        pools = set(self._reclaims) | set(self._node_hours) | {"default"}
        # commutative max reduction: order-insensitive
        # graftlint: disable=DT003
        return max(self.rate(p) for p in pools)


class HeadroomController:
    """Reconciles forecast demand into placeholder capacity.  Runs on the
    manager's cadence under the shared state lock, like every other
    controller."""

    def __init__(self, provisioner, cluster, nodepools, series, forecaster,
                 clock: Callable[[], float] = time.time,
                 config: Optional[HeadroomConfig] = None,
                 recorder=None):
        from ..utils.events import Recorder
        self.provisioner = provisioner
        self.cluster = cluster
        self.nodepools = nodepools
        self.series = series
        self.forecaster = forecaster
        self.clock = clock
        self.config = config or HeadroomConfig()
        self.recorder = recorder or Recorder(log=False)
        self.spot_prior = SpotRiskPrior()
        # instance-level sequence: fresh per controller, so sim runs that
        # rebuild the stack get deterministic placeholder names
        self._seq = itertools.count(1)
        self.stats = {"issued": 0, "expired": 0, "preempted": 0,
                      "trimmed": 0, "peak_live": 0, "reconciles": 0}

    # ------------------------------------------------------------------
    def headroom_pods(self) -> List[Pod]:
        return sorted((p for p in self.cluster.pods.values()
                       if is_headroom(p)), key=lambda p: p.name)

    # ------------------------------------------------------------------
    def reconcile(self) -> ForecastResult:
        with tracing.span("forecast.reconcile") as sp:
            out = self._reconcile()
            sp.annotate(issued=out.issued, expired=out.expired,
                        trimmed=out.trimmed)
            return out

    def _reconcile(self) -> ForecastResult:
        now = self.clock()
        cfg = self.config
        out = ForecastResult()
        self.stats["reconciles"] += 1
        self.series.advance(now)
        self.spot_prior.accrue(self.cluster.nodes.values(), now)
        for pool in sorted(set(self.spot_prior._reclaims)
                           | set(self.spot_prior._node_hours)):
            metrics.forecast_spot_risk().set(
                self.spot_prior.rate(pool), {"nodepool": pool})

        out.expired = self._expire(now)

        # live placeholders per class (pending + bound, unexpired)
        live_headroom: Dict[str, int] = {}
        for p in self.headroom_pods():
            cls = p.labels.get(HEADROOM_CLASS_LABEL, "")
            live_headroom[cls] = live_headroom.get(cls, 0) + 1

        bucket = max(self.series.bucket_s, 1e-9)
        lead_steps = max(1, int(math.ceil(cfg.lead_s / bucket)))
        steps = lead_steps + max(1, int(math.ceil(cfg.horizon_s / bucket)))
        prefer_on_demand = \
            self.spot_prior.max_rate() > cfg.spot_risk_threshold

        candidates: List[Pod] = []
        with tracing.span("forecast.model", classes=len(
                self.series.classes())) as msp:
            for cls in self.series.classes():
                values = self.series.values(cls)
                env = self.forecaster.forecast(values, steps,
                                               z=cfg.confidence)
                target = float(np.max(env.upper[lead_steps - 1:])) \
                    if env.steps else 0.0
                out.targets[cls] = target
                metrics.forecast_demand_upper().set(
                    target, {"pod_class": cls})
                # residual of the freshest one-step prediction vs reality:
                # |mean[0] - current live| is a cheap online fit signal
                if env.steps:
                    metrics.forecast_model_residual().observe(
                        abs(float(env.mean[0]) - self.series.live(cls)),
                        {"model": getattr(self.forecaster, "name", "?")})
                need = int(math.ceil(target)) - self.series.live(cls) \
                    - live_headroom.get(cls, 0)
                need = min(need, cfg.max_placeholders_per_class)
                if need <= 0:
                    continue
                cpu, mem = self.series.mean_request(cls)
                if cpu <= 0 and mem <= 0:
                    continue
                candidates.extend(
                    self._placeholder(cls, cpu, mem, now, prefer_on_demand)
                    for _ in range(need))
            msp.annotate(candidates=len(candidates))

        if len(candidates) > cfg.max_issue_per_reconcile:
            # deterministic round-robin across classes (candidates are
            # grouped per class in sorted-class order) so one hot class
            # cannot starve the others under the cap
            by_cls: Dict[str, List[Pod]] = {}
            for p in candidates:
                by_cls.setdefault(
                    p.labels[HEADROOM_CLASS_LABEL], []).append(p)
            picked: List[Pod] = []
            while len(picked) < cfg.max_issue_per_reconcile:
                progressed = False
                for cls in sorted(by_cls):
                    if by_cls[cls] and \
                            len(picked) < cfg.max_issue_per_reconcile:
                        picked.append(by_cls[cls].pop(0))
                        progressed = True
                if not progressed:
                    break
            candidates = picked

        if candidates:
            kept = self._within_budget(candidates, out)
            if kept:
                self.cluster.add_pods(kept)
                out.issued = len(kept)
                self.stats["issued"] += len(kept)
                metrics.forecast_placeholders().inc(
                    {"outcome": "issued"}, by=len(kept))
                self.recorder.publish(Event(
                    "Forecast", "headroom", "HeadroomIssued",
                    f"issued {len(kept)} placeholder(s) toward "
                    f"forecast demand"))

        live_now = sum(1 for p in self.cluster.pods.values()
                       if is_headroom(p))
        self.stats["peak_live"] = max(self.stats["peak_live"], live_now)
        metrics.forecast_headroom_pods().set(live_now)
        return out

    # ------------------------------------------------------------------
    def _expire(self, now: float) -> int:
        expired = [p for p in self.headroom_pods()
                   if (headroom_expiry(p) or 0.0) <= now]
        for p in expired:
            self.cluster.delete_pod(p)
        if expired:
            self.stats["expired"] += len(expired)
            metrics.forecast_placeholders().inc(
                {"outcome": "expired"}, by=len(expired))
        return len(expired)

    def _placeholder(self, cls: str, cpu: float, mem: float, now: float,
                     prefer_on_demand: bool) -> Pod:
        safe = _SAFE_NAME.sub("-", cls.lower()).strip("-") or "class"
        name = f"headroom-{safe}-{next(self._seq):06d}"
        selector = {wk.CAPACITY_TYPE: wk.CAPACITY_TYPE_ON_DEMAND} \
            if prefer_on_demand else {}
        return Pod(
            name=name, uid=name,
            requests=ResourceList({CPU: max(1.0, round(cpu)),
                                   MEMORY: max(1.0, round(mem))}),
            labels={HEADROOM_LABEL: "true", HEADROOM_CLASS_LABEL: cls},
            annotations={
                HEADROOM_EXPIRY_ANNOTATION: f"{now + self.config.ttl_s:.3f}"},
            node_selector=selector,
            priority=HEADROOM_PRIORITY,
            owner_kind="")     # placeholders die with their node, never requeue

    def _within_budget(self, placeholders: List[Pod],
                       out: ForecastResult) -> List[Pod]:
        """Dry-run the batch through the real solver off live state and
        keep placeholders in solver order until new-node spend hits the
        cap — placeholders the solver lands on EXISTING capacity are free
        and always kept.  A failed solve skips the round; a fault of the
        card or a kernel propagates."""
        cfg = self.config
        nodes = self.cluster.snapshot_nodes()
        pools = self.provisioner._pools_within_limits()
        with tracing.span("forecast.plan",
                          placeholders=len(placeholders)) as psp:
            try:
                problem, packing = self.provisioner.solve(
                    placeholders, nodes=nodes, pools=pools)
            except DEVICE_FAULTS:
                raise
            except Exception as e:  # noqa: BLE001 — skip the round, retry next
                log.warning("headroom dry-run solve failed: %s", e)
                return []
            rate = sum(n.price for n in self.cluster.nodes.values())
            budget = max(cfg.max_cost_frac * rate, cfg.min_budget_per_h)
            keep = set()
            for i in packing.existing_assignments:
                keep.add(problem.pods[i].uid)
            spend = 0.0
            planned: List[Tuple[str, float]] = []
            for nd in packing.nodes:
                price = float(getattr(nd.option, "price", 0.0))
                if spend + price > budget:
                    continue
                spend += price
                planned.append((getattr(nd.option, "pool", "") or "", price))
                for i in nd.pod_indices:
                    keep.add(problem.pods[i].uid)
            psp.annotate(budget=round(budget, 4), spend=round(spend, 4),
                         kept=len(keep))
        # cost-ledger annotation (SLOEngine gate): the spend this headroom
        # round PLANS, as reservations — the nodes themselves, if demand
        # materializes, are ledgered by their own launches, so reservations
        # stay out of the per-source capacity sums (no double-count)
        from ..obs.ledger import LEDGER
        if LEDGER.enabled and planned:
            now = self.clock()
            for pool, price in planned:
                LEDGER.record_reservation(
                    nodepool=pool,
                    expected_dh=price * cfg.ttl_s / 3600.0,
                    at=now, ttl_s=cfg.ttl_s)
        kept = [p for p in placeholders if p.uid in keep]
        dropped = len(placeholders) - len(kept)
        if dropped:
            out.trimmed += dropped
            self.stats["trimmed"] += dropped
            metrics.forecast_placeholders().inc(
                {"outcome": "trimmed"}, by=dropped)
        return kept

    # ------------------------------------------------------------------
    def preempt_for_pending(self) -> int:
        """Yield placeholders to real demand: called by the manager right
        before each provisioning solve.  Pending placeholders all step
        aside; bound ones are evicted (earliest expiry first) until the
        freed capacity covers the real pending requests."""
        pending_real = [p for p in self.cluster.pending_pods()
                        if not is_headroom(p)]
        if not pending_real:
            return 0
        with tracing.span("forecast.preempt",
                          pending=len(pending_real)) as sp:
            n = 0
            for p in sorted((q for q in self.cluster.pending_pods()
                             if is_headroom(q)), key=lambda q: q.name):
                self.cluster.delete_pod(p)
                n += 1
            need_cpu = sum(float(p.requests.get("cpu", 0))
                           for p in pending_real)
            need_mem = sum(float(p.requests.get("memory", 0))
                           for p in pending_real)
            freed_cpu = freed_mem = 0.0
            bound = sorted(
                (q for q in self.cluster.pods.values()
                 if is_headroom(q) and q.node_name),
                key=lambda q: (headroom_expiry(q) or 0.0, q.name))
            for p in bound:
                if freed_cpu >= need_cpu and freed_mem >= need_mem:
                    break
                freed_cpu += float(p.requests.get("cpu", 0))
                freed_mem += float(p.requests.get("memory", 0))
                self.cluster.delete_pod(p)
                n += 1
            if n:
                self.stats["preempted"] += n
                metrics.forecast_placeholders().inc(
                    {"outcome": "preempted"}, by=n)
            sp.annotate(preempted=n)
        return n
