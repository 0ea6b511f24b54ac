"""Deterministic chaos injection: seeded fault schedules at named points.

A copy of the JAX package's `utils/chaos.py`.  The injector is a
process-global singleton (`CHAOS`) that is OFF by default and costs one
boolean check on the happy path.  Tests, the sim harness (`ChaosSpec`) or
the operator (`--chaos-spec` / `KARPENTER_TPU_CHAOS_SPEC`) arm it with a list
of `ChaosRule`s; each rule owns an independent numpy Generator keyed on
``[seed, rule-index]``, drawn only by a matching call with `rate < 1`, so the
same (rules, seed, call sequence) always injects the same schedule — the
property the chaos golden report depends on.

Injection points are a closed registry (`POINTS`): graftlint RS002
rejects literal `CHAOS.inject("...")` names outside it.  The `key`
argument is the dynamic discriminator within a point (controller name,
solver rung, cloud API name), so one rule can target
`controller.reconcile` for just `disruption`.  `leader.lease` is the
LeaderElector's seam (key "acquire" or "release", operator/manager.py);
`refinery.refine` is registered as in the reference, which has no call
site for it either.  Every injection is
counted in karpenter_chaos_injections_total{point, action}, and the flight
recorder's bundles carry `counts()` and `fired_total()` (operator/manager.py).

Actions:
  * ``error``   — raise `ChaosError` (or the fake cloud's
    `CloudError(error_code)` when the rule carries a cloud code, so the
    provider's retry taxonomy sees a realistic failure);
  * ``latency`` — call the configured sleep for `latency_s` (wall sleep in
    live runs and threaded tests; the sim passes a no-op sleep because wall
    latency is meaningless under a virtual clock);
  * ``hang``    — sleep `latency_s` as one blocking call; meaningful under a
    watchdog deadline shorter than the hang (utils/watchdog.py), which is
    how the hung-solver tests trip the ladder.

Injected faults fire before any work of the seam they sit in, so the
ladder answers a fault of the solve's logic and never a fault of the card.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import metrics

log = logging.getLogger("karpenter_tpu_torch.chaos")

# The closed injection-point registry (graftlint RS002).  Every literal
# `CHAOS.inject("<point>")` call site must name a member; new seams
# register here first so the chaos scenario schema stays in sync.
POINTS = frozenset({
    "controller.reconcile",   # manager tick, key = controller name
    "solver.pack",            # provisioning/disruption pack step, key = rung
    "solver.sweep",           # batched consolidation sweep
    "cloud.api",              # FakeCloud API entry, key = api name
    "refinery.refine",        # background guide refinement
    "leader.lease",           # lease I/O (acquire/release), key = op
})

ACTIONS = ("error", "latency", "hang")


class ChaosError(RuntimeError):
    """An injected fault (not a real bug): supervisors/ladders must treat
    it exactly like any other controller/solver exception."""


@dataclass
class ChaosRule:
    """One fault stream.  `at_s`/`until_s` are absolute clock values (the
    sim converts scenario-relative offsets before configuring); `rate` is
    the per-call injection probability drawn from the rule's own stream;
    `count` bounds total injections (0 = unbounded)."""
    point: str
    key: str = ""            # "" or "*" matches every key at the point
    action: str = "error"
    rate: float = 1.0
    at_s: float = float("-inf")
    until_s: float = float("inf")
    latency_s: float = 0.0
    count: int = 0
    error_code: str = ""     # raise CloudError(code) instead of ChaosError


class ChaosInjector:
    """Seeded, schedule-driven fault injector.  Single-threaded consumers
    only (the manager tick loop / sim); the enabled check is lock-free so
    the disarmed hot path costs one attribute read."""

    def __init__(self) -> None:
        self.enabled = False
        self.rules: List[ChaosRule] = []
        self.clock: Callable[[], float] = time.monotonic
        self.sleep: Callable[[float], None] = time.sleep
        self._rngs: List[np.random.Generator] = []
        self._fired: List[int] = []
        self._injected: Dict[Tuple[str, str], int] = {}

    def configure(self, rules: Sequence[ChaosRule], seed: int = 0,
                  clock: Callable[[], float] = time.monotonic,
                  sleep: Callable[[float], None] = time.sleep) -> None:
        for i, r in enumerate(rules):
            if r.point not in POINTS:
                raise ValueError(f"chaos rule {i}: unknown point {r.point!r} "
                                 f"(expected one of {sorted(POINTS)})")
            if r.action not in ACTIONS:
                raise ValueError(f"chaos rule {i}: unknown action "
                                 f"{r.action!r} (expected one of {ACTIONS})")
            if not 0.0 < r.rate <= 1.0:
                raise ValueError(f"chaos rule {i}: rate must be in (0, 1]")
        self.rules = list(rules)
        self.clock = clock
        self.sleep = sleep
        # one stream per rule: adding a rule never perturbs its siblings
        self._rngs = [np.random.default_rng([int(seed), i])
                      for i in range(len(self.rules))]
        self._fired = [0] * len(self.rules)
        self._injected = {}
        self.enabled = bool(self.rules)

    def reset(self) -> None:
        """Disarm and forget all schedules (test teardown / sim finally)."""
        self.enabled = False
        self.rules = []
        self._rngs = []
        self._fired = []
        self._injected = {}
        self.clock = time.monotonic
        self.sleep = time.sleep

    def inject(self, point: str, key: str = "") -> None:
        """Maybe fire at a named point.  Raises on an `error` action;
        sleeps on `latency`/`hang`; returns silently otherwise."""
        if not self.enabled:
            return
        if point not in POINTS:
            raise ValueError(f"unregistered chaos point {point!r}")
        now = self.clock()
        for i, r in enumerate(self.rules):
            if r.point != point:
                continue
            if r.key not in ("", "*") and r.key != key:
                continue
            if not (r.at_s <= now < r.until_s):
                continue
            if r.count and self._fired[i] >= r.count:
                continue
            if r.rate < 1.0 and float(self._rngs[i].random()) >= r.rate:
                continue
            self._fired[i] += 1
            self._injected[(point, r.action)] = \
                self._injected.get((point, r.action), 0) + 1
            metrics.chaos_injections().inc({"point": point,
                                            "action": r.action})
            log.debug("chaos: %s at %s[%s]", r.action, point, key)
            if r.action == "error":
                if r.error_code:
                    from ..cloud.fake import CloudError
                    raise CloudError(r.error_code,
                                     f"chaos injected at {point}[{key}]")
                raise ChaosError(f"chaos injected at {point}"
                                 + (f"[{key}]" if key else ""))
            self.sleep(r.latency_s)
            return

    def counts(self) -> Dict[str, int]:
        """Deterministic injection totals keyed "point/action" (the chaos
        section of the sim report)."""
        return {f"{p}/{a}": n
                for (p, a), n in sorted(self._injected.items())}

    def fired_total(self) -> int:
        return sum(self._fired)


CHAOS = ChaosInjector()


def parse_spec(spec: str) -> List[ChaosRule]:
    """Parse the `--chaos-spec` flag / `KARPENTER_TPU_CHAOS_SPEC` env
    format: semicolon-separated rules of comma-separated `k=v` pairs, e.g.
    ``point=controller.reconcile,key=disruption,action=error,rate=0.5;
    point=cloud.api,action=error,error_code=RequestLimitExceeded``."""
    rules: List[ChaosRule] = []
    for chunk in filter(None, (c.strip() for c in spec.split(";"))):
        kw: Dict[str, object] = {}
        for item in filter(None, (i.strip() for i in chunk.split(","))):
            k, _, v = item.partition("=")
            k = k.strip()
            if k in ("rate", "at_s", "until_s", "latency_s"):
                kw[k] = float(v)
            elif k == "count":
                kw[k] = int(v)
            elif k in ("point", "key", "action", "error_code"):
                kw[k] = v.strip()
            else:
                raise ValueError(f"chaos spec: unknown field {k!r}")
        if "point" not in kw:
            raise ValueError(f"chaos spec: rule {chunk!r} needs point=")
        rules.append(ChaosRule(**kw))  # type: ignore[arg-type]
    return rules


def maybe_configure_from_options(options) -> bool:
    """Arm the global injector from Options (live operator startup).
    Returns True when chaos was armed.  The sim harness configures the
    injector directly instead so schedules ride the virtual clock."""
    spec = getattr(options, "chaos_spec", "") or ""
    if not spec:
        return False
    CHAOS.configure(parse_spec(spec),
                    seed=int(getattr(options, "chaos_seed", 0)))
    log.warning("chaos injection ARMED: %d rule(s), seed=%d",
                len(CHAOS.rules), int(getattr(options, "chaos_seed", 0)))
    return True
