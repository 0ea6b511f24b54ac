"""Fencing tokens for the HA control plane (the HAFailover gate).

A copy of the JAX package's `utils/fencing.py`.  Leader election alone
cannot make "exactly one writer" an invariant: a deposed leader that is
mid-tick when its lease expires still has live references to the snapshot
file and the cloud substrate, and a GC pause or a slow solve can stretch
that window arbitrarily.  The classic fix (Chubby/ZooKeeper fencing tokens)
is what `LeaseFence` implements over the file lease: every acquisition by
a new holder bumps a monotone `epoch` stored in the lease itself, every
guarded write re-validates that the lease still names this process at the
epoch it acquired, and a stale check refuses the write and counts it in
`refusals`, by operation — refusal proven, not inferred from an absence of
attempts.

The guarded funnels (graftlint RS004 keeps them closed):

  * `state/snapshot.py` — `SnapshotWriter`'s cadence and final writes and
    the `write_snapshot` seam itself ("two operators, one snapshot file");
  * `cloud/provider.py` — the launch funnel (`create`) and the terminate
    funnel (`delete`) raise `StaleFenceError` instead of mutating.

`fence=None` everywhere means "no HA": single-replica deployments, the
sim, and every run without the gate go unfenced and byte-identically.
A refusal is counted in karpenter_leader_fence_refusals_total{op} and in
`refusals`, and publishes a `fence_refusal` incident (obs/incidents.py).
"""

from __future__ import annotations

import logging
from typing import Dict

from ..obs.incidents import publish_incident
from . import metrics

log = logging.getLogger("karpenter_tpu_torch.fencing")


class StaleFenceError(RuntimeError):
    """A guarded mutation was attempted with a stale fencing epoch: the
    lease names another holder (or a newer epoch of this one).  The
    caller must treat this as a hard refusal, never retry-until-success
    — the new leader owns the resource now."""


class LeaseFence:
    """Holder-side fencing token over a `LeaderElector` lease.

    `check(op)` is the one seam every guarded write calls: True means
    the lease still names our elector at the epoch it acquired; False
    means the write must not happen, and the refusal has already been
    counted (metrics + the `refusals` dict the failover drill asserts
    on)."""

    def __init__(self, elector):
        self.elector = elector
        self.refusals: Dict[str, int] = {}

    def epoch(self) -> int:
        """The fencing epoch this process last acquired with (0 = never)."""
        return self.elector.fence_epoch()

    def held(self) -> bool:
        return self.elector.holds_fence()

    def check(self, op: str) -> bool:
        """Validate the fence for one guarded mutation.  Counted refusal
        on staleness; an exception reading the lease counts as stale (an
        unreadable lease cannot prove we still hold it)."""
        try:
            if self.held():
                return True
        except Exception:
            log.exception("fence check for %s could not read the lease; "
                          "refusing", op)
        self.refusals[op] = self.refusals.get(op, 0) + 1
        metrics.leader_fence_refusals().inc({"op": op})
        publish_incident("fence_refusal", {
            "op": op, "epoch": self.elector.fence_epoch(),
            "refusals": dict(self.refusals)})
        log.warning("stale fence: refused %s (epoch %d no longer holds "
                    "the lease)", op, self.elector.fence_epoch())
        return False
