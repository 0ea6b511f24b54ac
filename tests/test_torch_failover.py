"""The port's HA failover (`LeaderElector` and the manager's lease guards,
readiness ladder and graceful handover in karpenter_tpu_torch/operator/
manager.py, `LeaseFence` in utils/fencing.py, the fenced funnels of
cloud/provider.py) against the JAX package's, case by case with
tests/test_failover.py's 31 cases, on the CPU.  Each case runs on both
packages (tests/torch_ha.py `both`) and returns plain observations that
must be equal: epochs, the elector's `acquisitions` / `losses` /
`releases`, the fence's `refusals`, phases, readiness payloads.  Where a
reference case reads a metric family, each side reads its own package's
family (`_metric`).

Then the two-process kill -9 drill in each package (a SIGKILL'd leader, a
standby that promotes through warm restore + parity probe, plan streams
byte-identical to an uninterrupted run and equal across the packages, a
ghost of the dead leader whose snapshot and terminate are refused), and
the canned `failover-drill` scenario replayed by the port against
tests/golden/sim-failover-drill.json byte for byte, with the arena on and
off.
"""

import fcntl
import hashlib
import importlib
import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.request

import pytest

from torch_cases import clear_lp_caches
from torch_cases import one_torch_thread  # noqa: F401
from torch_ha import (PORT, REF, REPO, both, elector, ha_stack, operator,
                      provision)
from torch_refnative import reference_native_loaded  # noqa: F401

GOLDEN = os.path.join(REPO, "tests", "golden")
SCENARIOS = os.path.join(REPO, "scenarios")


@pytest.fixture(autouse=True)
def _disarm_chaos():
    clear_lp_caches("karpenter_tpu", "karpenter_tpu_torch")
    yield
    REF.chaos.CHAOS.reset()
    PORT.chaos.CHAOS.reset()
    clear_lp_caches("karpenter_tpu", "karpenter_tpu_torch")


def _metric(m, family, **labels):
    """The sum of `m`'s package's metric family over the samples whose
    labels are `labels` (every sample when none are given)."""
    metrics = importlib.import_module(f"{m.name}.utils.metrics")
    fam = getattr(metrics, family)()
    want = tuple(sorted(labels.items()))
    return sum(v for _, kv, v in fam.samples()
               if tuple(sorted(kv)) == want or not labels)


def _counts(e):
    return e.acquisitions, e.losses, e.releases


# ---------------------------------------------------------------------------
# elector edge cases: the lease is hostile territory
# ---------------------------------------------------------------------------

def test_first_acquisition_is_epoch_one(tmp_path):
    def case(m, d):
        clk = [100.0]
        a = elector(m, d, "a", clk)
        assert a.try_acquire()
        assert a.is_leader() and a.holds_fence()
        assert a.fence_epoch() == 1
        assert a.acquisitions == 1 and a.losses == 0
        return a.fence_epoch(), _counts(a)
    both(case, tmp_path)


def test_renewal_preserves_epoch_and_counts_once(tmp_path):
    def case(m, d):
        clk = [100.0]
        a = elector(m, d, "a", clk, ttl=10.0)
        assert a.try_acquire()
        for _ in range(5):
            clk[0] += 3.0            # always inside the TTL: one long term
            assert a.try_acquire()
        assert a.fence_epoch() == 1 and a.acquisitions == 1
        return a.fence_epoch(), _counts(a)
    both(case, tmp_path)


def test_rival_valid_lease_is_rejected(tmp_path):
    def case(m, d):
        clk = [100.0]
        a, b = elector(m, d, "a", clk), elector(m, d, "b", clk)
        assert a.try_acquire()
        assert not b.try_acquire()
        assert not b.is_leader() and not b.holds_fence()
        assert b.fence_epoch() == 0 and b.acquisitions == 0
        assert a.holds_fence()
        return _counts(a), _counts(b)
    both(case, tmp_path)


def test_takeover_after_expiry_bumps_epoch(tmp_path):
    def case(m, d):
        clk = [100.0]
        a = elector(m, d, "a", clk, ttl=5.0)
        b = elector(m, d, "b", clk, ttl=5.0)
        assert a.try_acquire()
        clk[0] += 6.0                # a's lease expires
        assert b.try_acquire()
        assert b.fence_epoch() == 2
        # a's epoch-1 token is dead forever, though the lease file no
        # longer mentions a at all
        assert not a.holds_fence()
        assert a.lease_remaining() == 0.0
        return b.fence_epoch(), b.lease_remaining()
    both(case, tmp_path)


def test_lease_corruption_mid_read(tmp_path):
    """A lease that cannot be parsed proves nobody's leadership, and
    re-acquiring over it is a new term — the epoch never regresses."""
    def case(m, d):
        clk = [100.0]
        a = elector(m, d, "a", clk)
        assert a.try_acquire()
        before = a.fence_epoch()
        with open(a.lease_path, "w") as f:
            f.write("{truncated garbage\x00")
        assert not a.is_leader() and not a.holds_fence()
        assert a.lease_remaining() == 0.0
        assert a.try_acquire()
        assert a.fence_epoch() > before and a.holds_fence()
        return before, a.fence_epoch(), _counts(a)
    both(case, tmp_path)


def test_clock_skew_between_replicas(tmp_path):
    """b's clock runs TTL+1s ahead: from its vantage a's fresh lease is
    already expired, so b steals it — and a must read itself deposed (the
    lease names b now; wall clocks never adjudicate)."""
    def case(m, d):
        clk_a, clk_b = [100.0], [106.0]
        a = elector(m, d, "a", clk_a, ttl=5.0)
        b = elector(m, d, "b", clk_b, ttl=5.0)
        assert a.try_acquire()
        assert b.try_acquire()
        assert b.fence_epoch() == 2
        assert not a.holds_fence()
        assert not a.try_acquire()
        assert a.losses == 1
        return _counts(a), _counts(b)
    both(case, tmp_path)


def test_flock_contention_and_holder_crash(tmp_path):
    """While another process holds the kernel flock, try_acquire neither
    blocks nor mutates; once the holder's fd closes (a crash included)
    election proceeds."""
    def case(m, d):
        clk = [100.0]
        a = elector(m, d, "a", clk)
        fd = os.open(f"{a.lease_path}.lock", os.O_CREAT | os.O_WRONLY,
                     0o644)
        fcntl.flock(fd, fcntl.LOCK_EX)
        assert not a.try_acquire()
        assert not os.path.exists(a.lease_path)
        os.close(fd)                 # the "crash": no explicit unlock
        assert a.try_acquire()
        assert a.fence_epoch() == 1
        return _counts(a)
    both(case, tmp_path)


def test_release_enables_immediate_takeover(tmp_path):
    """Release + rival acquire + re-acquire at the same virtual instant:
    failover costs one election round, and epochs stay monotone."""
    def case(m, d):
        clk = [100.0]
        a, b = elector(m, d, "a", clk), elector(m, d, "b", clk)
        assert a.try_acquire()
        assert a.release()
        assert a.releases == 1
        assert b.try_acquire() and b.fence_epoch() == 2
        assert b.release()
        assert a.try_acquire() and a.fence_epoch() == 3
        return _counts(a), _counts(b)
    both(case, tmp_path)


def test_release_by_non_holder_is_refused(tmp_path):
    def case(m, d):
        clk = [100.0]
        a, b = elector(m, d, "a", clk), elector(m, d, "b", clk)
        assert a.try_acquire()
        assert not b.release()
        assert b.releases == 0
        assert a.holds_fence()
        return _counts(a), _counts(b)
    both(case, tmp_path)


def test_double_release_counts_once(tmp_path):
    def case(m, d):
        clk = [100.0]
        a = elector(m, d, "a", clk)
        assert a.try_acquire()
        first, second = a.release(), a.release()
        assert a.releases == 1
        return first, second, _counts(a)
    both(case, tmp_path)


# ---------------------------------------------------------------------------
# the fence: stale epochs refuse, with counters
# ---------------------------------------------------------------------------

def test_check_passes_while_held(tmp_path):
    def case(m, d):
        clk = [100.0]
        a = elector(m, d, "a", clk)
        assert a.try_acquire()
        fence = m.fencing.LeaseFence(a)
        assert fence.check("snapshot")
        return fence.refusals
    assert both(case, tmp_path) == {}


def test_stale_check_refuses_and_counts_per_op(tmp_path):
    def case(m, d):
        clk = [100.0]
        a = elector(m, d, "a", clk, ttl=5.0)
        b = elector(m, d, "b", clk, ttl=5.0)
        assert a.try_acquire()
        fence = m.fencing.LeaseFence(a)
        clk[0] += 6.0
        assert b.try_acquire()
        before = _metric(m, "leader_fence_refusals", op="launch")
        assert not fence.check("launch")
        assert not fence.check("launch")
        assert not fence.check("terminate")
        counted = _metric(m, "leader_fence_refusals", op="launch") - before
        return fence.refusals, counted
    assert both(case, tmp_path) == ({"launch": 2, "terminate": 1}, 2)


def test_never_led_is_stale(tmp_path):
    def case(m, d):
        clk = [100.0]
        fence = m.fencing.LeaseFence(elector(m, d, "a", clk))
        assert not fence.check("snapshot")
        return fence.refusals
    assert both(case, tmp_path) == {"snapshot": 1}


# ---------------------------------------------------------------------------
# fenced writes: the snapshot and both cloud funnels
# ---------------------------------------------------------------------------

def test_gate_wires_fence_into_both_funnels(tmp_path):
    def case(m, d):
        clk = [100.0]
        op, mgr, led = ha_stack(m, d, clk, snap=str(d / "s.bin"))
        assert mgr.fence is not None
        assert op.cloud_provider.fence is mgr.fence
        assert mgr._snapshotter.fence is mgr.fence
        return type(mgr.fence).__name__
    both(case, tmp_path)


def test_gate_off_means_unfenced(tmp_path):
    def case(m, d):
        clk = [100.0]
        clock = lambda: clk[0]
        op = operator(m, m.operator.Options(interruption_queue="q"), clock)
        mgr = m.operator.ControllerManager(
            op, m.operator.build_controllers(op), clock=clock,
            leader=elector(m, d, "a", clk))
        return mgr.fence, op.cloud_provider.fence
    assert both(case, tmp_path) == (None, None)


def test_snapshot_write_stamped_while_held_refused_when_stale(tmp_path):
    def case(m, d):
        clk = [100.0]
        op, mgr, led = ha_stack(m, d, clk, ttl=5.0)
        provision(m, op, mgr, clk)
        path = str(d / "held.bin")
        assert m.snapshot.write_snapshot(path, op, mgr, fence=mgr.fence)
        sections, reason = m.snapshot.load_sections(path)
        assert reason == "ok"
        assert sections["meta"]["fence_epoch"] == led.fence_epoch()
        rival = elector(m, d, "rival", clk, ttl=5.0)
        clk[0] += 6.0
        assert rival.try_acquire()
        before = _metric(m, "snapshot_writes", outcome="stale_fence")
        path2 = str(d / "stale.bin")
        assert m.snapshot.write_snapshot(path2, op, mgr,
                                         fence=mgr.fence) is False
        assert not os.path.exists(path2)
        counted = _metric(m, "snapshot_writes",
                          outcome="stale_fence") - before
        return (sections["meta"]["fence_epoch"], mgr.fence.refusals,
                counted)
    assert both(case, tmp_path)[1:] == ({"snapshot": 1}, 1)


def test_snapshotter_cadence_refuses_when_stale(tmp_path):
    def case(m, d):
        clk = [100.0]
        snap = str(d / "s.bin")
        op, mgr, led = ha_stack(m, d, clk, ttl=5.0, snap=snap)
        assert led.try_acquire()
        rival = elector(m, d, "rival", clk, ttl=5.0)
        clk[0] += 6.0
        assert rival.try_acquire()
        wrote = mgr._snapshotter.maybe_write(clk[0])
        return wrote, os.path.exists(snap), mgr.fence.refusals
    assert both(case, tmp_path) == (False, False, {"snapshot": 1})


def test_cloud_mutations_raise_stale_fence(tmp_path):
    """The launch and terminate funnels must refuse (raise), never quietly
    mutate: a deposed leader's launch is a ghost node, its terminate kills
    a node the successor is using."""
    def case(m, d):
        clk = [100.0]
        op, mgr, led = ha_stack(m, d, clk, ttl=5.0)
        provision(m, op, mgr, clk)
        claims = [c for c in op.cloud_provider.list() if c.provider_id]
        assert claims
        running_before = len(op.cloud.running())
        rival = elector(m, d, "rival", clk, ttl=5.0)
        clk[0] += 6.0
        assert rival.try_acquire()
        with pytest.raises(m.fencing.StaleFenceError):
            op.cloud_provider.delete(claims[0])
        with pytest.raises(m.fencing.StaleFenceError):
            op.cloud_provider.create(claims[0])
        assert len(op.cloud.running()) == running_before
        return mgr.fence.refusals, running_before
    assert both(case, tmp_path)[0] == {"terminate": 1, "launch": 1}


# ---------------------------------------------------------------------------
# the mid-tick guard: a tick that outlives its lease aborts, counted
# ---------------------------------------------------------------------------

def test_slow_tick_aborts_before_snapshot(tmp_path):
    """A controller sweep that eats the whole TTL must not reach the
    snapshot write: the re-check before the final mutating phase aborts
    (counted) instead of acting deposed."""
    def case(m, d):
        clk = [100.0]
        snap = str(d / "s.bin")
        op, mgr, led = ha_stack(m, d, clk, ttl=5.0, snap=snap)

        def slow_reconcile():
            clk[0] += 11.0           # the lease dies mid-tick
        for e in mgr._entries:
            if e.name == "pricing":
                e.reconcile = slow_reconcile
        before = _metric(m, "leader_midtick_aborts")
        mgr.tick()
        assert mgr._midtick_aborts == 1
        counted = _metric(m, "leader_midtick_aborts") - before
        return counted, os.path.exists(snap)
    assert both(case, tmp_path) == (1, False)


def test_fast_tick_writes_normally(tmp_path):
    def case(m, d):
        clk = [100.0]
        snap = str(d / "s.bin")
        op, mgr, led = ha_stack(m, d, clk, ttl=15.0, snap=snap)
        mgr.tick()
        return mgr._midtick_aborts, os.path.exists(snap)
    assert both(case, tmp_path) == (0, True)


# ---------------------------------------------------------------------------
# readiness ladder: restore → probe → role, and what /readyz says
# ---------------------------------------------------------------------------

def test_single_replica_ladder(tmp_path):
    def case(m, d):
        clk = [100.0]
        clock = lambda: clk[0]
        op = operator(m, m.operator.Options(interruption_queue="q"), clock)
        mgr = m.operator.ControllerManager(
            op, m.operator.build_controllers(op), clock=clock)
        assert mgr.phase == "STARTING"
        first, ready0 = mgr.readiness_report()
        assert not ready0 and first["phase"] == "STARTING"
        mgr.startup()
        assert mgr.phase == "LEADING"
        assert mgr.probe_outcome == "skipped"   # empty cluster: no slab
        payload, ready = mgr.readiness_report()
        assert ready and payload["role"] == "single"
        assert mgr.phase_transitions.get("PROBING") == 1
        assert mgr.phase_transitions.get("LEADING") == 1
        return first, payload, mgr.phase_transitions
    both(case, tmp_path)


def test_startup_restores_and_probes_ok(tmp_path):
    def case(m, d):
        clk = [1000.0]
        snap = str(d / "s.bin")
        op, mgr, led = ha_stack(m, d, clk, snap=snap)
        provision(m, op, mgr, clk)
        assert m.snapshot.write_snapshot(snap, op, mgr)
        (d / "b").mkdir(exist_ok=True)
        op2, mgr2, led2 = ha_stack(m, d / "b", clk, snap=snap, ident="b")
        assert mgr2.startup() == "restored"
        assert mgr2.probe_outcome == "ok"
        assert set(op2.cluster.nodes) == set(op.cluster.nodes)
        payload, ready = mgr2.readiness_report()
        assert payload["restore"] == "restored"
        assert payload["probe"] == "ok"
        return payload, ready, sorted(op2.cluster.nodes)
    both(case, tmp_path)


def test_parity_mismatch_invalidates_arena(tmp_path):
    """A restored slab that disagrees with a cold tensorize is the one
    thing /readyz must never wave through: the probe reports mismatch and
    invalidates, so the first real solve rebuilds cold."""
    def case(m, d):
        clk = [1000.0]
        snap = str(d / "s.bin")
        op, mgr, led = ha_stack(m, d, clk, snap=snap)
        provision(m, op, mgr, clk)
        assert m.snapshot.write_snapshot(snap, op, mgr)
        op2, mgr2, _ = ha_stack(m, d, clk, snap=snap, ident="b")
        assert m.snapshot.restore_snapshot(snap, op2, mgr2) == "restored"
        invalidations = []
        arena = op2.cluster.arena
        orig_inv = arena.invalidate
        arena.invalidate = lambda reason="": (invalidations.append(reason),
                                              orig_inv(reason))[1]
        cls = m.cluster_mod.Cluster
        orig = cls.tensorize_nodes

        def skewed(self, reps):
            nodes, alloc, used, compat = orig(self, reps)
            alloc = alloc.copy()
            alloc[0, 0] += 1.0       # one flipped cell is enough
            return nodes, alloc, used, compat
        cls.tensorize_nodes = skewed
        try:
            outcome = mgr2.parity_probe()
        finally:
            cls.tensorize_nodes = orig
            arena.invalidate = orig_inv
        assert outcome == "mismatch"
        assert "parity_probe" in invalidations
        return outcome, invalidations
    both(case, tmp_path)


def test_standby_then_promotion(tmp_path):
    def case(m, d):
        clk = [100.0]
        op, mgr, led = ha_stack(m, d, clk, ttl=5.0)
        rival = elector(m, d, "rival", clk, ttl=5.0)
        assert rival.try_acquire()
        op.cluster.add_pods([m.objects.Pod(requests=m.resources.ResourceList(
            {m.resources.CPU: 500, m.resources.MEMORY: 512 * 2**20}))])
        assert mgr.tick() == {}      # cannot lead: tick skipped whole
        assert mgr.phase == "STANDBY"
        assert mgr._skipped_ticks == 1
        assert op.cluster.pending_pods()
        payload, ready = mgr.readiness_report()
        assert ready and payload["role"] == "standby"
        clk[0] += 6.0                # the rival dies (never renews)
        mgr.tick()
        assert mgr.phase == "LEADING"
        assert mgr.promotions == 1
        assert led.fence_epoch() == rival.fence_epoch() + 1
        return payload, led.fence_epoch(), mgr.phase_transitions
    both(case, tmp_path)


def test_lease_chaos_skips_ticks_and_counts(tmp_path):
    """The leader.lease chaos point: while lease I/O errors, ticks are
    skipped whole and counted; when the blackout lifts the next tick
    re-acquires and proceeds."""
    def case(m, d):
        clk = [100.0]
        op, mgr, led = ha_stack(m, d, clk, ttl=5.0)
        m.chaos.CHAOS.configure([m.chaos.ChaosRule(
            point="leader.lease", key="acquire", action="error", rate=1.0)],
            seed=0, clock=lambda: clk[0])
        op.cluster.add_pods([m.objects.Pod(requests=m.resources.ResourceList(
            {m.resources.CPU: 500, m.resources.MEMORY: 512 * 2**20}))])
        for _ in range(3):
            clk[0] += 1.0
            assert mgr.tick() == {}
        assert mgr._lease_errors == 3
        assert op.cluster.pending_pods()
        m.chaos.CHAOS.reset()
        clk[0] += 1.1
        mgr.tick()
        clk[0] += 1.1
        mgr.tick()
        assert mgr.phase == "LEADING"
        assert not op.cluster.pending_pods()
        return mgr._lease_errors, mgr._skipped_ticks, sorted(op.cluster.nodes)
    both(case, tmp_path)


def test_ha_counters_roundtrip_through_snapshot(tmp_path):
    """The leader/readiness counters survive the snapshot, the phase does
    not — a restoring process walks its own ladder."""
    def case(m, d):
        clk = [100.0]
        op, mgr, led = ha_stack(m, d, clk, ttl=5.0)
        m.chaos.CHAOS.configure([m.chaos.ChaosRule(
            point="leader.lease", key="acquire", action="error", rate=1.0)],
            seed=0, clock=lambda: clk[0])
        for _ in range(2):
            clk[0] += 1.0
            mgr.tick()
        m.chaos.CHAOS.reset()
        clk[0] += 1.0
        mgr.tick()                   # recovers: STANDBY → LEADING
        path = str(d / "ha.bin")
        assert m.snapshot.write_snapshot(path, op, mgr)
        sections, reason = m.snapshot.load_sections(path)
        assert reason == "ok"
        assert sections["leader"]["lease_errors"] == 2
        assert sections["leader"]["epoch"] == led.fence_epoch()
        op2, mgr2, _ = ha_stack(m, d, clk, snap=path, ident="b")
        assert m.snapshot.restore_snapshot(path, op2, mgr2) == "restored"
        assert mgr2._lease_errors == 2
        assert mgr2._skipped_ticks == mgr._skipped_ticks
        assert mgr2.promotions == mgr.promotions
        assert mgr2.phase == "STARTING"
        return sections["leader"], mgr2.phase
    both(case, tmp_path)


def _get(port, path):
    try:
        resp = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                      timeout=5)
        return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_readyz_flips_with_the_ladder(tmp_path):
    def case(m, d):
        clk = [100.0]
        clock = lambda: clk[0]
        op = operator(m, m.operator.Options(interruption_queue="q"), clock)
        mgr = m.operator.ControllerManager(
            op, m.operator.build_controllers(op), clock=clock)
        port = mgr.serve_endpoints(metrics_port=0)
        try:
            seen = [_get(port, "/readyz"), _get(port, "/healthz")]
            assert seen[0][0] == 503 and seen[0][1]["phase"] == "STARTING"
            assert seen[1][0] == 200 and seen[1][1]["live"] is True
            mgr.startup()
            seen.append(_get(port, "/readyz"))
            assert seen[2][0] == 200
            assert seen[2][1]["role"] == "single"
            assert seen[2][1]["probe"] == "skipped"
        finally:
            mgr.stop()
        return [(code, body.get("ready"), body.get("phase"),
                 body.get("role")) for code, body in seen]
    both(case, tmp_path)


def test_healthz_wedge_is_503(tmp_path):
    def case(m, d):
        clk = [100.0]
        clock = lambda: clk[0]
        op = operator(m, m.operator.Options(interruption_queue="q"), clock)
        mgr = m.operator.ControllerManager(
            op, m.operator.build_controllers(op), clock=clock)

        class OpenSup:
            def snapshot(self):
                return {"state": "open"}
        mgr.supervisors = {"a": OpenSup(), "b": OpenSup()}
        port = mgr.serve_endpoints(metrics_port=0)
        try:
            code, body = _get(port, "/healthz")
        finally:
            mgr.supervisors = {}
            mgr.stop()
        return code, body["live"], body["wedges"]
    assert both(case, tmp_path) == (503, False, ["all_circuits_open"])


# ---------------------------------------------------------------------------
# graceful handover: SIGTERM drains, releases, and the standby wins now
# ---------------------------------------------------------------------------

def test_stop_writes_final_then_releases(tmp_path):
    def case(m, d):
        clk = [100.0]
        snap = str(d / "s.bin")
        op, mgr, led = ha_stack(m, d, clk, ttl=15.0, snap=snap)
        provision(m, op, mgr, clk)
        mgr.stop()
        assert mgr.phase == "DRAINING"
        assert led.releases == 1
        sections, reason = m.snapshot.load_sections(snap)
        assert reason == "ok"
        assert sections["meta"]["fence_epoch"] == led.fence_epoch()
        b = elector(m, d, "b", clk, ttl=15.0)
        assert b.try_acquire()
        assert b.fence_epoch() == led.fence_epoch() + 1
        return _counts(led), b.fence_epoch()
    both(case, tmp_path)


def test_double_stop_is_idempotent(tmp_path):
    def case(m, d):
        clk = [100.0]
        snap = str(d / "s.bin")
        op, mgr, led = ha_stack(m, d, clk, ttl=15.0, snap=snap)
        provision(m, op, mgr, clk)
        mgr.stop()
        digest = hashlib.sha256(open(snap, "rb").read()).hexdigest()
        mgr.stop()
        assert led.releases == 1
        assert hashlib.sha256(open(snap, "rb").read()).hexdigest() == digest
        return mgr.fence.refusals
    assert both(case, tmp_path) == {}


# ---------------------------------------------------------------------------
# the two-process kill -9 failover drill
# ---------------------------------------------------------------------------

_CHILD = r"""
import hashlib, json, os, signal, sys
sys.path.insert(0, {repo!r})
from {pkg}.operator import (ControllerManager, Operator, Options,
                            build_controllers)
from {pkg}.operator.manager import LeaderElector
from {pkg}.api.objects import Pod
from {pkg}.api.resources import CPU, MEMORY, ResourceList
from {pkg}.catalog.generate import generate_catalog
from {pkg}.cloud.fake import ImageInfo, SecurityGroupInfo, SubnetInfo
from {pkg}.state.snapshot import write_snapshot
from {pkg}.utils.chaos import CHAOS, ChaosRule
from {pkg}.utils.fencing import LeaseFence, StaleFenceError

snap, plan, lease = sys.argv[1], sys.argv[2], sys.argv[3]
total, kill_after, ident = int(sys.argv[4]), int(sys.argv[5]), sys.argv[6]
resume = kill_after < 0 and os.path.exists(plan) and \
    os.path.getsize(plan) > 0
start_tick = 0
if resume:
    with open(plan) as fh:
        start_tick = sum(1 for _ in fh)

TTL = 1.0   # < the 1.1s tick spacing: a dead leader's lease is expired
#             by the standby's first tick — failover inside one tick
clk = [1000.0 + 1.1 * start_tick]

# every CreateFleet errors over the middle third of the run; rate=1.0
# never draws from the rule's stream, so a resumed process replays the
# identical storm
s0, s1 = total // 3, (2 * total) // 3
CHAOS.configure([ChaosRule(point="cloud.api", key="create_fleet",
                           action="error", rate=1.0,
                           at_s=1000.0 + 1.1 * (s0 + 1) - 0.05,
                           until_s=1000.0 + 1.1 * (s1 + 1) - 0.05)],
                seed=7, clock=lambda: clk[0])
opts = Options(snapshot_path=snap)
opts.feature_gates.update({{"WarmRestart": True, "HAFailover": True}})
op = Operator(opts, catalog=generate_catalog(10), clock=lambda: clk[0],
              **{extra!r})
op.cloud.subnets = [SubnetInfo("s-a", "zone-a", 10_000, {{}}),
                    SubnetInfo("s-b", "zone-b", 10_000, {{}})]
op.cloud.security_groups = [SecurityGroupInfo("sg", "nodes", {{}})]
op.cloud.images = [ImageInfo("img-1", "std", "amd64", 1.0)]
op.params.parameters = {{
    "/karpenter-tpu/images/standard/1.28/amd64/latest": "img-1"}}
leader = LeaderElector(lease, ident, ttl=TTL, clock=lambda: clk[0])
mgr = ControllerManager(op, build_controllers(op), clock=lambda: clk[0],
                        leader=leader)

outcome = mgr.startup()   # the readiness ladder, as __main__ runs it
print(f"STARTUP {{outcome}} {{mgr.probe_outcome}} {{mgr.phase}}", flush=True)
if resume:
    assert outcome == "restored", outcome
    assert mgr.probe_outcome == "ok", mgr.probe_outcome

for k in range(start_tick, total):
    clk[0] = 1000.0 + 1.1 * (k + 1)
    if k % 3 == 0:
        op.cluster.add_pods([
            Pod(name=f"p-{{k}}-{{i}}",
                requests=ResourceList({{CPU: 500, MEMORY: 512 * 2**20}}))
            for i in range(2)])
    mgr.tick()
    assert mgr.phase == "LEADING", mgr.phase
    line = {{"k": k,
             "nodes": sorted(op.cluster.nodes),
             "bound": sorted(p.name for p in op.cluster.pods.values()
                             if p.node_name),
             "running": sorted(i.id for i in op.cloud.running())}}
    with open(plan, "a") as fh:
        fh.write(json.dumps(line, sort_keys=True) + "\n")
    assert write_snapshot(snap, op, mgr, fence=mgr.fence)
    if k == kill_after:
        os.kill(os.getpid(), signal.SIGKILL)
print(f"DONE promotions={{mgr.promotions}}", flush=True)

if resume:
    # ghost phase: a stale incarnation of the dead leader comes back and
    # tries to write; every write must be refused, on the counters, with
    # zero bytes landing
    before = hashlib.sha256(open(snap, "rb").read()).hexdigest()
    ghost = LeaderElector(lease, "alpha", ttl=TTL, clock=lambda: clk[0])
    ghost._epoch = 1          # the epoch alpha led under, long superseded
    gf = LeaseFence(ghost)
    assert write_snapshot(snap, op, mgr, fence=gf) is False
    after = hashlib.sha256(open(snap, "rb").read()).hexdigest()
    assert before == after, "stale-fenced write mutated the snapshot"
    cloud = op.cloud_provider
    live_fence = cloud.fence
    cloud.fence = gf
    victims = [c for c in cloud.list() if c.provider_id]
    running_before = len(op.cloud.running())
    refused = 0
    try:
        cloud.delete(victims[0])
    except StaleFenceError:
        refused = 1
    cloud.fence = live_fence
    assert len(op.cloud.running()) == running_before
    print("GHOST " + json.dumps({{"refusals": dict(sorted(gf.refusals.items())),
                                  "terminate_refused": refused}},
                                sort_keys=True), flush=True)
"""


@pytest.mark.scale
def test_two_process_failover_drill(tmp_path):
    """Process alpha leads a deterministic driver and is SIGKILL'd mid-run,
    inside a CreateFleet chaos storm; process beta promotes through the
    readiness ladder (warm restore + arena parity probe + election) and
    finishes the run.  In each package the concatenated plan stream is
    byte-identical to an uninterrupted run (and the two packages' streams
    are equal), and a ghost of alpha has its snapshot and terminate
    refused on the fence's counters with zero bytes landing."""
    total, kill_at = 12, 6

    def case(m, d):
        child = d / "child.py"
        child.write_text(_CHILD.format(repo=REPO, pkg=m.name,
                                       extra=m.extra))
        env = dict(os.environ, JAX_PLATFORMS="cpu")

        def run(snap, plan, lease, kill, ident):
            return subprocess.run(
                [sys.executable, str(child), str(snap), str(plan),
                 str(lease), str(total), str(kill), ident],
                capture_output=True, text=True, env=env, timeout=300)

        pa = d / "plan_a.jsonl"
        proc = run(d / "snap_a.bin", pa, d / "a.lease", -1, "solo")
        assert proc.returncode == 0, proc.stderr
        assert "DONE" in proc.stdout
        sb, pb, lb = d / "snap_b.bin", d / "plan_b.jsonl", d / "b.lease"
        proc = run(sb, pb, lb, kill_at, "alpha")
        assert proc.returncode == -signal.SIGKILL
        assert len(pb.read_text().splitlines()) == kill_at + 1
        proc = run(sb, pb, lb, -1, "beta")
        assert proc.returncode == 0, proc.stderr
        # beta restored, probed ok, and its first tick promoted it out of
        # STANDBY; promotions is cumulative across the lineage (alpha's
        # rides in through the snapshot)
        assert "STARTUP restored ok STANDBY" in proc.stdout
        assert "DONE promotions=2" in proc.stdout
        assert pa.read_text() == pb.read_text(), (
            "plan stream diverged across kill -9 + fenced failover")
        last = json.loads(pa.read_text().splitlines()[-1])
        assert last["nodes"] and last["bound"] and last["running"]
        ghost = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("GHOST ")]
        assert ghost, proc.stdout
        got = json.loads(ghost[0][len("GHOST "):])
        assert got == {"refusals": {"snapshot": 1, "terminate": 1},
                       "terminate_refused": 1}
        return pa.read_text(), got
    both(case, tmp_path)


# ---------------------------------------------------------------------------
# the canned failover drill on the port, byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arena", [True, False], ids=["arena", "no-arena"])
def test_failover_drill_golden_report(arena):
    """scenarios/failover-drill.yaml (seed 0, 5400 s) replayed by the port
    on the CPU reproduces tests/golden/sim-failover-drill.json byte for
    byte — its `ha` section included — with the IncrementalArena gate on
    and off."""
    sim = PORT.sim
    run = sim.SimHarness(sim.load_scenario(
        os.path.join(SCENARIOS, "failover-drill.yaml")), seed=0,
        duration_s=5400.0, incremental_arena=arena, device="cpu").run()
    with open(os.path.join(GOLDEN, "sim-failover-drill.json")) as fh:
        want = fh.read()
    assert sim.report_to_json(run.report) == want
    assert run.report["ha"]["lease_errors"] > 0
