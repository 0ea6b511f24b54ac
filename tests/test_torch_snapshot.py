"""The port's warm restart (karpenter_tpu_torch/state/snapshot.py, the
snapshot sections of the cluster, arena, fake cloud, queue, supervisors
and manager) against the JAX package's, case by case with
tests/test_snapshot.py's 21 cases, on the CPU.  Each case runs on both
packages (tests/torch_ha.py `both`) and returns plain observations that
must be equal: node and pod names, restore outcomes, epochs, gathers,
circuit and ladder states.  Where a reference case reads a metric family,
each side reads its own package's family.

Then the port's own: the digest of `collect_sections`' plain content
after the same ticks in both packages (names, bindings, counters, epochs,
the LP caches' keys and arrays); every section free of torch tensors; the
restored class-id tokens of a process whose class order differs (which
the restore must drop); and a 5000-pod copy of the operator cell
(`workloads.operator_env`, 600 types) whose round 2 and disruption tick
after a restore equal the uninterrupted copy's, in both packages.
"""

import hashlib
import importlib
import json
import os
import pickle
import signal
import subprocess
import sys

import numpy as np
import pytest

from torch_cases import clear_lp_caches
from torch_cases import one_torch_thread  # noqa: F401
from torch_ha import (PORT, REF, REPO, both, gather_obs, gather_of, pod,
                      provisioned_stack, reset_counters, stack)

sys.path.insert(0, REPO)
from chip_smoke import object_types  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_caches():
    clear_lp_caches("karpenter_tpu", "karpenter_tpu_torch")
    yield
    REF.chaos.CHAOS.reset()
    PORT.chaos.CHAOS.reset()
    clear_lp_caches("karpenter_tpu", "karpenter_tpu_torch")


def _snap(d):
    return str(d / "snap.bin")


def _count_tensorize(m):
    """Patch the package's `Cluster.tensorize_nodes` to count its calls;
    returns (calls, undo)."""
    cls = m.cluster_mod.Cluster
    calls, orig = [0], cls.tensorize_nodes

    def counting(self, *a, **k):
        calls[0] += 1
        return orig(self, *a, **k)
    cls.tensorize_nodes = counting

    def undo():
        cls.tensorize_nodes = orig
    return calls, undo


# ---------------------------------------------------------------------------
# happy path: restore is warm, exact, and counter-safe
# ---------------------------------------------------------------------------

def test_restore_is_exact_and_warm(tmp_path):
    def case(m, d):
        clk = [1000.0]
        path = _snap(d)
        op, mgr = provisioned_stack(m, clk, path)
        assert m.snapshot.write_snapshot(path, op, mgr)
        op2, mgr2 = stack(m, lambda: clk[0], path, ("WarmRestart",))
        assert m.snapshot.restore_snapshot(path, op2, mgr2) == "restored"
        assert set(op2.cluster.nodes) == set(op.cluster.nodes)
        assert set(op2.cluster.pods) == set(op.cluster.pods)
        assert op2.cluster.mutation_epoch == op.cluster.mutation_epoch
        # the happy-path contract: the first gather never re-tensorizes
        calls, undo = _count_tensorize(m)
        try:
            g2, g1 = gather_obs(gather_of(op2)), gather_obs(gather_of(op))
        finally:
            undo()
        assert calls[0] == 0
        assert g1 == g2
        return sorted(op2.cluster.nodes), op2.cluster.mutation_epoch, g2
    both(case, tmp_path)


def test_restored_object_identity_pods_shared(tmp_path):
    """Single-pickle identity: a node's pods list entries must be the
    cluster.pods values, or the arena's identity-checked gather and every
    mutator walking node.pods diverge."""
    def case(m, d):
        clk = [1000.0]
        path = _snap(d)
        op, mgr = provisioned_stack(m, clk, path)
        assert m.snapshot.write_snapshot(path, op, mgr)
        op2, mgr2 = stack(m, lambda: clk[0], path, ("WarmRestart",))
        assert m.snapshot.restore_snapshot(path, op2, mgr2) == "restored"
        shared = [op2.cluster.pods.get(p.uid) is p
                  for node in op2.cluster.nodes.values() for p in node.pods]
        assert shared and all(shared)
        return len(shared)
    both(case, tmp_path)


def test_counters_continue_without_collision(tmp_path):
    def case(m, d):
        clk = [1000.0]
        path = _snap(d)
        op, mgr = provisioned_stack(m, clk, path)
        before = set(op.cluster.nodes)
        assert m.snapshot.write_snapshot(path, op, mgr)
        op2, mgr2 = stack(m, lambda: clk[0], path, ("WarmRestart",))
        assert m.snapshot.restore_snapshot(path, op2, mgr2) == "restored"
        # force more capacity: new node names must extend, not collide
        op2.cluster.add_pods([pod(m, cpu=3900) for _ in range(4)])
        clk[0] += 15.0
        mgr2.tick()
        clk[0] += 1.1
        mgr2.tick()
        grown = set(op2.cluster.nodes)
        new = grown - before
        assert grown > before and new
        old_max = max(int(n.rsplit("-", 1)[1]) for n in before)
        assert all(int(n.rsplit("-", 1)[1]) > old_max for n in new)
        return sorted(grown)
    both(case, tmp_path)


def test_snapshot_write_is_nonperturbing(tmp_path):
    """Probe-and-reset counter capture and live-dict export: writing a
    snapshot must not change what the run does next."""
    def case(m, d):
        clk = [1000.0]
        path = _snap(d)
        op, mgr = provisioned_stack(m, clk, path)
        epoch = op.cluster.mutation_epoch
        names_before = set(op.cluster.nodes)
        assert m.snapshot.write_snapshot(path, op, mgr)
        assert op.cluster.mutation_epoch == epoch
        op.cluster.add_pods([pod(m, cpu=3900)])
        clk[0] += 15.0
        mgr.tick()
        clk[0] += 1.1
        mgr.tick()
        new = set(op.cluster.nodes) - names_before
        old_max = max(int(n.rsplit("-", 1)[1]) for n in names_before)
        assert {int(n.rsplit("-", 1)[1]) for n in new} == \
            {old_max + 1 + i for i in range(len(new))}
        return sorted(new)
    both(case, tmp_path)


# ---------------------------------------------------------------------------
# corruption taxonomy: every bad snapshot is a cold fallback with its reason
# ---------------------------------------------------------------------------

def _rewrite(m, path, mutate_sections):
    """Load, mutate the pickled sections, re-checksum, write back — forging
    a snapshot that passes the integrity checks but fails semantic ones."""
    magic = m.snapshot.MAGIC
    with open(path, "rb") as fh:
        blob = fh.read()
    sections = pickle.loads(blob[len(magic) + 32:])
    mutate_sections(sections)
    payload = pickle.dumps(sections, protocol=pickle.HIGHEST_PROTOCOL)
    with open(path, "wb") as fh:
        fh.write(magic + hashlib.sha256(payload).digest() + payload)


def _flip_byte(path):
    with open(path, "rb") as fh:
        blob = bytearray(fh.read())
    blob[-10] ^= 0xFF
    with open(path, "wb") as fh:
        fh.write(bytes(blob))


def _poison(sections):
    # keep the epoch so validation passes and only the apply fails
    sections["cluster"] = {
        "mutation_epoch": sections["cluster"]["mutation_epoch"],
        "nodes": "not a dict"}


CORRUPTIONS = {
    "missing": (lambda m, p: os.remove(p), "missing"),
    "bad_magic": (lambda m, p: open(p, "r+b").write(b"NOTASNAP"),
                  "bad_magic"),
    "truncated_header": (lambda m, p: open(p, "wb").write(
        m.snapshot.MAGIC[:4]), "bad_magic"),
    "flipped_payload_byte": (lambda m, p: _flip_byte(p), "bad_checksum"),
    "version_skew": (lambda m, p: _rewrite(m, p, lambda s: s["meta"].update(
        version=99)), "bad_version"),
    "epoch_mismatch": (lambda m, p: _rewrite(m, p, lambda s: s["meta"].update(
        cluster_epoch=s["meta"]["cluster_epoch"] + 1)), "epoch_mismatch"),
    "apply_error": (lambda m, p: _rewrite(m, p, _poison), "apply_error"),
}


@pytest.mark.parametrize("kind", sorted(CORRUPTIONS))
def test_corruption_is_a_cold_fallback(tmp_path, kind):
    """tests/test_snapshot.py's TestCorruption cases: the restore returns
    the reason and leaves a working operator — the loop still ticks, and
    after an apply error the invalidated arena rebuilds and serves."""
    corrupt, expected = CORRUPTIONS[kind]

    def case(m, d):
        clk = [1000.0]
        path = _snap(d)
        op, mgr = provisioned_stack(m, clk, path)
        assert m.snapshot.write_snapshot(path, op, mgr)
        corrupt(m, path)
        op2, mgr2 = stack(m, lambda: clk[0], path, ("WarmRestart",))
        outcome = m.snapshot.restore_snapshot(path, op2, mgr2)
        assert outcome == expected
        clk[0] += 15.0
        mgr2.tick()
        assert gather_of(op2) is not None
        return outcome, sorted(op2.cluster.nodes)
    both(case, tmp_path)


def test_outcomes_are_counted(tmp_path):
    """Both packages count restore outcomes in their metric family and
    return them: one "restored" and one "bad_magic"."""
    def case(m, d):
        clk = [1000.0]
        path = _snap(d)
        op, mgr = provisioned_stack(m, clk, path)
        assert m.snapshot.write_snapshot(path, op, mgr)
        fam = importlib.import_module(
            f"{m.name}.utils.metrics").snapshot_restores()
        before = {o: fam.value({"outcome": o})
                  for o in ("restored", "bad_magic")}
        got = []
        op2, mgr2 = stack(m, lambda: clk[0], path, ("WarmRestart",))
        got.append(m.snapshot.restore_snapshot(path, op2, mgr2))
        with open(path, "r+b") as fh:
            fh.write(b"NOTASNAP")
        op3, mgr3 = stack(m, lambda: clk[0], path, ("WarmRestart",))
        got.append(m.snapshot.restore_snapshot(path, op3, mgr3))
        assert {o: got.count(o) for o in before} == \
            {o: fam.value({"outcome": o}) - before[o] for o in before}
        return got, {o: fam.value({"outcome": o}) - before[o]
                     for o in before}
    assert both(case, tmp_path)[1] == {"restored": 1, "bad_magic": 1}


# ---------------------------------------------------------------------------
# mid-lifecycle snapshot (tainted, not yet terminated)
# ---------------------------------------------------------------------------

def test_midlifecycle_taint_interleaved_snapshot_restore(tmp_path):
    """Snapshot a node mid-disruption — cordon taint applied, termination
    not yet started — with touch_node deltas interleaved around the
    snapshot; the restored gather must equal a from-scratch tensorize and
    keep tracking later touches exactly."""
    def case(m, d):
        clk = [1000.0]
        path = _snap(d)
        op, mgr = provisioned_stack(m, clk, path)
        name = sorted(op.cluster.nodes)[0]
        node = op.cluster.nodes[name]
        node.taints = list(node.taints) + [m.taints.Taint(
            "karpenter.sh/disrupting", "NoSchedule")]
        op.cluster.touch_node(node)               # pre-snapshot touch
        assert m.snapshot.write_snapshot(path, op, mgr)
        node.taints = [t for t in node.taints
                       if t.key != "karpenter.sh/disrupting"]
        op.cluster.touch_node(node)               # post-snapshot: must not
        #                                           leak into it
        op2, mgr2 = stack(m, lambda: clk[0], path, ("WarmRestart",))
        assert m.snapshot.restore_snapshot(path, op2, mgr2) == "restored"
        node2 = op2.cluster.nodes[name]
        assert any(t.key == "karpenter.sh/disrupting" for t in node2.taints)
        reps = list(op2.cluster.pods.values())
        g = op2.cluster.arena.gather(reps)
        assert g is not None
        assert gather_obs(g) == gather_obs(op2.cluster.tensorize_nodes(reps))
        node2.taints = []
        op2.cluster.touch_node(node2)
        g2 = gather_obs(op2.cluster.arena.gather(reps))
        assert g2 == gather_obs(op2.cluster.tensorize_nodes(reps))
        return gather_obs(g), g2
    both(case, tmp_path)


# ---------------------------------------------------------------------------
# chaos × restart: circuits, ladders, breakers and caches survive
# ---------------------------------------------------------------------------

def test_chaos_restart_restores_circuits_ladder_and_ice(tmp_path):
    def case(m, d):
        clk = [1000.0]
        path = _snap(d)
        op, mgr = provisioned_stack(m, clk, path)
        boom = RuntimeError("chaos")
        for _ in range(3):
            mgr.supervisors["disruption"].record_failure(clk[0], boom)
        for _ in range(20):
            mgr.supervisors["tagging"].record_failure(clk[0], boom)
        health = mgr.controllers["provisioning"].health
        for _ in range(3):
            health.report_failure("jax", "timeout")
        it = op.catalog[0]
        o = it.offerings[0]
        op.unavailable.mark_unavailable("chaos", it.name, o.zone,
                                        o.capacity_type)
        assert m.snapshot.write_snapshot(path, op, mgr)
        op2, mgr2 = stack(m, lambda: clk[0], path, ("WarmRestart",))
        assert m.snapshot.restore_snapshot(path, op2, mgr2) == "restored"
        for name in ("disruption", "tagging", "provisioning"):
            assert mgr2.supervisors[name].snapshot_state() == \
                mgr.supervisors[name].snapshot_state(), name
        tagging = mgr2.supervisors["tagging"].snapshot_state()
        assert tagging["state"] == "open"
        assert tagging["total_quarantines"] >= 1
        health2 = mgr2.controllers["provisioning"].health
        assert health2.snapshot_state() == health.snapshot_state()
        assert health2.active_rung("jax") != "jax"
        assert op2.unavailable.is_unavailable(o.capacity_type, it.name,
                                              o.zone)
        assert op2.unavailable.seq_num == op.unavailable.seq_num
        op2.cluster.add_pods([pod(m) for _ in range(3)])
        for _ in range(30):
            clk[0] += 5.0
            mgr2.tick()
        assert not op2.cluster.pending_pods()
        return (tagging, health2.snapshot_state(),
                sorted(op2.cluster.nodes))
    both(case, tmp_path)


def test_chaos_restart_restores_decode_breaker(tmp_path):
    """A demoted device-decode path stays demoted across a warm restart in
    the same clock domain, and the doubling window still expires into the
    half-open probe afterwards; a gate-off successor restores past the
    orphan section."""
    def case(m, d):
        clk = [1000.0]
        path = _snap(d)
        clock = lambda: clk[0]
        op, mgr = stack(m, clock, path, ("WarmRestart", "DeviceDecode"))
        dh = mgr.controllers["provisioning"].decode_health
        assert dh is not None and dh.clock is op.clock
        dh.report_failure("error")
        dh.report_failure("error")          # second failure → demoted, 60s
        assert dh.demotions == 1 and not dh.allow()
        assert m.snapshot.write_snapshot(path, op, mgr)
        op2, mgr2 = stack(m, clock, path, ("WarmRestart", "DeviceDecode"))
        assert m.snapshot.restore_snapshot(path, op2, mgr2) == "restored"
        dh2 = mgr2.controllers["provisioning"].decode_health
        assert dh2.snapshot_state() == dh.snapshot_state()
        assert not dh2.allow()
        clk[0] += 61.0
        assert dh2.allow() and dh2.probing
        dh2.report_success()
        assert dh2.demotions == 0
        assert dh2.transitions.get("recovered:recovered") == 1
        op3, mgr3 = stack(m, clock, path, ("WarmRestart",))
        assert mgr3.controllers["provisioning"].decode_health is None
        assert m.snapshot.restore_snapshot(path, op3, mgr3) == "restored"
        return dh.snapshot_state(), dict(dh2.transitions)
    both(case, tmp_path)


def test_chaos_restart_restores_lp_solver_state(tmp_path):
    """The PDHG warm-start cache survives a warm restart, and a demoted
    DeviceLP ladder stays demoted in the same clock domain, its window
    still expiring into the half-open probe."""
    def case(m, d):
        clk = [1000.0]
        path = _snap(d)
        clock = lambda: clk[0]
        op, mgr = stack(m, clock, path, ("WarmRestart", "DeviceLP"))
        lh = mgr.controllers["provisioning"].lp_health
        assert lh is not None
        m.lpsolve.reset_caches()
        m.lpsolve._warm_put("lpguide:master", (4, 2, 3),
                            np.ones(4), np.ones(2), np.ones(3))
        lh.report_failure("device_lp", "cap")
        lh.report_failure("device_lp", "cap")
        assert lh.active_rung("device_lp") == "highs"
        assert m.snapshot.write_snapshot(path, op, mgr)
        m.lpsolve.reset_caches()
        op2, mgr2 = stack(m, clock, path, ("WarmRestart", "DeviceLP"))
        assert m.snapshot.restore_snapshot(path, op2, mgr2) == "restored"
        lh2 = mgr2.controllers["provisioning"].lp_health
        assert lh2.snapshot_state() == lh.snapshot_state()
        assert lh2.active_rung("device_lp") == "highs"
        assert m.lpsolve.warm_cache_len() == 1
        ent = m.lpsolve._warm_get("lpguide:master", (4, 2, 3))
        assert ent is not None and np.allclose(ent["x"], 1.0)
        clk[0] += 61.0
        assert lh2.active_rung("device_lp") == "device_lp"
        op3, mgr3 = stack(m, clock, path, ("WarmRestart",))
        assert mgr3.controllers["provisioning"].lp_health is None
        assert m.snapshot.restore_snapshot(path, op3, mgr3) == "restored"
        m.lpsolve.reset_caches()
        return lh.snapshot_state()
    both(case, tmp_path)


def test_restart_mid_chaos_storm_converges(tmp_path):
    """Random interruptions and ICE for a while, snapshot, drop every
    object, restore a successor over the same cloud and keep the storm
    going: the successor converges to all-bound with no leaked instance."""
    def case(m, d):
        clk = [10_000.0]
        path = _snap(d)
        clock = lambda: clk[0]
        op, mgr = stack(m, clock, path, ("WarmRestart",))
        R = m.resources
        rng = np.random.default_rng(7)
        op.cluster.add_pods([
            m.objects.Pod(requests=R.ResourceList(
                {R.CPU: int(rng.integers(200, 3000)),
                 R.MEMORY: int(rng.integers(256, 4096)) * 2**20}))
            for _ in range(20)])
        for _ in range(40):
            clk[0] += rng.uniform(2.0, 12.0)
            running = op.cloud.running()
            roll = rng.random()
            if running and roll < 0.2:
                op.cloud.interrupt(
                    running[int(rng.integers(len(running)))].id)
            elif roll < 0.35:
                it = op.catalog[int(rng.integers(len(op.catalog)))]
                o = it.offerings[int(rng.integers(len(it.offerings)))]
                op.unavailable.mark_unavailable("chaos", it.name, o.zone,
                                                o.capacity_type)
            mgr.tick()
        assert m.snapshot.write_snapshot(path, op, mgr)
        op2, mgr2 = stack(m, clock, path, ("WarmRestart",),
                          cloud=op.raw_cloud)
        assert m.snapshot.restore_snapshot(path, op2, mgr2) == "restored"
        for _ in range(30):
            clk[0] += rng.uniform(2.0, 12.0)
            running = op2.cloud.running()
            if running and rng.random() < 0.15:
                op2.cloud.interrupt(
                    running[int(rng.integers(len(running)))].id)
            mgr2.tick()
        for _ in range(40):
            clk[0] += 5.0
            mgr2.tick()
        assert not op2.cluster.pending_pods()
        known = {n.provider_id for n in op2.cluster.nodes.values()}
        running = sorted(i.id for i in op2.cloud.running())
        assert all(i in known for i in running)
        return sorted(op2.cluster.nodes), running
    both(case, tmp_path)


# ---------------------------------------------------------------------------
# manager wiring: cadence, SIGTERM hook, gate-off inertness
# ---------------------------------------------------------------------------

def test_cadence_writes_and_stop_writes_final(tmp_path):
    def case(m, d):
        clk = [1000.0]
        path = _snap(d)
        op, mgr = provisioned_stack(m, clk, path, gates=("WarmRestart",))
        mgr._snapshotter.interval_s = 5.0
        assert os.path.exists(path)  # the first tick past -inf wrote one
        size = os.path.getsize(path)
        clk[0] += 6.0
        mgr.tick()
        assert os.path.getsize(path) >= size
        op.cluster.add_pods([pod(m, name="final-proof")])
        mgr.stop()
        sections, reason = m.snapshot.load_sections(path)
        assert reason == "ok"
        assert any(p.name == "final-proof"
                   for p in sections["cluster"]["pods"].values())
        return sorted(p.name for p in sections["cluster"]["pods"].values())
    both(case, tmp_path)


def test_gate_off_never_writes(tmp_path):
    def case(m, d):
        clk = [1000.0]
        path = _snap(d)
        op, mgr = provisioned_stack(m, clk, path, gates=())
        assert mgr._snapshotter is None
        clk[0] += 100.0
        mgr.tick()
        mgr.stop()
        return os.path.exists(path)
    assert both(case, tmp_path) is False


def test_atomic_write_leaves_no_tmp(tmp_path):
    def case(m, d):
        clk = [1000.0]
        path = _snap(d)
        op, mgr = provisioned_stack(m, clk, path)
        assert m.snapshot.write_snapshot(path, op, mgr)
        return os.path.exists(path + ".tmp")
    assert both(case, tmp_path) is False


# ---------------------------------------------------------------------------
# the kill -9 acceptance test: plan-stream parity across a hard death
# ---------------------------------------------------------------------------

_CHILD = r"""
import json, os, signal, sys
sys.path.insert(0, {repo!r})
from {pkg}.operator import (ControllerManager, Operator, Options,
                            build_controllers)
from {pkg}.api.objects import Pod
from {pkg}.api.resources import CPU, MEMORY, ResourceList
from {pkg}.catalog.generate import generate_catalog
from {pkg}.cloud.fake import ImageInfo, SecurityGroupInfo, SubnetInfo
from {pkg}.state.snapshot import restore_snapshot, write_snapshot

snap, plan, total = sys.argv[1], sys.argv[2], int(sys.argv[3])
kill_after = int(sys.argv[4]) if len(sys.argv) > 4 else -1
resume = kill_after < 0 and os.path.exists(plan) and \
    os.path.getsize(plan) > 0

start_tick = 0
if resume:
    with open(plan) as fh:
        start_tick = sum(1 for _ in fh)

clk = [1000.0 + 1.1 * start_tick]
opts = Options(snapshot_path=snap)
opts.feature_gates.update({{"WarmRestart": True, "IngestBatch": True}})
op = Operator(opts, catalog=generate_catalog(10), clock=lambda: clk[0],
              **{extra!r})
op.cloud.subnets = [SubnetInfo("s-a", "zone-a", 10_000, {{}}),
                    SubnetInfo("s-b", "zone-b", 10_000, {{}})]
op.cloud.security_groups = [SecurityGroupInfo("sg", "nodes", {{}})]
op.cloud.images = [ImageInfo("img-1", "std", "amd64", 1.0)]
op.params.parameters = {{
    "/karpenter-tpu/images/standard/1.28/amd64/latest": "img-1"}}
mgr = ControllerManager(op, build_controllers(op), clock=lambda: clk[0])

cold = [0]
if resume:
    outcome = restore_snapshot(snap, op, mgr)
    assert outcome == "restored", outcome
    orig = type(op.cluster).tensorize_nodes
    def counting(self, *a, **k):
        cold[0] += 1
        return orig(self, *a, **k)
    type(op.cluster).tensorize_nodes = counting

for k in range(start_tick, total):
    clk[0] = 1000.0 + 1.1 * (k + 1)
    if k % 3 == 0:
        op.cluster.add_pods([
            Pod(name=f"p-{{k}}-{{i}}",
                requests=ResourceList({{CPU: 500, MEMORY: 512 * 2**20}}))
            for i in range(2)])
    mgr.tick()
    if resume and k == start_tick:
        type(op.cluster).tensorize_nodes = orig
        print(f"COLD_TENSORIZE {{cold[0]}}", flush=True)
    line = {{"k": k,
             "nodes": sorted(op.cluster.nodes),
             "bound": sorted(p.name for p in op.cluster.pods.values()
                             if p.node_name),
             "running": sorted(i.id for i in op.cloud.running())}}
    with open(plan, "a") as fh:
        fh.write(json.dumps(line, sort_keys=True) + "\n")
    assert write_snapshot(snap, op, mgr)
    if k == kill_after:
        os.kill(os.getpid(), signal.SIGKILL)
print("DONE", flush=True)
"""


def child_env():
    return dict(os.environ, JAX_PLATFORMS="cpu")


@pytest.mark.scale
def test_kill_9_resume_plan_parity(tmp_path):
    """Run the deterministic driver uninterrupted; run it again but SIGKILL
    the process mid-run and resume a successor from the snapshot.  In each
    package the concatenated plan stream is byte-identical to the
    uninterrupted one, and the resumed first tick does not re-tensorize
    (COLD_TENSORIZE 0); the two packages' streams are equal too."""
    total, kill_at = 12, 4

    def case(m, d):
        child = d / "child.py"
        child.write_text(_CHILD.format(repo=REPO, pkg=m.name,
                                       extra=m.extra))

        def run(snap, plan, kill=-1):
            return subprocess.run(
                [sys.executable, str(child), str(snap), str(plan),
                 str(total), str(kill)],
                capture_output=True, text=True, env=child_env(),
                timeout=300)

        pa = d / "plan_a.jsonl"
        proc = run(d / "snap_a.bin", pa)
        assert proc.returncode == 0, proc.stderr
        assert "DONE" in proc.stdout
        sb, pb = d / "snap_b.bin", d / "plan_b.jsonl"
        proc = run(sb, pb, kill=kill_at)
        assert proc.returncode == -signal.SIGKILL
        assert len(pb.read_text().splitlines()) == kill_at + 1
        proc = run(sb, pb)
        assert proc.returncode == 0, proc.stderr
        assert "COLD_TENSORIZE 0" in proc.stdout
        assert "DONE" in proc.stdout
        assert pa.read_text() == pb.read_text(), (
            "plan stream diverged across kill -9 + warm restore")
        last = json.loads(pa.read_text().splitlines()[-1])
        assert last["nodes"] and last["bound"] and last["running"]
        return pa.read_text()
    both(case, tmp_path)


# ---------------------------------------------------------------------------
# the port's own: section digests, host data only, class tokens, the cell
# ---------------------------------------------------------------------------

def _plain(x):
    """A section value as plain comparable data: numpy arrays as (dtype,
    shape, values), objects as their class name and fields."""
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), list(x.shape), x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, dict):
        return {_key(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted((_plain(v) for v in x), key=repr)
    return x


def _key(k):
    return repr(_plain(k)) if not isinstance(k, (str, int, float)) else k


def _sections_digest(sections):
    """The plain content both packages' sections must agree on: names,
    bindings, counters, epochs, the supervisors and the LP caches' keys
    and arrays."""
    cl = sections["cluster"]
    nodes = {name: sorted(p.name for p in n.pods)
             for name, n in cl["nodes"].items()}
    pods = {p.name: p.node_name for p in cl["pods"].values()}
    claims = sorted((c.name, c.provider_id, c.instance_type)
                    for c in cl["nodeclaims"].values())
    arena = sections["arena"]
    counters = {k: v for k, v in sections["counters"].items()
                if k != "fleet_ids"}
    meta = {k: v for k, v in sections["meta"].items() if k != "written_at"}
    return dict(
        nodes=nodes, pods=pods, claims=claims, counters=counters, meta=meta,
        arena=dict(slot_of=arena["slot_of"], top=arena["top"],
                   epoch=arena["epoch"],
                   used=_plain(arena["slab_used"]),
                   alloc=_plain(arena["slab_alloc"]),
                   live=_plain(arena["slab_live"])),
        instances=sorted(sections["cloud"]["instances"]),
        next_id=sections["cloud"]["next_id"],
        supervisors=sections["supervisors"],
        manager=sections["manager"],
        health=sections.get("health"),
        leader=sections.get("leader"),
        # the stale cache's entries carry a host monotonic stamp: every
        # field but that one
        lpguide={name: _plain({k: {f: v for f, v in e.items()
                                   if f != "stamp"}
                               if name == "stale" else e
                               for k, e in cache.items()})
                 for name, cache in sections["lpguide"].items()},
        lpsolve=_plain(sections["lpsolve"]))


def test_collect_sections_digest_equals_the_reference(tmp_path):
    """The same ticks on both packages give sections of the same plain
    content, the guided solve's LP mix cache (keys and arrays) included."""
    def case(m, d):
        clk = [1000.0]
        op, mgr = stack(m, lambda: clk[0], _snap(d), ("WarmRestart",))
        # two classes, 320 pods (past the small-batch packer) on an empty
        # cluster: the guided solve runs its LP and caches the mix
        op.cluster.add_pods([pod(m, cpu=c) for c in (500, 1500) * 160])
        mgr.tick()
        clk[0] += 1.1
        mgr.tick()
        op.cluster.add_pods([pod(m, cpu=3900) for _ in range(3)])
        clk[0] += 15.0
        mgr.tick()
        clk[0] += 1.1
        mgr.tick()
        sections = m.snapshot.collect_sections(op, mgr)
        digest = _sections_digest(sections)
        assert digest["lpguide"]["mix"], "the guided solve cached no mix"
        return json.loads(json.dumps(digest, sort_keys=True, default=repr))
    both(case, tmp_path)


def test_sections_hold_no_tensor_and_load_on_the_cpu(tmp_path):
    """Every section of the port's snapshot is host data: no torch tensor
    anywhere in it (a CUDA tensor pickles with its device and does not load
    where there is no card), and the file loads again."""
    clk = [1000.0]
    path = _snap(tmp_path)
    reset_counters(PORT)
    op, mgr = provisioned_stack(PORT, clk, path,
                                gates=("WarmRestart", "DeviceLP",
                                       "Forecast", "GangScheduling"))
    sections = PORT.snapshot.collect_sections(op, mgr)
    types = object_types(sections)
    assert not [t for t in types if t.startswith("torch.")], types
    assert {"series", "gang", "lp_health", "leader"} <= set(sections)
    assert PORT.snapshot.write_snapshot(path, op, mgr)
    loaded, reason = PORT.snapshot.load_sections(path)
    assert reason == "ok"
    assert not [t for t in object_types(loaded) if t.startswith("torch.")]


_TOKENS_CHILD = r"""
import json, sys
sys.path.insert(0, {repo!r})
from karpenter_tpu_torch.api.objects import Pod
from karpenter_tpu_torch.api.resources import CPU, MEMORY, ResourceList
from karpenter_tpu_torch.catalog.generate import generate_catalog
from karpenter_tpu_torch.cloud.fake import (ImageInfo, SecurityGroupInfo,
                                            SubnetInfo)
from karpenter_tpu_torch.operator import (ControllerManager, Operator,
                                          Options, build_controllers)
from karpenter_tpu_torch.ops import tensorize as tz
from karpenter_tpu_torch.state import snapshot

role, path, repair = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
if not repair:
    snapshot._drop_class_tokens = lambda pods: None

def pods(cpu, n, prefix):
    return [Pod(name=f"{{prefix}}-{{i}}",
                requests=ResourceList({{CPU: cpu, MEMORY: 512 * 2**20}}))
            for i in range(n)]

def operator():
    clk = [1000.0]
    op = Operator(Options(), catalog=generate_catalog(10),
                  clock=lambda: clk[0], device="cpu")
    op.cloud.subnets = [SubnetInfo("s-a", "zone-a", 10_000, {{}})]
    op.cloud.security_groups = [SecurityGroupInfo("sg", "nodes", {{}})]
    op.cloud.images = [ImageInfo("img-1", "std", "amd64", 1.0)]
    return op, ControllerManager(op, build_controllers(op),
                                 clock=lambda: clk[0])

def classes(batch):
    # the class id each pod gets as tensorize interns it, renumbered by
    # first appearance, beside the grouping by content key
    table, gen = tz._CLASS_TABLE
    ids = [tz._class_id(p, table, gen) for p in batch]
    by_id, by_key = {{}}, {{}}
    return ([by_id.setdefault(int(c), len(by_id)) for c in ids],
            [by_key.setdefault(tz._class_key(p), len(by_key))
             for p in batch])

if role == "write":
    op, mgr = operator()
    # the dead process meets class A (600m) first, then class B (900m)
    op.cluster.add_pods(pods(600, 3, "a") + pods(900, 3, "b"))
    classes(list(op.cluster.pods.values()))
    assert snapshot.write_snapshot(path, op, mgr)
else:
    op, mgr = operator()
    # the successor meets class C (1200m) and then B before the restore,
    # so its first id names another class than the dead process's did
    classes(pods(1200, 2, "c") + pods(900, 2, "b2"))
    assert snapshot.restore_snapshot(path, op, mgr) == "restored"
    batch = list(op.cluster.pods.values()) + pods(1200, 2, "c2")
    by_id, by_key = classes(batch)
    print(json.dumps({{"by_id": by_id, "by_key": by_key}}), flush=True)
"""


def _run_tokens_child(tmp_path, repair):
    child = tmp_path / "tokens.py"
    child.write_text(_TOKENS_CHILD.format(repo=REPO))
    path = tmp_path / f"tokens-{repair}.bin"
    out = []
    for role in ("write", "read"):
        proc = subprocess.run(
            [sys.executable, str(child), role, str(path), str(int(repair))],
            capture_output=True, text=True, env=child_env(), timeout=300)
        assert proc.returncode == 0, proc.stderr
        out.append(proc.stdout)
    return json.loads(out[1].strip().splitlines()[-1])


def test_restored_class_tokens_do_not_collide(tmp_path):
    """A restored pod's interned class id (`_cid`, ops/tensorize.py) was
    minted by the dead process, whose generation counter started at 0 as
    the successor's did: without the repair the successor reads it as
    current and merges pods of different classes.  With it the restored
    pods re-intern by content, and the grouping by id equals the grouping
    by content key."""
    got = _run_tokens_child(tmp_path, repair=True)
    assert got["by_id"] == got["by_key"]
    assert len(set(got["by_key"])) == 3


def test_restored_class_tokens_collide_without_the_repair(tmp_path):
    """The same two processes with the repair patched out: the grouping by
    id disagrees with the content keys — what the repair prevents."""
    got = _run_tokens_child(tmp_path, repair=False)
    assert got["by_id"] != got["by_key"]


CELL_PODS = 5000     # the operator cell's first burst, cut to this size
CELL_ROUND2 = 2000   # its second


def _cell(m, d, restore):
    """A 5000 + 2000-pod copy of the operator cell
    (`workloads.operator_env`, 600 types): round 1, a snapshot, then round
    2 and the disruption tick — in the same operator, or (with `restore`)
    in a successor built anew, with its counters and LP caches as a fresh
    process has them, that restores the file first.  Returns the
    signatures and the count of tensorize_nodes calls in round 2 (the
    successor's first solve)."""
    from types import SimpleNamespace
    from karpenter_tpu_torch import workloads
    if m is REF:
        import bench
        build_pods = bench.build_pods
    else:
        build_pods = workloads.build_pods
    kit = SimpleNamespace(
        Operator=m.operator.Operator, Options=m.operator.Options,
        build_controllers=m.operator.build_controllers,
        SubnetInfo=m.fake.SubnetInfo,
        SecurityGroupInfo=m.fake.SecurityGroupInfo,
        ImageInfo=m.fake.ImageInfo)
    rounds = [(dict(workloads.HEADLINE, total=CELL_PODS),
               workloads.HEADLINE_SEED),
              (dict(workloads.PROVISION_ROUND2, total=CELL_ROUND2),
               workloads.PROVISION_ROUND2_SEED)]
    reset_counters(m)
    clear_lp_caches(m.name)
    env = workloads.operator_env(kit, **m.extra)
    (kw, seed), = rounds[:1]
    env.op.cluster.add_pods(build_pods(rng=np.random.default_rng(seed), **kw))
    sig1, _ = workloads.provision_pending(env.provision_env())
    path = str(d / f"cell-{int(restore)}.bin")
    assert m.snapshot.write_snapshot(path, env.op)
    if restore:
        reset_counters(m)
        clear_lp_caches(m.name)
        env = workloads.operator_env(kit, **m.extra)
        assert m.snapshot.restore_snapshot(path, env.op) == "restored"
    counted = []

    def provision(penv):
        calls, undo = _count_tensorize(m)
        try:
            return workloads.provision_pending(penv)
        finally:
            undo()
            counted.append(calls[0])
    got = workloads.operator_replay(env, build_pods, provision=provision,
                                    rounds=rounds[1:])
    return dict(rounds=[sig1] + got["rounds"], tick=got["tick"]), counted[0]


def test_operator_cell_copy_restores_to_the_uninterrupted_plan(tmp_path):
    """The operator cell (`Operator(Options())`, 600 types) cut to 5000 +
    2000 pods: round 1, a snapshot, then round 2 and the disruption tick in
    the same operator and in a successor restored from the file.  In each
    package the restored signatures equal the uninterrupted ones and the
    successor's round 2 runs no tensorize_nodes (its gather is warm); the
    two packages' signatures are equal."""
    out = {}
    for m in (REF, PORT):
        solo, _ = _cell(m, tmp_path, restore=False)
        restored, cold = _cell(m, tmp_path, restore=True)
        assert restored == solo, m.name
        assert cold == 0, m.name
        assert solo["rounds"][1]["bound_existing"] > 0
        out[m.name] = solo
    assert out[REF.name] == out[PORT.name]
