"""The port's consolidation decision against the JAX package's, end to end.

Fleets are built by the JAX package's own Provisioner, as
tests/test_consolidation_sweep.py builds them, and carried across with
`convert.cluster_from_objects` (the catalog with `convert.catalog_from_objects`),
so both DisruptionControllers decide on identical clusters.  The port runs
on the CPU (`device="cpu"`: the kernels' plain versions).  Candidates, the
arena's sweep rows and the chosen action must be identical; sweep launch
costs may differ by relative 1e-5 (float32 sums in another order).

The full-width goldens of `workloads.consolidation_fleet()` — 500
under-utilized nodes, BASELINE config 4 — are produced here by the JAX
package and reproduced by the port; `chip_smoke.py` checks them on the card."""

import numpy as np
import pytest
import torch

from karpenter_tpu.api.objects import PodDisruptionBudget as RefPDB
from karpenter_tpu.api import labels as ref_wk
from karpenter_tpu.controllers import disruption as ref_dmod
from karpenter_tpu.controllers.disruption import \
    DisruptionController as RefController
from helpers import cpu_pod, make_type
from karpenter_tpu_torch import convert, workloads
from karpenter_tpu_torch.api.objects import Disruption, NodePool, Pod
from karpenter_tpu_torch.api.resources import CPU, MEMORY, ResourceList
from karpenter_tpu_torch.controllers import disruption as port_dmod
from karpenter_tpu_torch.controllers.disruption import DisruptionController
from karpenter_tpu_torch.ops import classpack_kernels as ck
from test_consolidation_sweep import build_underutilized, env, provision
from torch_cases import fleet_to_reference, one_torch_thread  # noqa: F401

REL_TOL = 1e-5

SPOT_CATALOG = lambda: [make_type("a.small", 2, 4, 0.10),  # noqa: E731
                        make_type("a.medium", 4, 8, 0.20),
                        make_type("a.large", 8, 16, 0.40),
                        make_type("s.small", 2, 4, 0.12, spot_discount=0.4)]


def port_twin(provider, cluster, ref_ctrl, batched=True):
    """The port's controller over a copy of the reference's cluster, pools,
    catalog and clock."""
    pools = [NodePool(name=p.name, weight=p.weight,
                      disruption=Disruption(**vars(p.disruption)))
             for p in ref_ctrl.nodepools.values()]
    tprov = workloads.CatalogProvider(
        convert.catalog_from_objects(provider.get_instance_types()))
    return DisruptionController(
        tprov, convert.cluster_from_objects(cluster), pools,
        clock=ref_ctrl.clock, stabilization_s=ref_ctrl.stabilization_s,
        lp_guide=ref_ctrl.lp_guide, batched_sweep=batched, device="cpu")


def ref_fleet(seed, catalog=None):
    clock, cloud, provider, cluster, prov, ctrl = env(catalog=catalog)
    build_underutilized(cluster, prov, np.random.default_rng(seed))
    return provider, cluster, ctrl


def _same_sweep(got, want):
    np.testing.assert_array_equal(got.new_nodes, want.new_nodes)
    np.testing.assert_array_equal(got.unschedulable, want.unschedulable)
    np.testing.assert_allclose(got.total_price, want.total_price,
                               rtol=REL_TOL, atol=1e-12)
    assert got.device_calls == want.device_calls


# ---- the cluster carried across ----

def test_cluster_from_objects_carries_the_state():
    provider, cluster, ctrl = ref_fleet(7)
    cluster.add_pdb(RefPDB(selector={"app": "web"}, max_unavailable=1))
    t = convert.cluster_from_objects(cluster)
    assert list(t.nodes) == list(cluster.nodes)
    assert list(t.pods) == list(cluster.pods)
    assert list(t.nodeclaims) == list(cluster.nodeclaims)
    assert t.mutation_epoch == cluster.mutation_epoch
    assert t.pdbs[next(iter(cluster.pdbs))].max_unavailable == 1
    for name, n in cluster.nodes.items():
        tn = t.nodes[name]
        assert (tn.labels, tn.price, tn.created_at, tn.zone) == \
            (n.labels, n.price, n.created_at, n.zone)
        assert dict(tn.allocatable) == dict(n.allocatable)
        assert [p.uid for p in tn.pods] == [p.uid for p in n.pods]
        # one pod object per uid, shared by the pod dict and the node
        assert all(p is t.pods[p.uid] for p in tn.pods)
    claim = next(iter(cluster.nodeclaims.values()))
    tc = t.nodeclaims[claim.name]
    assert (tc.provider_id, tc.instance_type, tc.price) == \
        (claim.provider_id, claim.instance_type, claim.price)
    assert repr(tc.requirements) == repr(claim.requirements)


def test_mutation_epoch_bumps_like_the_reference():
    """The arena's staleness guard and the fingerprint cache read the
    epoch: the same mutator sequence must bump it identically."""
    provider, ref, ctrl = ref_fleet(1)
    port = convert.cluster_from_objects(ref)
    node = next(iter(ref.nodes))
    for c, mk in ((ref, lambda: cpu_pod()),
                  (port, lambda: Pod(requests=ResourceList(
                      {CPU: 500, MEMORY: 512 * 2**20})))):
        p = c.add_pod(mk())
        c.bind_pod(p, node)
        c.unbind_pod(p)
        c.bind_pod(p, node)
        c.touch_node(c.nodes[node])
        c.delete_pod(p)
        c.remove_node(node)
        c.remove_node("no-such-node")
    assert port.mutation_epoch == ref.mutation_epoch


# ---- candidates, sweep rows and the chosen action ----

@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_candidates_and_sweep_rows_match_reference(seed):
    provider, cluster, ctrl = ref_fleet(seed + 7)
    tctrl = port_twin(provider, cluster, ctrl)
    cands, tcands = ctrl.candidates(), tctrl.candidates()
    assert [c.name for c in tcands] == [c.name for c in cands]
    assert [c.disruption_cost for c in tcands] == \
        [c.disruption_cost for c in cands]
    arena, tarena = ctrl._arena_for(cands), tctrl._arena_for(tcands)
    _same_sweep(tarena.sweep_prefixes(), arena.sweep_prefixes())
    _same_sweep(tarena.sweep_singles(), arena.sweep_singles())
    ks = [len(cands), 1]
    _same_sweep(tarena.sweep_prefix_subset(ks), arena.sweep_prefix_subset(ks))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_consolidation_action_matches_reference(seed):
    provider, cluster, ctrl = ref_fleet(seed, catalog=SPOT_CATALOG())
    tctrl = port_twin(provider, cluster, ctrl)
    tseq = port_twin(provider, cluster, ctrl, batched=False)
    want = workloads.action_signature(
        ctrl.consolidation_action(ctrl.candidates()))
    got = tctrl.consolidation_action(tctrl.candidates())
    assert workloads.action_signature(got) == want
    # the port's batched controller equals its own sequential oracle
    assert workloads.action_signature(
        tseq.consolidation_action(tseq.candidates())) == want
    if got is not None:
        assert got.simulation is not None and not got.simulation.unschedulable


@pytest.mark.parametrize("big_type", [
    make_type("a.large", 8, 16, 0.40),                       # on-demand → spot
    make_type("s.large", 8, 16, 0.45, spot_discount=0.5),    # spot → spot
])
def test_replace_actions_match_reference(big_type):
    """A lone big node left holding one small pod cannot be deleted, so the
    single-node pass replaces it with a cheaper node: the replace face of
    the sweep launches, and a spot candidate meets the flexibility floor.
    With no survivor the decoded accept is a fresh solve, which the LP
    guide would take, so both controllers run with the reference's LPGuide
    escape hatch, lp_guide=False (the guided replacement is
    tests/test_torch_lpguide.py's)."""
    catalog = [make_type("a.small", 2, 4, 0.10), big_type,
               make_type("s.small", 2, 4, 0.12, spot_discount=0.4)]
    clock, cloud, provider, cluster, prov, ctrl = env(catalog=catalog)
    big = cpu_pod(cpu_m=6000, mem_mib=4000)
    provision(cluster, prov, [big])
    cluster.add_pods([cpu_pod(cpu_m=1000, mem_mib=1000)])
    prov.provision()
    cluster.delete_pod(big)
    assert len(cluster.nodes) == 1
    ctrl = RefController(provider, cluster, ctrl.nodepools, clock=clock,
                         stabilization_s=0.0, lp_guide=False)
    tctrl = port_twin(provider, cluster, ctrl)
    tseq = port_twin(provider, cluster, ctrl, batched=False)
    cands = tctrl.candidates()
    screen = tctrl._arena_for(cands).sweep_singles()
    assert screen.new_nodes.tolist() == [1] and screen.total_price[0] > 0
    want = ctrl.consolidation_action(ctrl.candidates())
    got = tctrl.consolidation_action(cands)
    assert workloads.action_signature(got) == \
        workloads.action_signature(want) == \
        workloads.action_signature(tseq.consolidation_action(
            tseq.candidates()))
    assert got.kind == "replace"
    assert got.simulation.total_price == pytest.approx(
        want.simulation.total_price)
    assert [a.instance_type for a in got.simulation.nodes[0].alternatives] \
        == [a.instance_type for a in want.simulation.nodes[0].alternatives]


def test_pdb_union_budgets_match_reference():
    """Per-node PDB checks pass but the union must fail at some prefix:
    the incremental prefix evictability, the sweep verdicts and the action
    agree with the reference (tests/test_consolidation_sweep.py's case)."""
    zones = ("zone-a", "zone-b", "zone-c")
    catalog = [make_type("a.small", 2, 4, 0.10, zones=zones),
               make_type("a.large", 8, 16, 0.40, zones=zones)]
    clock, cloud, provider, cluster, prov, ctrl = env(catalog=catalog)
    provision(cluster, prov, [cpu_pod(cpu_m=6000, mem_mib=8000)])
    provision(cluster, prov, [
        cpu_pod(cpu_m=1500, mem_mib=2000, labels={"app": "web"},
                node_selector={ref_wk.ZONE: z}) for z in ("zone-b", "zone-c")])
    cluster.add_pdb(RefPDB(selector={"app": "web"}, max_unavailable=1))
    tctrl = port_twin(provider, cluster, ctrl)
    cands, tcands = ctrl.candidates(), tctrl.candidates()
    assert [c.name for c in tcands] == [c.name for c in cands]
    assert len(cands) >= 2
    evict_ok = tctrl._prefix_evictable(tcands)
    assert evict_ok == ctrl._prefix_evictable(cands)
    assert not all(evict_ok)
    for k in range(len(tcands) + 1):
        union = [p for c in tcands[:k] for p in c.reschedulable]
        assert evict_ok[k] == tctrl.cluster.evictable(union)
    got = tctrl.consolidation_action(tcands)
    assert workloads.action_signature(got) == workloads.action_signature(
        ctrl.consolidation_action(cands))
    if got is not None:
        assert sum(p.labels.get("app") == "web" for c in got.candidates
                   for p in c.reschedulable) <= 1


def test_decode_audit_rejection_matches_reference(monkeypatch):
    """When the batch-topology audit rejects the aggregate winner, both
    packages fall back identically (decoded binary search over the rest)."""
    provider, cluster, ctrl = ref_fleet(3)
    tctrl = port_twin(provider, cluster, ctrl)
    tseq = port_twin(provider, cluster, ctrl, batched=False)

    def reject_big(problem, result, node_list):
        # reject any decoded solve rescheduling >= 3 pods
        return {0} if len(problem.pods) >= 3 else set()

    monkeypatch.setattr(ref_dmod, "find_batch_topology_violations", reject_big)
    monkeypatch.setattr(port_dmod, "find_batch_topology_violations",
                        reject_big)
    want = workloads.action_signature(
        ctrl.consolidation_action(ctrl.candidates()))
    got = tctrl.consolidation_action(tctrl.candidates())
    assert workloads.action_signature(got) == want
    assert workloads.action_signature(
        tseq.consolidation_action(tseq.candidates())) == want
    if got is not None and got.kind == "delete":
        assert sum(len(c.reschedulable) for c in got.candidates) < 3


def test_blocked_candidates_publish_unconsolidatable_events():
    provider, cluster, ctrl = ref_fleet(2)
    node = next(n for n in cluster.nodes.values() if n.pods)
    node.pods[0].annotations[node.pods[0].DO_NOT_DISRUPT] = "true"
    tctrl = port_twin(provider, cluster, ctrl)
    names = [c.name for c in tctrl.candidates()]
    assert names == [c.name for c in ctrl.candidates()]
    assert node.name not in names
    ev = tctrl.recorder.events("Unconsolidatable")
    assert [(e.name, e.message) for e in ev] == \
        [(e.name, e.message) for e in ctrl.recorder.events("Unconsolidatable")]


def test_arena_is_cached_and_goes_stale_on_mutation():
    provider, cluster, ctrl = ref_fleet(5)
    tctrl = port_twin(provider, cluster, ctrl)
    cands = tctrl.candidates()
    arena = tctrl._arena_for(cands)
    assert tctrl._arena_for(cands) is arena
    side = arena.delete_side
    assert arena.delete_side is side
    victim = next(iter(tctrl.cluster.pods.values()))
    tctrl.cluster.delete_pod(victim)
    assert arena.delete_side is not side          # the epoch moved
    assert tctrl._arena_for(tctrl.candidates()) is not arena


# ---- the full-width cell: BASELINE config 4, 500 under-utilized nodes ----

@pytest.fixture(scope="module")
def fleet_shape():
    f = workloads.consolidation_fleet()
    return f, workloads.consolidation_fleet()


def test_consolidation_fleet_is_seeded_and_underutilized(fleet_shape):
    f, again = fleet_shape
    nodes = list(f.cluster.nodes.values())
    assert [n.name for n in nodes] == [f"node-{i:04d}" for i in range(500)]
    assert [(n.instance_type, n.zone, n.capacity_type, len(n.pods))
            for n in nodes] == \
        [(n.instance_type, n.zone, n.capacity_type, len(n.pods))
         for n in again.cluster.nodes.values()]
    cpu_m = {it.name: it.info.cpu_m for it in f.provider.get_instance_types()}
    assert {cpu_m[n.instance_type] for n in nodes} == {4000, 8000, 16000}
    for n in nodes:
        assert n.labels["kubernetes.io/hostname"] == n.name
        assert n.provider_id and n.created_at == 0.0
        assert n.requested().fits(n.allocatable)
    used = sum(int(n.requested()[CPU]) for n in nodes)
    alloc = sum(int(n.allocatable[CPU]) for n in nodes)
    assert 0.15 < used / alloc < 0.4
    assert sum(1 for n in nodes if not n.pods) > 100   # > max_candidates


@pytest.mark.parametrize("n_cands", workloads.CONSOLIDATION_SHAPES)
def test_reference_produces_the_consolidation_goldens(n_cands):
    provider, cluster, pools, clock = fleet_to_reference(
        workloads.consolidation_fleet())
    ctrl = RefController(provider, cluster, pools, clock=clock,
                         max_candidates=n_cands)
    cands = ctrl.candidates()
    assert len(cands) == n_cands
    action = ctrl.consolidation_action(cands)
    arena = ctrl._arena_for(cands)
    got = workloads.consolidation_digests(action, arena.sweep_prefixes(),
                                          arena.sweep_singles())
    _assert_golden(got, workloads.GOLDEN_CONSOLIDATION[n_cands])


@pytest.mark.parametrize("n_cands", workloads.CONSOLIDATION_SHAPES)
def test_port_reproduces_the_consolidation_goldens(n_cands):
    f = workloads.consolidation_fleet()
    ctrl = DisruptionController(f.provider, f.cluster, f.pools,
                                clock=f.clock, max_candidates=n_cands,
                                device="cpu")
    cands = ctrl.candidates()
    action = ctrl.consolidation_action(cands)
    arena = ctrl._arena_for(cands)
    got = workloads.consolidation_digests(action, arena.sweep_prefixes(),
                                          arena.sweep_singles())
    _assert_golden(got, workloads.GOLDEN_CONSOLIDATION[n_cands])
    assert action is not None and action.kind == "delete"


def test_reference_produces_the_launch_sweep_golden():
    """A replace-face sweep whose rows launch new nodes (the goldens above
    launch none): the JAX package's solve_classpack_sweep on
    `launch_probes` of the 500-candidate arena."""
    from karpenter_tpu.ops.classpack import solve_classpack_sweep
    provider, cluster, pools, clock = fleet_to_reference(
        workloads.consolidation_fleet())
    ctrl = RefController(provider, cluster, pools, clock=clock,
                         max_candidates=500)
    problem, counts, kw = workloads.launch_probes(
        ctrl._arena_for(ctrl.candidates()))
    res = solve_classpack_sweep(problem, counts, **kw)
    assert res.new_nodes.sum() > 0 and (res.total_price > 0).any()
    _assert_sweep_golden(workloads.sweep_digest(res))


def test_port_reproduces_the_launch_sweep_golden():
    from karpenter_tpu_torch.ops.classpack import solve_classpack_sweep
    f = workloads.consolidation_fleet()
    ctrl = DisruptionController(f.provider, f.cluster, f.pools,
                                clock=f.clock, max_candidates=500,
                                device="cpu")
    problem, counts, kw = workloads.launch_probes(
        ctrl._arena_for(ctrl.candidates()))
    res = solve_classpack_sweep(problem, counts, device="cpu", **kw)
    assert res.device_calls == 1
    _assert_sweep_golden(workloads.sweep_digest(res))


def _assert_sweep_golden(got):
    gold = workloads.GOLDEN_LAUNCH_SWEEP
    assert got[0] == gold[0]
    assert got[1] == pytest.approx(gold[1], rel=REL_TOL)


def _assert_golden(got, gold):
    assert got["action"] == gold["action"]
    for face in ("prefixes", "singles"):
        assert got[face][0] == gold[face][0]
        assert got[face][1] == pytest.approx(gold[face][1], rel=REL_TOL,
                                             abs=1e-9)


# ---- the port's boundaries ----

def test_controller_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f = workloads.consolidation_fleet(n_nodes=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        DisruptionController(f.provider, f.cluster, f.pools, clock=f.clock)
    ctrl = DisruptionController(f.provider, f.cluster, f.pools,
                                clock=f.clock, device="cpu")
    from karpenter_tpu_torch.ops.tensorize import SimulationArena
    with pytest.raises(RuntimeError, match="CUDA"):
        SimulationArena(ctrl.candidates(), f.cluster,
                        f.provider.get_instance_types(), f.pools)


def test_cpu_decision_launches_no_kernel():
    f = workloads.consolidation_fleet(n_nodes=40)
    ck.reset_launches()
    ctrl = DisruptionController(f.provider, f.cluster, f.pools,
                                clock=f.clock, device="cpu")
    assert ctrl.consolidation_action(ctrl.candidates()) is not None
    assert all(v == 0 for v in ck.LAUNCHES.values())
