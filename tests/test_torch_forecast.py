"""The port's forecast subsystem (karpenter_tpu_torch/forecast/) against the
JAX package's, case by case with tests/test_forecast.py's 19 cases, on the
CPU.  Each case runs on both packages and returns plain observations that
must be equal: envelopes as raw float64 bytes (bit-equal), the demand
series' rings and means, the spot-risk prior's rates, the
HeadroomController's issued / expired / preempted placeholders (its
dry-run solve on the port's Provisioner, whose kernels run their plain
versions here), the disruption sweep's protected-by-TTL contract, and the
operator's Forecast gate wiring, the interruption controller's
`on_spot_reclaim` hook included.  The diurnal A/B replay stays `slow`, as
in the reference.
"""

import importlib
import itertools
import os
from types import SimpleNamespace

import numpy as np
import pytest

from helpers import small_catalog
from torch_cases import clear_lp_caches as clear_package_caches
from torch_cases import one_torch_thread  # noqa: F401
from karpenter_tpu_torch import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = dict(forecast="forecast", objects="api.objects",
               resources="api.resources", cloud="cloud",
               controllers="controllers", disruption="controllers.disruption",
               state="state", cluster_mod="state.cluster",
               queue="cloud.queue", operator="operator",
               gen="catalog.generate", sim="sim")


def _package(name, extra, catalog):
    return SimpleNamespace(name=name, extra=extra, catalog=catalog, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in MODULES.items()})


REF = _package("karpenter_tpu", {}, small_catalog)
PORT = _package("karpenter_tpu_torch", {"device": "cpu"},
                lambda: convert.catalog_from_objects(small_catalog()))


@pytest.fixture(autouse=True)
def _clean_caches():
    clear_package_caches("karpenter_tpu", "karpenter_tpu_torch")
    yield
    clear_package_caches("karpenter_tpu", "karpenter_tpu_torch")


def _reset(m):
    """Restart the package's object / node / message counters, so both
    sides name their pods and nodes alike."""
    m.objects._ids = itertools.count()
    m.cluster_mod._names = itertools.count(1)
    m.queue._msg_ids = itertools.count(1)


def both(case):
    _reset(REF)
    ref = case(REF)
    _reset(PORT)
    port = case(PORT)
    assert ref == port
    return port


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def step(self, dt):
        self.t += dt


def cpu_pod(m, cpu_m=500, mem_mib=512, **kw):
    R = m.resources
    return m.objects.Pod(requests=R.ResourceList(
        {R.CPU: cpu_m, R.MEMORY: mem_mib * 2**20}), **kw)


def headroom_pod(m, cls="web", cpu_m=500, mem_mib=512, expiry=2000.0,
                 name=None):
    f, R = m.forecast, m.resources
    name = name or f"headroom-{cls}-000001"
    return m.objects.Pod(
        name=name, uid=name,
        requests=R.ResourceList({R.CPU: cpu_m, R.MEMORY: mem_mib * 2**20}),
        labels={f.HEADROOM_LABEL: "true", f.HEADROOM_CLASS_LABEL: cls},
        annotations={f.HEADROOM_EXPIRY_ANNOTATION: f"{expiry:.3f}"},
        priority=-1000, owner_kind="")


def env(m, pools=None):
    O = m.objects
    clock = FakeClock()
    cloud = m.cloud.FakeCloud(clock)
    provider = m.cloud.CloudProvider(cloud, m.catalog(), clock=clock)
    cluster = m.state.Cluster(clock)
    pools = pools or [O.NodePool(disruption=O.Disruption(
        consolidation_policy="WhenUnderutilized"))]
    prov = m.controllers.Provisioner(provider, cluster, pools, clock=clock,
                                     **m.extra)
    return clock, cloud, provider, cluster, prov, pools


def envelope(env_):
    return (env_.steps, env_.mean.tobytes(), env_.upper.tobytes(),
            env_.lower.tobytes())


def pods_state(cluster):
    """Every pod by name: its node's launch position (or -1), labels and
    annotations — the cluster as the forecaster left it."""
    order = {n: i for i, n in enumerate(cluster.nodes)}
    return sorted((p.name, order.get(p.node_name, -1),
                   sorted(p.labels.items()), sorted(p.annotations.items()),
                   sorted(p.requests.items()), sorted(p.node_selector.items()))
                  for p in cluster.pods.values())


# ---------------------------------------------------------------------------
# forecasters
# ---------------------------------------------------------------------------

def test_ewma_converges_to_step_level():
    def case(m):
        f = m.forecast.EWMAForecaster(alpha=0.3)
        values = np.concatenate([np.zeros(10), np.full(60, 8.0)])
        env_ = f.forecast(values, steps=5, z=1.0)
        assert env_.steps == 5
        assert abs(env_.mean[0] - 8.0) < 0.1
        assert np.allclose(env_.mean, env_.mean[0])
        assert np.all(env_.upper >= env_.mean)
        assert np.all(env_.lower >= 0.0)
        return envelope(env_)
    both(case)


def test_ewma_empty_series_is_zero():
    def case(m):
        env_ = m.forecast.EWMAForecaster().forecast(np.array([]), steps=3)
        assert np.all(env_.mean == 0.0) and np.all(env_.upper == 0.0)
        return envelope(env_)
    both(case)


def test_holt_fallback_anticipates_a_ramp():
    def case(m):
        f = m.forecast.HoltWintersForecaster(season_length=100)
        values = np.arange(40, dtype=np.float64)
        env_ = f.forecast(values, steps=5, z=1.0)
        assert env_.mean[0] > values[-1]
        assert env_.mean[4] > env_.mean[0]
        return envelope(env_)
    both(case)


def test_holtwinters_learns_a_periodic_spike():
    def case(m):
        m_ = 10
        season = np.array([0, 0, 0, 0, 0, 0, 0, 0, 12, 12], dtype=np.float64)
        f = m.forecast.HoltWintersForecaster(season_length=m_)
        env_ = f.forecast(np.tile(season, 4), steps=m_, z=1.0)
        assert env_.mean[8] > 8.0 and env_.mean[9] > 8.0
        assert env_.mean[2] < 4.0
        return envelope(env_)
    both(case)


def test_forecast_is_deterministic():
    def case(m):
        rng = np.random.default_rng(7)
        values = rng.poisson(5.0, size=200).astype(np.float64)
        out = []
        for f in (m.forecast.EWMAForecaster(),
                  m.forecast.HoltWintersForecaster(season_length=24)):
            a = f.forecast(values, steps=10, z=1.64)
            b = f.forecast(values.copy(), steps=10, z=1.64)
            assert envelope(a) == envelope(b)
            out.append(envelope(a))
        return out
    both(case)


def test_make_forecaster_registry():
    def case(m):
        f = m.forecast
        assert isinstance(f.make_forecaster("ewma"), f.EWMAForecaster)
        hw = f.make_forecaster("holtwinters", season_length=360)
        assert isinstance(hw, f.HoltWintersForecaster)
        with pytest.raises(ValueError) as ei:
            f.make_forecaster("arima")
        return (hw.season_length, hw.alpha, hw.beta, hw.gamma, str(ei.value),
                sorted(f.__all__))
    assert both(case)[0] == 360


# ---------------------------------------------------------------------------
# demand series
# ---------------------------------------------------------------------------

def test_series_buckets_and_live_counts():
    def case(m):
        clock = FakeClock(0.0)
        s = m.forecast.DemandSeries(bucket_s=60.0, clock=clock)
        p1 = cpu_pod(m, cpu_m=1000, labels={"sim.karpenter.sh/wave": "web"})
        p2 = cpu_pod(m, cpu_m=3000, labels={"sim.karpenter.sh/wave": "web"})
        s.pod_added(p1)
        s.pod_added(p2)
        live = s.live("web")
        clock.step(120)
        s.advance()
        vals = s.values("web")
        s.pod_removed(p2)
        return (live, vals.tobytes(), s.live("web"), s.mean_request("web"),
                s.classes())
    live, vals, after, mean, classes = both(case)
    assert live == 2 and after == 1 and mean[0] == 2000.0
    assert np.frombuffer(vals).tolist() == [2.0, 2.0, 2.0]


def test_series_ignores_headroom_pods():
    def case(m):
        s = m.forecast.DemandSeries(bucket_s=60.0, clock=FakeClock(0.0))
        s.pod_added(headroom_pod(m))
        return s.classes(), s.snapshot_state()
    assert both(case)[0] == []


def test_pod_class_shape_bucketing():
    def case(m):
        p = cpu_pod(m, cpu_m=900, mem_mib=900)
        q = cpu_pod(m, labels={"sim.karpenter.sh/wave": "training"})
        return m.forecast.pod_class(p), m.forecast.pod_class(q)
    shape, wave = both(case)
    assert shape.startswith("c") and wave == "training"


# ---------------------------------------------------------------------------
# spot-risk prior
# ---------------------------------------------------------------------------

def test_spot_prior_rate_math():
    def case(m):
        prior = m.forecast.SpotRiskPrior(prior_reclaims=1.0,
                                         prior_node_hours=20.0)
        before = prior.rate("pool-a")

        class Src:
            nodepool = "pool-a"
        for _ in range(5):
            prior.observe_reclaim(Src())
        return before, prior.rate("pool-a"), prior.max_rate(), \
            prior.rate("default")
    before, after, top, default = both(case)
    assert before == pytest.approx(1.0 / 20.0)
    assert after == pytest.approx(6.0 / 20.0) and top >= default


# ---------------------------------------------------------------------------
# headroom controller
# ---------------------------------------------------------------------------

def controller(m, clock, cluster, prov, pools, **cfg_kw):
    f = m.forecast
    series = f.DemandSeries(bucket_s=60.0, clock=clock)
    cluster.observer = series
    cfg = f.HeadroomConfig(model="ewma", **cfg_kw)
    return f.HeadroomController(prov, cluster, pools, series,
                                f.make_forecaster("ewma"), clock=clock,
                                config=cfg), series


def test_reconcile_issues_placeholders_toward_forecast():
    def case(m):
        clock, cloud, provider, cluster, prov, pools = env(m)
        ctrl, series = controller(m, clock, cluster, prov, pools,
                                  confidence=1.0, ttl_s=600.0)
        pods = [cpu_pod(m, cpu_m=500,
                        labels={"sim.karpenter.sh/wave": "web"})
                for _ in range(6)]
        cluster.add_pods(pods)
        prov.provision()
        for _ in range(5):
            clock.step(60)
            series.advance()
        out = ctrl.reconcile()
        assert out.issued <= ctrl.config.max_issue_per_reconcile
        assert ctrl.stats["reconciles"] == 1
        first = (out.issued, out.expired, out.trimmed, sorted(
            out.targets.items()), pods_state(cluster))
        for p in pods:
            cluster.delete_pod(p)
        clock.step(700)
        out2 = ctrl.reconcile()
        lapsed = [p for p in cluster.pods.values()
                  if p.labels.get(m.forecast.HEADROOM_LABEL) == "true"
                  and float(p.annotations[
                      m.forecast.HEADROOM_EXPIRY_ANNOTATION]) <= clock()]
        assert not lapsed
        return (first, out2.issued, out2.expired, sorted(out2.targets.items()),
                dict(ctrl.stats), series.snapshot_state(),
                pods_state(cluster))
    both(case)


def test_expiry_deletes_lapsed_placeholders():
    def case(m):
        clock, cloud, provider, cluster, prov, pools = env(m)
        ctrl, series = controller(m, clock, cluster, prov, pools)
        cluster.add_pods([headroom_pod(m, expiry=clock() + 100.0)])
        early = ctrl._expire(clock())
        clock.step(200)
        late = ctrl._expire(clock())
        return early, late, len(cluster.pods), dict(ctrl.stats)
    assert both(case)[:3] == (0, 1, 0)


def test_real_pending_pod_preempts_placeholders():
    def case(m):
        clock, cloud, provider, cluster, prov, pools = env(m)
        ctrl, series = controller(m, clock, cluster, prov, pools)
        ph_bound = headroom_pod(m, name="headroom-web-000001", cpu_m=1800,
                                mem_mib=3000, expiry=clock() + 600)
        cluster.add_pods([ph_bound])
        prov.provision()
        assert ph_bound.node_name
        ph_pending = headroom_pod(m, name="headroom-web-000002",
                                  expiry=clock() + 600)
        cluster.add_pods([ph_pending])
        idle = ctrl.preempt_for_pending()
        cluster.add_pods([cpu_pod(m, cpu_m=1500, mem_mib=2000)])
        n = ctrl.preempt_for_pending()
        assert ph_bound.uid not in cluster.pods
        assert ph_pending.uid not in cluster.pods
        return idle, n, dict(ctrl.stats), pods_state(cluster)
    idle, n, stats, _ = both(case)
    assert (idle, n, stats["preempted"]) == (0, 2, 2)


# ---------------------------------------------------------------------------
# disruption sweep contract: protected-by-TTL
# ---------------------------------------------------------------------------

def disruption_env(m, policy="WhenEmpty", after=0.0):
    O = m.objects
    pools = [O.NodePool(disruption=O.Disruption(consolidation_policy=policy,
                                                consolidate_after_s=after))]
    clock, cloud, provider, cluster, prov, _ = env(m, pools=pools)
    ctrl = m.disruption.DisruptionController(provider, cluster, pools,
                                             clock=clock, stabilization_s=0.0,
                                             **m.extra)
    return clock, cloud, cluster, prov, ctrl


def _action(res):
    a = res.action
    return None if a is None else (a.kind, a.reason, len(a.candidates))


def test_sweep_must_not_reap_unexpired_headroom():
    def case(m):
        clock, cloud, cluster, prov, ctrl = disruption_env(m)
        ph = headroom_pod(m, expiry=clock() + 600.0)
        cluster.add_pods([ph])
        prov.provision()
        node = next(iter(cluster.nodes.values()))
        assert ph in node.pods
        res = ctrl.reconcile()
        return _action(res), node.name in cluster.nodes
    assert both(case) == (None, True)


def test_sweep_reaps_node_once_headroom_expires():
    def case(m):
        clock, cloud, cluster, prov, ctrl = disruption_env(m)
        ph = headroom_pod(m, expiry=clock() + 60.0)
        cluster.add_pods([ph])
        prov.provision()
        node = next(iter(cluster.nodes.values()))
        clock.step(120)
        res = ctrl.reconcile()
        return _action(res), node.name in cluster.nodes
    assert both(case) == (("delete", "emptiness", 1), False)


def test_real_pods_never_reschedule_onto_thin_air():
    def case(m):
        clock, cloud, cluster, prov, ctrl = disruption_env(
            m, policy="WhenUnderutilized")
        real = cpu_pod(m, cpu_m=400)
        cluster.add_pods([real])
        prov.provision()
        cluster.add_pods([cpu_pod(m, cpu_m=1800, mem_mib=3000)])
        prov.provision()
        ph = headroom_pod(m, expiry=clock() + 30.0, cpu_m=100, mem_mib=64)
        cluster.add_pods([ph])
        prov.provision()
        clock.step(60)
        res = ctrl.reconcile()
        if res.action is not None:
            assert real.node_name
        return _action(res), bool(real.node_name), pods_state(cluster)
    both(case)


# ---------------------------------------------------------------------------
# operator gating
# ---------------------------------------------------------------------------

def test_forecast_gate_off_by_default():
    def case(m):
        O = m.operator
        op = O.Operator(O.Options(), catalog=m.gen.generate_catalog(5),
                        **m.extra)
        ctrls = O.build_controllers(op)
        return sorted(ctrls), op.cluster.observer is None
    names, no_observer = both(case)
    assert "forecast" not in names and no_observer


def test_forecast_gate_wires_controller_and_observer():
    def case(m):
        O, f = m.operator, m.forecast
        out = []
        for extra_args in ([], ["--interruption-queue", "q"]):
            opts = O.Options.from_args(
                ["--forecast", "--forecast-model", "ewma",
                 "--forecast-cadence", "15"] + extra_args)
            assert opts.gate("Forecast")
            op = O.Operator(opts, catalog=m.gen.generate_catalog(5),
                            **m.extra)
            ctrls = O.build_controllers(op)
            fc = ctrls["forecast"]
            assert isinstance(op.cluster.observer, f.DemandSeries)
            assert isinstance(fc, f.HeadroomController)
            hook = None
            if "interruption" in ctrls:
                hook = ctrls["interruption"].on_spot_reclaim
                assert hook is not None
                assert hook == fc.spot_prior.observe_reclaim
            out.append((opts.forecast_cadence_s, sorted(ctrls),
                        type(fc.forecaster).__name__,
                        vars(fc.config), hook is not None))
        return out
    got = both(case)
    assert got[0][0] == 15.0 and not got[0][-1] and got[1][-1]


# ---------------------------------------------------------------------------
# the value proof: diurnal A/B replay (slow)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_diurnal_forecast_ab_improves_ttb_within_cost_cap():
    """tests/test_forecast.py's acceptance bar, on both packages: on the
    24h diurnal+batch scenario forecasting cuts time-to-bind p95 by at
    least 30% while raising $.h cost by at most 10%, same-seed runs
    serialize byte-identically, and the two packages' reports are equal."""
    path = os.path.join(REPO, "scenarios", "diurnal-forecast.yaml")

    def case(m):
        def run(on):
            sc = m.sim.load_scenario(path)
            return m.sim.SimHarness(sc, seed=0, duration_s=86400.0,
                                    forecast=on, **m.extra).run().report
        off, on, on2 = run(False), run(True), run(True)
        assert m.sim.report_to_json(on) == m.sim.report_to_json(on2)
        assert "forecast" not in off
        p_off = off["time_to_bind_s"]["p95"]
        p_on = on["time_to_bind_s"]["p95"]
        c_off = off["cost"]["dollar_hours"]
        c_on = on["cost"]["dollar_hours"]
        assert (p_off - p_on) / p_off >= 0.30, (p_off, p_on)
        assert (c_on - c_off) / c_off <= 0.10, (c_off, c_on)
        return m.sim.report_to_json(off), m.sim.report_to_json(on)
    both(case)
