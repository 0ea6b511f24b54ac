"""The port's manifest surface (api/serialize.py, api/legacy.py,
`admission.validate_manifest`, `Operator.apply` / `apply_batch`) against
the JAX package's, with tests/test_serialize.py's manifests and
tests/test_operator.py's TestApply cases: every manifest decodes on both
packages to objects that encode back to the same manifest (and carry
across to the other package's decoder), every rejection is the same error,
the legacy kinds convert alike, Pod manifests parse to the same scheduling
view, and the operator admits, converts, registers and refuses the same
manifests, atomically per batch, with the NodeClass role immutable.
"""

import copy
import importlib
import itertools
import json
from dataclasses import asdict
from types import SimpleNamespace

import pytest

MODULES = dict(serialize="api.serialize", legacy="api.legacy",
               admission="api.admission", objects="api.objects",
               operator="operator", options="operator.options",
               gen="catalog.generate", fake="cloud.fake",
               nodeclass="controllers.nodeclass")


def _package(name, extra):
    return SimpleNamespace(name=name, extra=extra, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in MODULES.items()})


REF = _package("karpenter_tpu", {})
PORT = _package("karpenter_tpu_torch", {"device": "cpu"})


def both(case):
    ref, port = case(REF), case(PORT)
    assert ref == port
    return port


def outcome(fn, *a, **kw):
    """("ok", value) or (exception class name, message)."""
    try:
        return "ok", fn(*a, **kw)
    except Exception as e:
        return type(e).__name__, str(e)


# ---------------------------------------------------------------------------
# the manifest corpus (tests/test_serialize.py's, plus edges)
# ---------------------------------------------------------------------------

ZONE = "topology.kubernetes.io/zone"
CAPACITY_TYPE = "karpenter.sh/capacity-type"

NODEPOOLS = {
    "full": {"apiVersion": "karpenter.tpu/v1beta1", "kind": "NodePool",
             "metadata": {"name": "gpu"},
             "spec": {"template": {
                 "metadata": {"labels": {"team": "ml"},
                              "annotations": {"a": "b"}},
                 "spec": {"nodeClassRef": {"name": "gpu-class"},
                          "requirements": [{"key": CAPACITY_TYPE,
                                            "operator": "In",
                                            "values": ["spot"]}],
                          "taints": [{"key": "gpu", "effect": "NoSchedule",
                                      "value": "true"}],
                          "startupTaints": [{"key": "boot",
                                             "effect": "NoExecute"}]}},
                 "disruption": {"consolidationPolicy": "WhenEmpty",
                                "consolidateAfter": "30s",
                                "expireAfter": "12h"},
                 "limits": {"cpu": "100", "memory": "1Ti"},
                 "weight": 10}},
    "minimal": {"kind": "NodePool", "metadata": {"name": "x"},
                "spec": {"template": {}, "disruption": {}}},
    "kubelet": {"apiVersion": "karpenter.sh/v1beta1", "kind": "NodePool",
                "metadata": {"name": "dense"},
                "spec": {"template": {"spec": {
                    "kubelet": {"maxPods": 30, "podsPerCore": 4,
                                "kubeReserved": {"cpu": "500m",
                                                 "memory": "1Gi"},
                                "evictionHard": {"memory": "200Mi"},
                                "clusterDNS": ["10.0.0.10", "10.0.0.11"],
                                "cpuCFSQuota": True},
                    "nodeClassRef": {"name": "default"}}}}},
    "operators": {"kind": "NodePool", "metadata": {"name": "ops"},
                  "spec": {"template": {"spec": {"requirements": [
                      {"key": "k1", "operator": "NotIn", "values": ["a"]},
                      {"key": "k2", "operator": "Exists"},
                      {"key": "k3", "operator": "DoesNotExist"},
                      {"key": "k4", "operator": "Gt", "values": ["4"]},
                      {"key": "k5", "operator": "Lt", "values": ["9"]}]}}}},
    "bad-weight": {"kind": "NodePool", "metadata": {"name": "x"},
                   "spec": {"weight": 9000, "template": {}}},
    "bad-policy": {"kind": "NodePool", "metadata": {"name": "x"},
                   "spec": {"template": {},
                            "disruption": {"consolidationPolicy": "Never"}}},
}

NODECLASS_FULL = {
    "apiVersion": "karpenter.sh/v1beta1", "kind": "NodeClass",
    "metadata": {"name": "full"},
    "spec": {
        "imageFamily": "standard", "role": "r", "userData": "x",
        "tags": {"team": "a"}, "zones": ["zone-a"],
        "subnetSelectorTerms": [{"tags": {"k": "v"}}, {"id": "s-1"}],
        "securityGroupSelectorTerms": [{"name": "sg"}],
        "blockDeviceMappings": [
            {"deviceName": "/dev/xvda",
             "ebs": {"volumeSize": "100Gi", "volumeType": "gp3",
                     "encrypted": True, "deleteOnTermination": True}}],
        "metadataOptions": {"httpTokens": "required",
                            "httpPutResponseHopLimit": 2},
        "detailedMonitoring": True, "instanceStorePolicy": "RAID0",
        "associatePublicIPAddress": False}}


def _nc_variant(**spec):
    m = copy.deepcopy(NODECLASS_FULL)
    m["spec"].update(spec)
    return m


NODECLASSES = {
    "full": NODECLASS_FULL,
    "empty": {"kind": "NodeClass", "metadata": {"name": "x"}, "spec": {}},
    "custom-no-selector": {"kind": "NodeClass", "metadata": {"name": "x"},
                           "spec": {"imageFamily": "custom"}},
    "bad-tokens": _nc_variant(metadataOptions={"httpTokens": "sometimes"}),
    "no-device-name": _nc_variant(blockDeviceMappings=[
        {"ebs": {"volumeType": "gp3"}}]),
    "io2-without-iops": _nc_variant(blockDeviceMappings=[
        {"deviceName": "/dev/xvda", "ebs": {"volumeType": "io2"}}]),
}

NODECLAIM = {
    "apiVersion": "karpenter.tpu/v1beta1", "kind": "NodeClaim",
    "metadata": {"name": "claim-1", "labels": {"team": "a"}},
    "spec": {"nodePoolRef": {"name": "team-a"},
             "nodeClassRef": {"name": "gpu"},
             "requirements": [{"key": "kubernetes.io/arch",
                               "operator": "In", "values": ["amd64"]}],
             "resources": {"requests": {"cpu": "2", "memory": "4Gi"}},
             "taints": [{"key": "dedicated", "effect": "NoSchedule",
                         "value": "ml"}],
             "nodeClassHash": "abc123"},
    "status": {"providerID": "i-123", "instanceType": "a.large",
               "zone": "zone-b", "capacityType": "spot", "imageID": "img-7",
               "price": 0.42, "launchedAt": 1234.5,
               "conditions": [{"type": "Launched", "status": "True"},
                              {"type": "Registered", "status": "True"}]}}

PROVISIONER = {
    "apiVersion": "karpenter.tpu/v1alpha5", "kind": "Provisioner",
    "metadata": {"name": "default"},
    "spec": {"labels": {"team": "ml"},
             "requirements": [{"key": CAPACITY_TYPE, "operator": "In",
                               "values": ["spot"]}],
             "taints": [{"key": "gpu", "effect": "NoSchedule",
                         "value": "true"}],
             "providerRef": {"name": "my-template"},
             "ttlSecondsAfterEmpty": 30, "ttlSecondsUntilExpired": 2592000,
             "limits": {"resources": {"cpu": "100", "memory": "400Gi"}},
             "weight": 20}}
NODE_TEMPLATE = {
    "apiVersion": "karpenter.tpu/v1alpha1", "kind": "NodeTemplate",
    "metadata": {"name": "my-template"},
    "spec": {"amiFamily": "Bottlerocket",
             "subnetSelector": {"karpenter.sh/discovery": "cluster"},
             "securityGroupSelector": {"karpenter.sh/discovery": "cluster"},
             "amiSelector": {"team": "ml"}, "role": "KarpenterNodeRole",
             "userData": 'k = "v"',
             "blockDeviceMappings": [{"deviceName": "/dev/xvda",
                                      "ebs": {"volumeSize": "100Gi"}}]}}
MACHINE = {
    "apiVersion": "karpenter.tpu/v1alpha5", "kind": "Machine",
    "metadata": {"name": "machine-1",
                 "labels": {"karpenter.sh/provisioner-name": "team-a"}},
    "spec": {"machineTemplateRef": {"name": "gpu"},
             "requirements": [{"key": "kubernetes.io/arch", "operator": "In",
                               "values": ["amd64"]}],
             "taints": [{"key": "dedicated", "effect": "NoSchedule"}],
             "resources": {"requests": {"cpu": "2", "memory": "4Gi"}}},
    "status": {"providerID": "i-abc", "instanceType": "a.large",
               "zone": "zone-b", "capacityType": "spot"}}

LEGACY = {
    "provisioner": PROVISIONER,
    "provisioner-consolidation": dict(PROVISIONER, spec={
        **PROVISIONER["spec"], "consolidation": {"enabled": True}}),
    "provisioner-bare": {"kind": "Provisioner", "metadata": {"name": "b"},
                         "spec": {}},
    "node-template": NODE_TEMPLATE,
    "aws-node-template": dict(NODE_TEMPLATE, kind="AWSNodeTemplate", spec={
        **NODE_TEMPLATE["spec"], "amiFamily": "AL2",
        "blockDeviceMappings": [{"ebs": {"volumeSize": 50}}]}),
    "machine": MACHINE,
    "nodepool-passthrough": NODEPOOLS["full"],
    "deployment": {"kind": "Deployment"},
}


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(NODEPOOLS))
def test_nodepool_manifests_round_trip_alike(name):
    m = NODEPOOLS[name]

    def case(pkg):
        S = pkg.serialize
        got = outcome(S.nodepool_from_manifest, m)
        raw = S.nodepool_to_manifest(S.nodepool_from_manifest(
            m, validate=False))
        if got[0] != "ok":
            return got, raw
        back = S.nodepool_to_manifest(got[1])
        assert S.nodepool_to_manifest(S.nodepool_from_manifest(back)) == back
        return back, raw
    back, _ = both(case)
    # and across: the reference's encoding decodes on the port alike
    if isinstance(back, dict):
        ref_obj = REF.serialize.nodepool_from_manifest(m)
        assert PORT.serialize.nodepool_to_manifest(
            PORT.serialize.nodepool_from_manifest(
                REF.serialize.nodepool_to_manifest(ref_obj))) == back


@pytest.mark.parametrize("name", sorted(NODECLASSES))
def test_nodeclass_manifests_round_trip_alike(name):
    m = NODECLASSES[name]

    def case(pkg):
        S = pkg.serialize
        got = outcome(S.nodeclass_from_manifest, m)
        raw = S.nodeclass_to_manifest(S.nodeclass_from_manifest(
            m, validate=False))
        if got[0] != "ok":
            return got, raw
        nc = got[1]
        nc.status_subnets = ["s-1"]
        nc.status_images = ["img-1"]
        return S.nodeclass_to_manifest(nc), raw
    both(case)


def test_nodeclaim_manifest_round_trips_alike():
    def case(pkg):
        S = pkg.serialize
        claim = S.nodeclaim_from_manifest(NODECLAIM)
        out = S.nodeclaim_to_manifest(claim)
        assert (claim.registered, claim.initialized) == (True, False)
        bare = S.nodeclaim_to_manifest(pkg.objects.NodeClaim(nodepool="p"))
        bare["metadata"].pop("name")     # a counter's name
        return out, bare
    both(case)


@pytest.mark.parametrize("name", sorted(LEGACY))
def test_legacy_manifests_convert_alike(name):
    def case(pkg):
        got = outcome(pkg.legacy.convert_manifest, LEGACY[name])
        if got[0] == "ok" and got[1]["kind"] == "NodeClaim":
            # converted through the current codecs on either side
            pkg.serialize.nodeclaim_from_manifest(got[1])
        return got
    both(case)


def test_crd_schemas_are_the_same_documents():
    def case(pkg):
        schemas = pkg.serialize.crd_schemas()
        assert set(schemas) == {"NodePool", "NodeClass", "NodeClaim",
                                "Provisioner", "Machine", "NodeTemplate"}
        return json.dumps(schemas, sort_keys=True)
    both(case)


MANIFESTS = {
    **{f"nodepool-{k}": v for k, v in NODEPOOLS.items()},
    **{f"nodeclass-{k}": v for k, v in NODECLASSES.items()},
    **{f"legacy-{k}": v for k, v in LEGACY.items()},
    "nodeclaim": NODECLAIM,
    "nodepool-no-spec": {"kind": "NodePool", "metadata": {"name": "x"}},
    "nodepool-bad-requirement": {"kind": "NodePool", "spec": {
        "template": {}, "requirements": [{"operator": "In"}]}},
    "nodeclaim-bad": {"kind": "NodeClaim", "spec": {
        "nodePoolRef": {"name": ""}}, "status": {"capacityType": "x",
                                                 "price": -1}},
    "nodeclass-bad-family": {"kind": "NodeClass",
                             "spec": {"imageFamily": "windows"}},
    "machine-bad": {"kind": "Machine", "metadata": {"name": "bad"},
                    "spec": {"requirements": [{"operator": "In"}]}},
    "provisioner-bad": {"kind": "Provisioner", "spec": {"weight": 9000}},
    "widget": {"kind": "Widget", "spec": {}},
}


@pytest.mark.parametrize("name", sorted(MANIFESTS))
def test_validate_manifest_accepts_and_refuses_alike(name):
    both(lambda pkg: outcome(pkg.admission.validate_manifest,
                             MANIFESTS[name]))


# ---------------------------------------------------------------------------
# Pod manifests
# ---------------------------------------------------------------------------

def pod_view(p):
    """A parsed Pod's scheduling view, comparable across packages."""
    req = lambda rs: [[(r.key, r.complement, sorted(r.values), r.greater_than,  # noqa: E731
                        r.less_than) for r in t.values()] for t in rs]
    return dict(
        name=p.name, namespace=p.namespace,
        requests=sorted(p.requests.items()), limits=sorted(p.limits.items()),
        node_selector=p.node_selector,
        required=req(p.required_affinity_terms),
        preferred=[(w, req([t])[0]) for w, t in p.preferred_affinity_terms],
        tolerations=[asdict(t) for t in p.tolerations],
        spread=[asdict(t) for t in p.topology_spread],
        affinities=[asdict(t) for t in p.pod_affinities],
        labels=p.labels, annotations=p.annotations, priority=p.priority,
        deletion_cost=p.deletion_cost, owner_kind=p.owner_kind,
        do_not_disrupt=p.do_not_disrupt)


POD_FULL = {
    "metadata": {"name": "web-1", "namespace": "prod",
                 "labels": {"app": "web"},
                 "annotations": {
                     "controller.kubernetes.io/pod-deletion-cost": "100",
                     "karpenter.sh/do-not-disrupt": "true"},
                 "ownerReferences": [{"kind": "StatefulSet",
                                      "name": "web"}]},
    "spec": {
        "priority": 1000, "nodeSelector": {ZONE: "zone-a"},
        "containers": [
            {"resources": {"requests": {"cpu": "1", "memory": "2Gi"}}},
            {"resources": {"requests": {"cpu": "500m"}}}],
        "initContainers": [{"resources": {"requests": {"cpu": "2"}}}],
        "tolerations": [{"key": "dedicated", "operator": "Exists",
                         "effect": "NoSchedule"}],
        "affinity": {
            "nodeAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": {
                    "nodeSelectorTerms": [{"matchExpressions": [
                        {"key": "kubernetes.io/arch", "operator": "In",
                         "values": ["amd64"]}]}]},
                "preferredDuringSchedulingIgnoredDuringExecution": [
                    {"weight": 10, "preference": {"matchExpressions": [
                        {"key": CAPACITY_TYPE, "operator": "In",
                         "values": ["spot"]}]}}]},
            "podAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [
                    {"podAffinityTerm": {
                        "topologyKey": ZONE,
                        "labelSelector": {"matchLabels": {"app": "db"}}}}]},
            "podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    {"topologyKey": "kubernetes.io/hostname",
                     "labelSelector": {"matchLabels": {"app": "web"}}}]}},
        "topologySpreadConstraints": [
            {"topologyKey": ZONE, "maxSkew": 2,
             "whenUnsatisfiable": "ScheduleAnyway", "minDomains": 2,
             "labelSelector": {"matchLabels": {"app": "web"}}}]}}

PODS = {
    "full": POD_FULL,
    "limits-default-requests": {"metadata": {"name": "x"}, "spec": {
        "containers": [
            {"resources": {"limits": {"cpu": "2", "memory": "1Gi"}}},
            {"resources": {"requests": {"cpu": "500m"},
                           "limits": {"cpu": "4", "memory": "2Gi"}}}]}},
    "sidecar": {"metadata": {"name": "x"}, "spec": {
        "containers": [{"resources": {"requests": {"cpu": "1"}}}],
        "initContainers": [
            {"restartPolicy": "Always",
             "resources": {"requests": {"cpu": "500m"}}},
            {"resources": {"requests": {"cpu": "1200m"}}}]}},
    "init-peak": {"metadata": {"name": "x"}, "spec": {
        "containers": [{"resources": {"requests": {"cpu": "1"}}}],
        "initContainers": [{"resources": {"requests": {"cpu": "10"}}}]}},
    "empty": {},
    "match-expressions": {"metadata": {"name": "x"}, "spec": {
        "containers": [{"resources": {"requests": {"cpu": "1"}}}],
        "affinity": {"podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                {"topologyKey": "kubernetes.io/hostname",
                 "labelSelector": {"matchExpressions": [
                     {"key": "app", "operator": "In",
                      "values": ["web"]}]}}]}}}},
}


@pytest.mark.parametrize("name", sorted(PODS))
def test_pod_manifests_parse_alike(name, monkeypatch):
    def case(pkg):
        # a manifest without a name takes the package's next generated id:
        # start both packages' id counters alike, whatever ran before
        monkeypatch.setattr(pkg.objects, "_ids", itertools.count())
        got = outcome(pkg.serialize.pod_from_manifest, PODS[name])
        return (got[0], pod_view(got[1])) if got[0] == "ok" else got
    view = both(case)
    if name == "full":
        assert view[1]["requests"] == [("cpu", 2000), ("memory", 2 * 2**30)]


def test_workload_pod_manifests_round_trip_the_headline_specs():
    """`workloads.pod_manifest` (the /v1 cell's encoder) parses back to the
    pod it was made from, on both packages."""
    import numpy as np
    import bench
    from karpenter_tpu_torch import workloads
    kw = dict(workloads.HEADLINE, total=400)
    for pkg, build in ((REF, bench.build_pods), (PORT, workloads.build_pods)):
        pods = build(rng=np.random.default_rng(0), **kw)
        payload = workloads.v1_solve_payload(pods)
        back = [pkg.serialize.pod_from_manifest(m) for m in payload["pods"]]
        for p, q in zip(pods, back):
            assert q.requests == p.requests
            assert q.node_selector == p.node_selector
            assert [asdict(t) for t in q.tolerations] == \
                [asdict(t) for t in p.tolerations]


# ---------------------------------------------------------------------------
# Operator.apply / apply_batch (tests/test_operator.py's TestApply)
# ---------------------------------------------------------------------------

def _op(pkg):
    return pkg.operator.Operator(pkg.options.Options(),
                                 catalog=pkg.gen.generate_catalog(10),
                                 clock=lambda: 1000.0, **pkg.extra)


def _live(op):
    return dict(
        nodepools={k: op.nodepools[k].name for k in sorted(op.nodepools)},
        node_classes={k: (nc.role, nc.user_data, nc.image_family)
                      for k, nc in sorted(op.node_classes.items())},
        claims=sorted(op.cluster.nodeclaims),
        nodes=sorted((n.labels.get("karpenter.sh/nodepool"),
                      sorted(n.allocatable.items()))
                     for n in op.cluster.nodes.values()))


def test_apply_validates_converts_and_registers_alike():
    def case(pkg):
        op, obs = _op(pkg), []
        for m in (NODEPOOLS["bad-weight"], NODEPOOLS["full"],
                  MANIFESTS["nodepool-no-spec"], MANIFESTS["widget"],
                  LEGACY["provisioner"], LEGACY["node-template"],
                  {"kind": "NodeClass", "metadata": {"name": "gpu"},
                   "spec": {"imageFamily": "standard", "role": "r"}},
                  MANIFESTS["machine-bad"]):
            got = outcome(op.apply, m)
            obs.append(got[0] if got[0] == "ok" else got)
        pool = op.nodepools["default"]
        obs.append((pool.disruption.consolidation_policy,
                    pool.template.node_class_ref))
        return obs, _live(op)
    obs, live = both(case)
    assert obs[0][0] == "ValidationError" and obs[1] == "ok"
    assert live["nodepools"]["gpu"] == "gpu"


def test_apply_legacy_machine_registers_nodeclaim_alike():
    def case(pkg):
        op = _op(pkg)
        claim = op.apply({
            "apiVersion": "karpenter.tpu/v1alpha5", "kind": "Machine",
            "metadata": {"name": "machine-7",
                         "labels": {"karpenter.sh/provisioner-name": "p"}},
            "spec": {"machineTemplateRef": {"name": "default"}},
            "status": {"providerID": "i-m7", "instanceType": "a.small"}})
        assert op.cluster.nodeclaims["machine-7"] is claim
        assert op.cluster.node_for_provider_id("i-m7") is not None
        return _live(op)
    assert both(case)["nodes"][0][0] == "p"


def test_apply_nodeclass_and_blocked_delete_alike():
    def case(pkg):
        op = _op(pkg)
        nc = op.apply({"apiVersion": "karpenter.tpu/v1beta1",
                       "kind": "NodeClass", "metadata": {"name": "gpu"},
                       "spec": {"imageFamily": "standard", "role": "r"}})
        claim = pkg.objects.NodeClaim(nodepool="p", node_class_ref="gpu")
        op.cluster.nodeclaims[claim.name] = claim
        out = [op.node_classes["gpu"] is nc, op.delete("NodeClass", "gpu")]
        claim.terminating = True
        out += [op.delete("NodeClass", "gpu"), "gpu" in op.node_classes,
                op.delete("NodePool", "default"),
                outcome(op.delete, "Widget", "x")]
        return out
    assert both(case)[:4] == [True, False, True, False]


def test_apply_enforces_role_immutability_alike():
    def case(pkg):
        op = _op(pkg)
        base = {"apiVersion": "karpenter.tpu/v1beta1", "kind": "NodeClass",
                "metadata": {"name": "web"},
                "spec": {"imageFamily": "standard", "role": "r1"}}
        op.apply(base)
        op.apply(dict(base, spec=dict(base["spec"], userData="v2")))
        hijack = outcome(op.apply, dict(base, spec=dict(base["spec"],
                                                        role="r2")))
        # in one batch: a create then an immutable-field update fails up
        # front, and nothing of the batch is applied
        batch = outcome(op.apply_batch, [
            dict(base, metadata={"name": "web2"}),
            dict(base, metadata={"name": "web2"},
                 spec=dict(base["spec"], role="r3"))])
        return hijack, batch, _live(op)
    hijack, batch, live = both(case)
    assert hijack[0] == "ValidationError" and batch[0] == "ValueError"
    assert live["node_classes"]["web"][:2] == ("r1", "v2")
    assert "web2" not in live["node_classes"]


def test_apply_batch_matches_sequential_apply_alike():
    manifests = [
        {"apiVersion": "karpenter.tpu/v1", "kind": "NodePool",
         "metadata": {"name": "pool-a"},
         "spec": {"template": {"spec": {
             "nodeClassRef": {"name": "default"}}}}},
        {"apiVersion": "karpenter.tpu/v1alpha5", "kind": "Machine",
         "metadata": {"name": "machine-b",
                      "labels": {"karpenter.sh/provisioner-name": "pool-a"}},
         "spec": {"machineTemplateRef": {"name": "default"}},
         "status": {"providerID": "i-mb", "instanceType": "a.small"}}]

    def case(pkg):
        seq, bat, atomic = _op(pkg), _op(pkg), _op(pkg)
        for m in manifests:
            seq.apply(m)
        bat.apply_batch(manifests)
        assert _live(seq) == _live(bat)
        err = outcome(atomic.apply_batch,
                      manifests + [{"kind": "Nope", "metadata": {}}])
        return _live(bat), err, _live(atomic)
    live, err, atomic = both(case)
    assert err[0] == "ValueError" and atomic["claims"] == []
    assert "pool-a" not in atomic["nodepools"]
