"""The port's providers, services, batcher and NodeClass controller against
the JAX package's, case by case with tests/test_providers.py,
test_imagefamily.py, test_batcher.py and test_nodeclass.py (its controller
and admission cases; its lifecycle cases are in test_torch_lifecycle.py).

Every case runs on a namespace of either package's modules (`REF`, `PORT`),
checks the reference's assertions on both, and returns plain observations
(ids, names, prices, user data, call counts) that must be equal between
the two; test_instance_type_gauges_set reads each package's own metric
family.
"""

import email
import importlib
import threading
import time
from types import SimpleNamespace

import pytest

MODULES = dict(
    objects="api.objects", taints="api.taints", labels="api.labels",
    gen="catalog.generate", fake="cloud.fake", services="cloud.services",
    provider="cloud.provider", batcher="cloud.batcher",
    providers="providers", instanceprofile="providers.instanceprofile",
    pricing="providers.pricing", securitygroup="providers.securitygroup",
    subnet="providers.subnet", version="providers.version",
    imagefamily="providers.imagefamily",
    launchtemplate="providers.launchtemplate",
    nodeclass="controllers.nodeclass", state="state.cluster")


def _package(name):
    return SimpleNamespace(name=name, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in MODULES.items()})


REF = _package("karpenter_tpu")
PORT = _package("karpenter_tpu_torch")


def both(case):
    """`case(m)` on each package; the observations must be equal."""
    ref, port = case(REF), case(PORT)
    assert ref == port
    return port


# ---------------------------------------------------------------------------
# tests/test_providers.py
# ---------------------------------------------------------------------------

def provider_cloud(m):
    c = m.fake.FakeCloud()
    c.subnets = [
        m.fake.SubnetInfo("subnet-a1", "zone-a", 100, {"team": "infra"}),
        m.fake.SubnetInfo("subnet-a2", "zone-a", 50, {"team": "infra"}),
        m.fake.SubnetInfo("subnet-b1", "zone-b", 10, {"team": "infra"}),
        m.fake.SubnetInfo("subnet-c1", "zone-c", 200, {"team": "other"}),
    ]
    c.security_groups = [
        m.fake.SecurityGroupInfo("sg-1", "cluster-nodes", {"cluster": "k"}),
        m.fake.SecurityGroupInfo("sg-2", "cluster-lb", {"cluster": "k"}),
        m.fake.SecurityGroupInfo("sg-3", "unrelated", {}),
    ]
    return c


def test_tag_id_name_wildcard():
    def case(m):
        ms = m.providers.matches_selector
        return [ms("id-1", {"a": "1"}, {"a": "1"}),
                ms("id-1", {"a": "1"}, {"a": "2"}),
                ms("id-1", {}, {"id": "id-1"}),
                ms("id-1", {}, {"name": "n"}, obj_name="n"),
                ms("id-1", {"a": "x"}, {"a": "*"}),
                ms("id-1", {}, {"a": "*"}),
                ms("id-1", {}, {})]
    assert both(case) == [True, False, True, True, True, False, True]


def test_list_by_selector_and_zone():
    def case(m):
        p = m.subnet.SubnetProvider(provider_cloud(m))
        a = sorted(s.id for s in p.list(
            m.objects.NodeClass(subnet_selector={"team": "infra"})))
        b = sorted(s.id for s in p.list(m.objects.NodeClass(
            subnet_selector={"team": "infra"}, zone_selector=["zone-a"])))
        return a, b
    assert both(case) == (["subnet-a1", "subnet-a2", "subnet-b1"],
                          ["subnet-a1", "subnet-a2"])


def test_list_is_cached():
    def case(m):
        cloud = provider_cloud(m)
        p = m.subnet.SubnetProvider(cloud)
        nc = m.objects.NodeClass(subnet_selector={"team": "infra"})
        p.list(nc)
        p.list(nc)
        return cloud.calls["describe_subnets"]
    assert both(case) == 1


def test_zonal_pick_prefers_most_free_ips():
    def case(m):
        p = m.subnet.SubnetProvider(provider_cloud(m))
        picks = p.zonal_subnets_for_launch(
            m.objects.NodeClass(subnet_selector={"team": "infra"}))
        return {z: s.id for z, s in picks.items()}
    assert both(case) == {"zone-a": "subnet-a1", "zone-b": "subnet-b1"}


def test_inflight_accounting_spreads_launches():
    def case(m):
        cloud = provider_cloud(m)
        cloud.subnets = [m.fake.SubnetInfo("s1", "zone-a", 3, {}),
                         m.fake.SubnetInfo("s2", "zone-a", 2, {})]
        p = m.subnet.SubnetProvider(cloud)
        nc = m.objects.NodeClass()
        first = p.zonal_subnets_for_launch(nc, ips_per_launch=2)
        second = p.zonal_subnets_for_launch(nc, ips_per_launch=2)
        return first["zone-a"].id, second["zone-a"].id
    assert both(case) == ("s1", "s2")


def test_inflight_refund_on_fleet_response():
    def case(m):
        cloud = provider_cloud(m)
        cloud.subnets = [m.fake.SubnetInfo("s1", "zone-a", 10, {})]
        p = m.subnet.SubnetProvider(cloud)
        nc = m.objects.NodeClass()
        req = p.zonal_subnets_for_launch(nc, ips_per_launch=4)
        seen = [p.inflight("s1")]
        p.update_inflight_ips(["other-subnet"], req, ips_per_launch=4)
        seen.append(p.inflight("s1"))
        req = p.zonal_subnets_for_launch(nc, ips_per_launch=4)
        p.update_inflight_ips(["s1"], req, ips_per_launch=4)
        seen.append(p.inflight("s1"))
        return seen
    assert both(case) == [4, 0, 4]


def test_list_requires_selector():
    def case(m):
        return m.securitygroup.SecurityGroupProvider(provider_cloud(m)).list(
            m.objects.NodeClass())
    assert both(case) == []


def test_list_by_tag_and_name():
    def case(m):
        cloud = provider_cloud(m)
        p = m.securitygroup.SecurityGroupProvider(cloud)
        by_tag = sorted(g.id for g in p.list(m.objects.NodeClass(
            security_group_selector={"cluster": "k"})))
        by_name = [g.id for g in p.list(m.objects.NodeClass(
            security_group_selector={"name": "cluster-lb"}))]
        calls = [cloud.calls["describe_security_groups"]]
        p.list(m.objects.NodeClass(security_group_selector={"cluster": "k"}))
        calls.append(cloud.calls["describe_security_groups"])
        return by_tag, by_name, calls
    assert both(case) == (["sg-1", "sg-2"], ["sg-2"], [2, 2])


def test_create_idempotent_and_cached():
    def case(m):
        iam = m.services.FakeIAM()
        p = m.instanceprofile.InstanceProfileProvider(iam, cluster_name="ktpu")
        nc = m.objects.NodeClass(role="node-role")
        name = p.create(nc)
        role = iam.get_instance_profile(name)["_roles"]
        p.create(nc)
        return name, role, iam.calls["create_instance_profile"]
    name, role, calls = both(case)
    assert name.startswith("ktpu_") and role == "node-role" and calls == 1


def test_role_swap():
    def case(m):
        iam = m.services.FakeIAM()
        clock = [0.0]
        p = m.instanceprofile.InstanceProfileProvider(
            iam, "ktpu", clock=lambda: clock[0])
        name = p.create(m.objects.NodeClass(role="old-role"))
        clock[0] += 16 * 60  # expire the provider cache
        p.create(m.objects.NodeClass(role="new-role"))
        return iam.get_instance_profile(name)["_roles"]
    assert both(case) == "new-role"


def test_delete():
    def case(m):
        iam = m.services.FakeIAM()
        p = m.instanceprofile.InstanceProfileProvider(iam, "ktpu")
        nc = m.objects.NodeClass(role="r")
        name = p.create(nc)
        p.delete(nc)
        with pytest.raises(m.fake.CloudError):
            iam.get_instance_profile(name)
        p.delete(nc)  # idempotent
        return sorted(iam.calls.items())
    both(case)


def test_cached():
    def case(m):
        cp = m.services.FakeControlPlane(version="1.29")
        p = m.version.VersionProvider(cp)
        return p.get(), p.get(), cp.calls["server_version"]
    assert both(case) == ("1.29", "1.29", 1)


def pricing_env(m, **kw):
    catalog = m.gen.generate_catalog(20)
    api = m.services.FakePricingAPI()
    cloud = m.fake.FakeCloud()
    p = m.pricing.PricingProvider(
        pricing_api=api, cloud=cloud,
        static_fallback=m.pricing.static_price_table(catalog), **kw)
    return p, api, cloud, catalog


def test_static_fallback():
    def case(m):
        p, _, _, catalog = pricing_env(m)
        name = catalog[0].name
        od = p.on_demand_price(name)
        assert od is not None
        assert p.spot_price(name, "zone-a") == pytest.approx(od * 0.30)
        return od, p.spot_price(name, "zone-a"), \
            sorted(m.pricing.static_price_table(catalog).items())
    both(case)


def test_refresh_overrides_static():
    def case(m):
        p, api, cloud, catalog = pricing_env(m)
        name = catalog[0].name
        api.on_demand = {name: 9.99}
        cloud.spot_prices = {(name, "zone-a"): 1.23}
        assert p.update_on_demand_pricing()
        assert p.update_spot_pricing()
        return (p.on_demand_price(name), p.spot_price(name, "zone-a"),
                p.spot_price(name, "zone-b"), p.seq_num)
    od, spot_a, spot_b, seq = both(case)
    assert (od, spot_a, seq) == (9.99, 1.23, (1, 1))
    assert spot_b == pytest.approx(9.99 * 0.30)


def test_api_failure_keeps_stale_table():
    def case(m):
        p, api, _, catalog = pricing_env(m)
        name = catalog[0].name
        api.on_demand = {name: 9.99}
        p.update_on_demand_pricing()
        api.next_error = m.fake.CloudError("Throttled")
        assert not p.update_on_demand_pricing()
        return p.on_demand_price(name)
    assert both(case) == 9.99


def test_controller_respects_interval():
    def case(m):
        clock = [0.0]
        p, api, _, _ = pricing_env(m, clock=lambda: clock[0])
        ctrl = m.pricing.PricingController(p, interval=100,
                                           clock=lambda: clock[0])
        seen = [ctrl.reconcile(), ctrl.reconcile()]
        clock[0] += 101
        seen.append(ctrl.reconcile())
        return seen
    assert both(case) == [True, False, True]


def test_live_prices_flow_into_offerings():
    def case(m):
        catalog = m.gen.generate_catalog(5)
        api = m.services.FakePricingAPI()
        cloud = m.fake.FakeCloud()
        pricing = m.pricing.PricingProvider(
            pricing_api=api, cloud=cloud,
            static_fallback=m.pricing.static_price_table(catalog))
        provider = m.provider.CloudProvider(cloud, catalog, pricing=pricing)
        name = catalog[0].name

        def od():
            return [o.price for it in provider.get_instance_types()
                    if it.name == name for o in it.offerings
                    if o.capacity_type == "on-demand"][0]
        before = od()
        assert before == [o.price for o in catalog[0].offerings
                          if o.capacity_type == "on-demand"][0]
        api.on_demand = {name: 99.0}
        assert pricing.update_on_demand_pricing()
        return before, od()
    assert both(case)[1] == 99.0


def test_spot_history_flows_per_zone():
    def case(m):
        catalog = m.gen.generate_catalog(5)
        cloud = m.fake.FakeCloud()
        name = catalog[0].name
        zone = catalog[0].offerings[0].zone
        pricing = m.pricing.PricingProvider(
            pricing_api=m.services.FakePricingAPI(), cloud=cloud,
            static_fallback=m.pricing.static_price_table(catalog))
        provider = m.provider.CloudProvider(cloud, catalog, pricing=pricing)
        cloud.spot_prices = {(name, zone): 0.011}
        assert pricing.update_spot_pricing()
        return [(it.name, o.zone, o.capacity_type, o.price)
                for it in provider.get_instance_types()
                for o in it.offerings]
    rows = both(case)
    assert [r for r in rows if r[2] == "spot" and r[3] == 0.011]


def test_instance_type_gauges_set():
    def case(m):
        catalog = m.gen.generate_catalog(3)
        provider = m.provider.CloudProvider(m.fake.FakeCloud(), catalog)
        provider.get_instance_types()
        metrics = importlib.import_module(f"{m.name}.utils.metrics")
        g = metrics.instance_type_cpu()
        assert g.value({"instance_type": catalog[0].name}) > 0
        return [(it.name, g.value({"instance_type": it.name}),
                 metrics.instance_type_memory().value(
                     {"instance_type": it.name})) for it in catalog]
    assert both(case)


# ---------------------------------------------------------------------------
# tests/test_imagefamily.py
# ---------------------------------------------------------------------------

def image_cloud(m):
    c = m.fake.FakeCloud()
    c.images = [
        m.fake.ImageInfo("img-amd-old", "standard-1.28-amd64-v1", "amd64",
                         100.0),
        m.fake.ImageInfo("img-amd-new", "standard-1.28-amd64-v2", "amd64",
                         200.0),
        m.fake.ImageInfo("img-arm-new", "standard-1.28-arm64-v2", "arm64",
                         200.0),
        m.fake.ImageInfo("img-deprecated", "old", "amd64", 300.0,
                         deprecated=True),
    ]
    return c


def image_provider(m, cloud):
    params = m.services.FakeParameterStore()
    params.parameters = {
        "/karpenter-tpu/images/standard/1.28/amd64/latest": "img-amd-new",
        "/karpenter-tpu/images/standard/1.28/arm64/latest": "img-arm-new",
    }
    vp = m.version.VersionProvider(m.services.FakeControlPlane(version="1.28"))
    return m.imagefamily.ImageProvider(cloud, params, vp)


def test_standard_family_mime_merge():
    def case(m):
        out = m.imagefamily.generate_user_data(
            "standard", "k", "https://ep",
            custom="#!/bin/bash\necho custom-hook")
        parts = [p for p in email.message_from_string(out).walk()
                 if p.get_content_maintype() != "multipart"]
        assert len(parts) == 2
        assert "custom-hook" in parts[0].get_payload()
        assert "/opt/node/bootstrap.sh" in parts[1].get_payload()
        assert "--cluster k" in parts[1].get_payload()
        return out
    both(case)


def test_standard_family_passes_labels_taints_maxpods():
    def case(m):
        out = m.imagefamily.generate_user_data(
            "standard", "k", "https://ep", labels={"team": "a"},
            taints=[m.taints.Taint("gpu", "NoSchedule", "true")], max_pods=58)
        assert "--node-labels team=a" in out
        assert "--register-with-taints gpu=true:NoSchedule" in out
        assert "--max-pods 58" in out
        return out
    both(case)


def test_mime_custom_input_reparsed():
    def case(m):
        custom = m.imagefamily.merge_mime("echo pre", "echo ignored")
        out = m.imagefamily.generate_user_data("standard", "k", "https://ep",
                                               custom=custom)
        payloads = [p.get_payload()
                    for p in email.message_from_string(out).walk()
                    if p.get_content_maintype() != "multipart"]
        assert any("echo pre" in p for p in payloads)
        assert any("/opt/node/bootstrap.sh" in p for p in payloads)
        return out
    both(case)


def test_config_family_merge_generated_wins():
    def case(m):
        return m.imagefamily.generate_user_data(
            "config", "k", "https://ep",
            custom='cluster.name = "evil"\nmy.setting = "1"')
    out = both(case)
    assert 'cluster.name = "k"' in out and 'my.setting = "1"' in out


def test_config_taints_and_labels():
    def case(m):
        return m.imagefamily.generate_user_data(
            "config", "k", "https://ep", labels={"a": "b"},
            taints=[m.taints.Taint("t", "NoExecute", "v")], max_pods=10)
    out = both(case)
    assert 'node.labels.a = "b"' in out
    assert 'node.taints.t = "v:NoExecute"' in out
    assert 'node.max-pods = "10"' in out


def test_custom_family_verbatim():
    assert both(lambda m: m.imagefamily.generate_user_data(
        "custom", "k", "e", custom="raw")) == "raw"


def test_merge_config_parsing():
    assert both(lambda m: m.imagefamily.merge_config(
        'a = "1"\n# comment\nbad line\n', {"b": "2"})) == 'a = "1"\nb = "2"\n'


def test_resolves_published_latest_per_arch():
    def case(m):
        return sorted(i.id for i in image_provider(m, image_cloud(m)).get(
            m.objects.NodeClass()))
    assert both(case) == ["img-amd-new", "img-arm-new"]


def test_selector_overrides_published():
    def case(m):
        return [i.id for i in image_provider(m, image_cloud(m)).get(
            m.objects.NodeClass(image_selector={"id": "img-amd-old"}))]
    assert both(case) == ["img-amd-old"]


def test_selector_skips_deprecated():
    assert both(lambda m: image_provider(m, image_cloud(m)).get(
        m.objects.NodeClass(image_selector={"name": "old"}))) == []


def test_unknown_family_resolves_nothing():
    assert both(lambda m: image_provider(m, image_cloud(m)).get(
        m.objects.NodeClass(image_family="nope"))) == []


def test_map_to_instance_types_newest_per_arch():
    def case(m):
        catalog = m.gen.generate_catalog(10)
        imgs = [i for i in sorted(image_cloud(m).images,
                                  key=lambda i: -i.creation_ts)
                if not i.deprecated]
        mapping = m.imagefamily.map_to_instance_types(imgs, catalog)
        return {k: [it.name for it in v] for k, v in mapping.items()}
    mapping = both(case)
    assert set(mapping) == {"img-amd-new"}
    assert len(mapping["img-amd-new"]) == 10


def test_resolve_groups_and_generates_userdata():
    def case(m):
        r = m.imagefamily.Resolver(image_provider(m, image_cloud(m)), "kc",
                                   "https://ep")
        specs = r.resolve(m.objects.NodeClass(user_data="echo hi"),
                          m.gen.generate_catalog(5), labels={"l": "v"})
        assert len(specs) == 1
        spec = specs[0]
        assert "echo hi" in spec.user_data
        assert "--node-labels l=v" in spec.user_data
        return (spec.image.id, [it.name for it in spec.instance_types],
                spec.user_data, spec.block_device_gib, spec.metadata_options)
    image, types, _, _, _ = both(case)
    assert image == "img-amd-new" and len(types) == 5


def test_resolve_no_images_raises():
    def case(m):
        r = m.imagefamily.Resolver(image_provider(m, image_cloud(m)), "kc",
                                   "https://ep")
        with pytest.raises(m.fake.CloudError):
            r.resolve(m.objects.NodeClass(image_family="nope"),
                      m.gen.generate_catalog(3))
    both(case)


def lt_provider(m, cloud, ip=None):
    r = m.imagefamily.Resolver(ip or image_provider(m, cloud), "kc",
                               "https://ep")
    return m.launchtemplate.LaunchTemplateProvider(cloud, r, "kc")


def test_ensure_all_creates_once():
    def case(m):
        cloud = image_cloud(m)
        p = lt_provider(m, cloud)
        catalog = m.gen.generate_catalog(4)
        nc = m.objects.NodeClass()
        out = p.ensure_all(nc, catalog)
        calls = [cloud.calls["create_launch_template"]]
        p.ensure_all(nc, catalog)  # cached
        calls.append(cloud.calls["create_launch_template"])
        return ([(o.template.name, o.template.image_id,
                  [it.name for it in o.instance_types]) for o in out], calls)
    out, calls = both(case)
    assert len(out) == 1 and out[0][1] == "img-amd-new"
    assert len(out[0][2]) == 4 and calls == [1, 1]


def test_different_userdata_different_template():
    def case(m):
        cloud = image_cloud(m)
        p = lt_provider(m, cloud)
        catalog = m.gen.generate_catalog(2)
        p.ensure_all(m.objects.NodeClass(), catalog)
        p.ensure_all(m.objects.NodeClass(user_data="echo different"), catalog)
        return sorted(cloud.launch_templates)
    assert len(both(case)) == 2


def test_invalidate_recreates_after_cloud_loss():
    def case(m):
        cloud = image_cloud(m)
        p = lt_provider(m, cloud)
        catalog = m.gen.generate_catalog(2)
        name = p.ensure_all(m.objects.NodeClass(), catalog)[0].template.name
        cloud.delete_launch_template(name)
        p.invalidate(name)
        p.ensure_all(m.objects.NodeClass(), catalog)
        assert name in cloud.launch_templates
        return name, cloud.calls["create_launch_template"]
    both(case)


def test_hydrate_cache():
    def case(m):
        cloud = image_cloud(m)
        lt_provider(m, cloud).ensure_all(m.objects.NodeClass(),
                                         m.gen.generate_catalog(2))
        p2 = lt_provider(m, cloud)
        n = p2.hydrate_cache()
        p2.ensure_all(m.objects.NodeClass(), m.gen.generate_catalog(2))
        return n, cloud.calls["create_launch_template"]
    assert both(case) == (1, 1)


def test_already_exists_race_recovers():
    def case(m):
        cloud = image_cloud(m)
        out1 = lt_provider(m, cloud).ensure_all(m.objects.NodeClass(),
                                                m.gen.generate_catalog(2))
        out2 = lt_provider(m, cloud).ensure_all(m.objects.NodeClass(),
                                                m.gen.generate_catalog(2))
        assert out1[0].template.name == out2[0].template.name
        return out2[0].template.name
    both(case)


def test_delete_all_only_touches_own_nodeclass():
    def case(m):
        cloud = image_cloud(m)
        p = lt_provider(m, cloud)
        catalog = m.gen.generate_catalog(2)
        p.ensure_all(m.objects.NodeClass(name="a"), catalog)
        p.ensure_all(m.objects.NodeClass(name="b", user_data="echo b"),
                     catalog)
        assert len(cloud.launch_templates) == 2
        n = p.delete_all(m.objects.NodeClass(name="a"))
        remaining = list(cloud.launch_templates.values())
        return n, [lt.tags["karpenter.sh/nodeclass"] for lt in remaining]
    assert both(case) == (1, ["b"])


def test_identical_specs_get_distinct_templates():
    def case(m):
        cloud = image_cloud(m)
        p = lt_provider(m, cloud)
        catalog = m.gen.generate_catalog(2)
        p.ensure_all(m.objects.NodeClass(name="a"), catalog)
        p.ensure_all(m.objects.NodeClass(name="b"), catalog)
        n = [len(cloud.launch_templates)]
        p.delete_all(m.objects.NodeClass(name="a"))
        n.append(len(cloud.launch_templates))
        return n
    assert both(case) == [2, 1]


# ---------------------------------------------------------------------------
# tests/test_batcher.py
# ---------------------------------------------------------------------------

def _concurrent(fn, args_list):
    """Run fn(*args) from N threads; return results in call order."""
    results = [None] * len(args_list)
    errors = [None] * len(args_list)

    def run(i, args):
        try:
            results[i] = fn(*args)
        except BaseException as e:  # noqa: BLE001 (checked by callers)
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i, a))
               for i, a in enumerate(args_list)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    return results, errors


def make_batcher(m, executor, idle=0.03, max_timeout=0.5, max_items=100,
                 hasher=lambda r: "all", clock=None):
    kw = {} if clock is None else {"clock": clock}
    return m.batcher.Batcher(m.batcher.Options(
        name="test", idle_timeout=idle, max_timeout=max_timeout,
        max_items=max_items, request_hasher=hasher,
        batch_executor=executor), **kw)


def test_same_hash_merges_into_one_call():
    def case(m):
        calls = []

        def execute(reqs):
            calls.append(sorted(reqs))
            return [r * 10 for r in reqs]
        results, errors = _concurrent(make_batcher(m, execute).add,
                                      [(1,), (2,), (3,)])
        assert errors == [None] * 3
        return sorted(results), calls
    assert both(case) == ([10, 20, 30], [[1, 2, 3]])


def test_each_caller_gets_own_result():
    def case(m):
        b = make_batcher(m, lambda reqs: [r + 100 for r in reqs])
        return _concurrent(b.add, [(i,) for i in range(20)])[0]
    assert both(case) == [i + 100 for i in range(20)]


def test_distinct_hashes_batch_separately():
    def case(m):
        calls = []

        def execute(reqs):
            calls.append(list(reqs))
            return list(reqs)
        b = make_batcher(m, execute, hasher=lambda r: r % 2)
        _concurrent(b.add, [(i,) for i in range(6)])
        return sorted(sorted(c) for c in calls)
    assert both(case) == [[0, 2, 4], [1, 3, 5]]


def test_max_items_closes_window_immediately():
    def case(m):
        calls = []

        def execute(reqs):
            calls.append(list(reqs))
            return list(reqs)
        b = make_batcher(m, execute, idle=5.0, max_timeout=5.0, max_items=4)
        t0 = time.monotonic()
        _, errors = _concurrent(b.add, [(i,) for i in range(4)])
        assert time.monotonic() - t0 < 2.0
        return errors == [None] * 4, len(calls)
    assert both(case) == (True, 1)


def test_max_timeout_bounds_continuous_stream():
    def case(m):
        calls = []

        def execute(reqs):
            calls.append(list(reqs))
            return list(reqs)
        b = make_batcher(m, execute, idle=0.05, max_timeout=0.15)
        stop = time.monotonic() + 0.4
        threads, i = [], 0
        while time.monotonic() < stop:
            t = threading.Thread(target=b.add, args=(i,))
            t.start()
            threads.append(t)
            i += 1
            time.sleep(0.02)
        for t in threads:
            t.join(timeout=10)
        return len(calls) >= 2, sum(len(c) for c in calls) == i
    assert both(case) == (True, True)


def test_executor_error_fans_back_to_all_callers():
    def case(m):
        def execute(reqs):
            raise RuntimeError("boom")
        _, errors = _concurrent(make_batcher(m, execute).add, [(1,), (2,)])
        return [type(e).__name__ for e in errors]
    assert both(case) == ["RuntimeError", "RuntimeError"]


def test_result_count_mismatch_is_an_error():
    def case(m):
        _, errors = _concurrent(make_batcher(m, lambda reqs: [1]).add,
                                [(1,), (2,)])
        return [type(e).__name__ for e in errors]
    assert both(case) == ["RuntimeError", "RuntimeError"]


def test_stats_recorded():
    def case(m):
        b = make_batcher(m, lambda reqs: list(reqs))
        _concurrent(b.add, [(1,), (2,)])
        return (b.stats.batches, b.stats.requests, list(b.stats.sizes),
                len(b.stats.window_durations))
    assert both(case) == (1, 2, [2], 1)


def _overrides(m):
    return (m.fake.FleetOverride("m5.large", "zone-a", "on-demand", 0.096),)


def test_merges_identical_requests_into_one_fleet_call():
    def case(m):
        cloud = m.fake.FakeCloud()
        b = m.batcher.CreateFleetBatcher(cloud, idle=0.03)
        results, errors = _concurrent(
            b.create_fleet, [(_overrides(m), {"k": "v"})] * 5)
        assert errors == [None] * 5
        ids = [r.instances[0].id for r in results]
        return cloud.calls["create_fleet"], len(set(ids)), sorted(ids)
    assert both(case)[:2] == (1, 5)


def test_different_shapes_do_not_merge():
    def case(m):
        cloud = m.fake.FakeCloud()
        b = m.batcher.CreateFleetBatcher(cloud, idle=0.03)
        other = (m.fake.FleetOverride("c5.xlarge", "zone-b", "spot", 0.068),)
        _concurrent(b.create_fleet, [(_overrides(m), {}), (other, {})])
        return cloud.calls["create_fleet"]
    assert both(case) == 2


def test_shortfall_callers_get_errors_not_instances():
    def case(m):
        cloud = m.fake.FakeCloud()
        cloud.insufficient_capacity_pools.add(
            ("on-demand", "m5.large", "zone-a"))
        b = m.batcher.CreateFleetBatcher(cloud, idle=0.03)
        results, errors = _concurrent(b.create_fleet,
                                      [(_overrides(m), {})] * 3)
        assert errors == [None] * 3
        return [(len(r.instances), [e.code for e in r.errors])
                for r in results]
    assert both(case) == [(0, ["InsufficientInstanceCapacity"])] * 3


def test_describe_unions_and_fans_back():
    def case(m):
        cloud = m.fake.FakeCloud()
        ids = [i.id for i in cloud.create_fleet(list(_overrides(m)),
                                                count=4).instances]
        cloud.calls["describe_instances"] = 0
        b = m.batcher.DescribeInstancesBatcher(cloud, idle=0.03)
        results, errors = _concurrent(b.describe_instances,
                                      [(ids[:2],), (ids[2:],)])
        assert errors == [None, None]
        assert sorted(i.id for i in results[0]) == sorted(ids[:2])
        assert sorted(i.id for i in results[1]) == sorted(ids[2:])
        return cloud.calls["describe_instances"], ids
    assert both(case)[0] == 1


def test_terminate_unions():
    def case(m):
        cloud = m.fake.FakeCloud()
        ids = [i.id for i in cloud.create_fleet(list(_overrides(m)),
                                                count=4).instances]
        b = m.batcher.TerminateInstancesBatcher(cloud, idle=0.03)
        results, errors = _concurrent(b.terminate_instances,
                                      [(ids[:2],), (ids[2:],)])
        assert errors == [None, None]
        assert sorted(results[0] + results[1]) == sorted(ids)
        return cloud.calls["terminate_instances"], cloud.running()
    assert both(case) == (1, [])


def test_passthrough_and_batched_paths():
    def case(m):
        cloud = m.fake.FakeCloud()
        bc = m.batcher.BatchedCloud(cloud, idle=0.03)
        n = [len(bc.create_fleet(list(_overrides(m)), count=3).instances)]
        results, errors = _concurrent(bc.create_fleet,
                                      [(list(_overrides(m)),)] * 2)
        assert errors == [None, None]
        n += [len(r.instances) for r in results]
        n.append(len(bc.describe_instances()))
        assert bc.running() and hasattr(bc, "interrupt")
        return n
    assert both(case) == [3, 1, 1, 5]


def test_fake_clock_window_closes_when_clock_advances():
    def case(m):
        t = [0.0]
        calls = []
        b = make_batcher(m, lambda reqs: [calls.append(len(reqs))
                                          or len(reqs)] * len(reqs),
                         idle=10.0, max_timeout=60.0, clock=lambda: t[0])
        start = time.monotonic()
        results, errors = [None], [None]

        def caller():
            try:
                results[0] = b.add("x")
            except BaseException as e:  # noqa: BLE001
                errors[0] = e
        th = threading.Thread(target=caller)
        th.start()
        time.sleep(0.05)            # window open, fake deadline 10 s away
        assert results[0] is None
        t[0] = 11.0                 # the fake idle deadline passes
        th.join(timeout=5)
        assert time.monotonic() - start < 5.0
        return errors[0], results[0], calls
    assert both(case) == (None, 1, [1])


def test_real_clock_still_sleeps_full_window():
    def case(m):
        b = make_batcher(m, lambda reqs: list(reqs), idle=0.05)
        start = time.monotonic()
        out = b.add("x")
        return out, 0.04 <= time.monotonic() - start < 2.0
    assert both(case) == ("x", True)


def test_wrapped_real_clock_does_not_busy_poll():
    def case(m):
        calls = [0]

        def wrapped():
            calls[0] += 1
            return time.monotonic() + 5000.0   # offset real clock
        b = make_batcher(m, lambda reqs: list(reqs), idle=0.2,
                         max_timeout=1.0, clock=wrapped)
        return b.add("x"), calls[0] < 50
    assert both(case) == ("x", True)


def test_fake_clock_step_jump_does_not_buy_real_sleep():
    def case(m):
        t = [0.0]
        b = make_batcher(m, lambda reqs: list(reqs), idle=10.0,
                         max_timeout=60.0, clock=lambda: t[0])
        start = time.monotonic()
        done = threading.Event()
        out = [None]

        def caller():
            out[0] = b.add("x")
            done.set()
        threading.Thread(target=caller).start()
        for _ in range(11):
            time.sleep(0.02)
            t[0] += 1.0
        assert done.wait(timeout=5.0), "flusher stalled on a real-time sleep"
        return out[0], time.monotonic() - start < 5.0
    assert both(case) == ("x", True)


# ---------------------------------------------------------------------------
# tests/test_nodeclass.py: the controller and admission
# ---------------------------------------------------------------------------

def nodeclass_env(m):
    cloud = m.fake.FakeCloud()
    cloud.subnets = [m.fake.SubnetInfo("subnet-a", "zone-a", 10, {"team": "x"}),
                     m.fake.SubnetInfo("subnet-b", "zone-b", 99, {"team": "x"})]
    cloud.security_groups = [m.fake.SecurityGroupInfo("sg-1", "nodes",
                                                      {"team": "x"})]
    cloud.images = [m.fake.ImageInfo("img-1", "std", "amd64", 100.0)]
    params = m.services.FakeParameterStore()
    params.parameters = {
        "/karpenter-tpu/images/standard/1.28/amd64/latest": "img-1"}
    iam = m.services.FakeIAM()
    cluster = m.state.Cluster()
    ctrl = m.nodeclass.NodeClassController(
        subnets=m.subnet.SubnetProvider(cloud),
        security_groups=m.securitygroup.SecurityGroupProvider(cloud),
        images=m.imagefamily.ImageProvider(
            cloud, params, m.version.VersionProvider(
                m.services.FakeControlPlane(version="1.28"))),
        instance_profiles=m.instanceprofile.InstanceProfileProvider(iam, "kc"),
        cluster=cluster)
    return cloud, iam, cluster, ctrl


def test_reconcile_resolves_status():
    def case(m):
        cloud, iam, cluster, ctrl = nodeclass_env(m)
        nc = m.objects.NodeClass(subnet_selector={"team": "x"},
                                 security_group_selector={"team": "x"},
                                 role="node-role")
        res = ctrl.reconcile(nc)
        assert res.resolved
        assert nc.hash_annotation == m.nodeclass.static_hash(nc)
        return (nc.status_subnets, nc.status_zones, nc.status_security_groups,
                nc.status_images, nc.status_instance_profile,
                iam.get_instance_profile(nc.status_instance_profile)["_roles"],
                nc.hash_annotation)
    out = both(case)
    assert out[:4] == (["subnet-b", "subnet-a"], ["zone-a", "zone-b"],
                       ["sg-1"], ["img-1"])
    assert out[4] and out[5] == "node-role"


def test_reconcile_reports_unresolved():
    def case(m):
        _, _, _, ctrl = nodeclass_env(m)
        res = ctrl.reconcile(m.objects.NodeClass(
            subnet_selector={"team": "nope"}))
        return res.resolved, res.errors
    resolved, errors = both(case)
    assert not resolved and any("subnet" in e for e in errors)


def test_hash_changes_with_spec():
    def case(m):
        h = m.nodeclass.static_hash
        a, b = m.objects.NodeClass(user_data="x"), m.objects.NodeClass(
            user_data="y")
        assert h(a) != h(b)
        assert h(a) == h(m.objects.NodeClass(user_data="x"))
        return h(a), h(b)
    both(case)


def test_finalize_blocked_by_claims():
    def case(m):
        _, iam, cluster, ctrl = nodeclass_env(m)
        nc = m.objects.NodeClass(name="gpu", role="r")
        ctrl.reconcile(nc)
        claim = m.objects.NodeClaim(nodepool="p", node_class_ref="gpu")
        cluster.nodeclaims[claim.name] = claim
        seen = [ctrl.finalize(nc)]
        claim.terminating = True
        seen += [ctrl.finalize(nc), nc.status_instance_profile,
                 dict(iam.profiles)]
        return seen
    assert both(case) == [False, True, "", {}]


def admission(m, fn, *a):
    """'ok' when `fn(*a)` admits, else the ValidationError's message."""
    try:
        fn(*a)
        return "ok"
    except m.nodeclass.ValidationError as e:
        return str(e)


def test_defaulting():
    def case(m):
        nc = m.objects.NodeClass(image_family="", block_device_gib=0)
        m.nodeclass.default_nodeclass(nc)
        pool = m.objects.NodePool()
        pool.disruption.consolidation_policy = ""
        pool.template.node_class_ref = ""
        m.nodeclass.default_nodepool(pool)
        return (nc.image_family, nc.block_device_gib,
                pool.disruption.consolidation_policy,
                pool.template.node_class_ref)
    assert both(case) == ("standard", 20, "WhenUnderutilized", "default")


def test_validate_ok():
    assert both(lambda m: admission(m, m.nodeclass.validate_nodeclass,
                                    m.objects.NodeClass())) == "ok"


def test_validate_unknown_family():
    out = both(lambda m: admission(m, m.nodeclass.validate_nodeclass,
                                   m.objects.NodeClass(
                                       image_family="windows-nt")))
    assert "unknown image family" in out


def test_validate_custom_needs_selector():
    def case(m):
        v = m.nodeclass.validate_nodeclass
        return (admission(m, v, m.objects.NodeClass(image_family="custom")),
                admission(m, v, m.objects.NodeClass(
                    image_family="custom", image_selector={"id": "img-9"})))
    bad, good = both(case)
    assert bad != "ok" and good == "ok"


def test_validate_empty_selector_key():
    out = both(lambda m: admission(m, m.nodeclass.validate_nodeclass,
                                   m.objects.NodeClass(
                                       subnet_selector={"": "x"})))
    assert "empty selector key" in out


def test_validate_nodepool_weight_and_policy():
    def case(m):
        v, o = m.nodeclass.validate_nodepool, m.objects
        return [admission(m, v, o.NodePool()),
                admission(m, v, o.NodePool(weight=101)),
                admission(m, v, o.NodePool(disruption=o.Disruption(
                    consolidation_policy="Sometimes"))),
                admission(m, v, o.NodePool(disruption=o.Disruption(
                    consolidation_policy="WhenEmpty")))]
    out = both(case)
    assert out[0] == "ok" and all(x != "ok" for x in out[1:])


def test_validate_nodepool_restricted_labels():
    def case(m):
        return admission(m, m.nodeclass.validate_nodepool, m.objects.NodePool(
            template=m.objects.NodePoolTemplate(
                labels={m.labels.NODEPOOL: "evil"})))
    assert "restricted" in both(case)


def test_validate_nodeclass_update_role_immutable():
    """The update-time rule `Operator.apply` enforces (tests/
    test_operator.py test_apply_enforces_role_immutability), on the
    admission function itself."""
    def case(m):
        o, v = m.objects, m.nodeclass.validate_nodeclass_update
        return (admission(m, v, o.NodeClass(role="r1"),
                          o.NodeClass(role="r1", user_data="v2")),
                admission(m, v, o.NodeClass(role="r1"), o.NodeClass(role="r2")))
    assert both(case) == ("ok", "immutable field changed: role")
