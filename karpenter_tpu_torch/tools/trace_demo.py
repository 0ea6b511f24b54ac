"""End-to-end tracing walkthrough on the in-memory substrate.

A copy of the JAX package's `tools/trace_demo.py`.  Run it with
`python -m karpenter_tpu_torch.tools.trace_demo`: the operator solves on
the card; `--device cpu` runs the kernels' plain versions on the host, as
the tests do.

Builds an operator against a generated catalog, drives one provisioning
tick (including a deliberately unschedulable pod) and one disruption
reconcile through the controller manager, then fetches `/debug/traces`
over HTTP — the same JSON a production scrape would see — and
pretty-prints each trace tree with durations and annotations, plus the
stuck pod's provenance record from `/debug/pods/<name>`.

Runs with the FlightRecorder gate ON: after the reconciles it trips the
solver degradation ladder once, then fetches the incident index from
`/debug/incidents` and pretty-prints the newest forensic bundle.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request

from ..api import labels as wk
from ..api.objects import Pod
from ..api.resources import CPU, MEMORY, ResourceList
from ..catalog.generate import generate_catalog
from ..cloud.fake import ImageInfo, SecurityGroupInfo, SubnetInfo
from ..operator import ControllerManager, Operator, Options, build_controllers


def pod(name="", cpu_m=500, mem_mib=512, selector=None):
    return Pod(name=name,
               requests=ResourceList({CPU: cpu_m, MEMORY: mem_mib * 2**20}),
               node_selector=dict(selector or {}))


def render(span, depth=0, lines=None):
    lines = [] if lines is None else lines
    ann = " ".join(f"{k}={v}" for k, v in sorted(span["annotations"].items()))
    lines.append(f"{'  ' * depth}{span['name']:<{max(30 - 2 * depth, 1)}} "
                 f"{span['duration_ms']:9.2f}ms"
                 + (f"  [{ann}]" if ann else ""))
    for child in span["children"]:
        render(child, depth + 1, lines)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.tools.trace_demo")
    ap.add_argument("--device", default="cuda",
                    help="where the controllers solve: cuda (the card, the "
                         "default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    clock = [1000.0]
    opts = Options(batch_idle_duration=1.0, batch_max_duration=10.0)
    opts.feature_gates["FlightRecorder"] = True
    op = Operator(opts, catalog=generate_catalog(20),
                  clock=lambda: clock[0], device=args.device)
    op.cloud.subnets = [SubnetInfo("s-a", "zone-a", 100, {}),
                        SubnetInfo("s-b", "zone-b", 100, {})]
    op.cloud.security_groups = [SecurityGroupInfo("sg", "nodes", {})]
    op.cloud.images = [ImageInfo("img-1", "std", "amd64", 1.0)]
    op.params.parameters = {
        "/karpenter-tpu/images/standard/1.28/amd64/latest": "img-1"}
    mgr = ControllerManager(op, build_controllers(op), clock=lambda: clock[0])
    port = mgr.serve_endpoints(metrics_port=0)
    try:
        # one provisioning tick: 12 schedulable pods + one pinned to a zone
        # no offering serves (it gets a provenance record, not a node)
        pods = [pod(name=f"demo-{i}", cpu_m=300 + 137 * i) for i in range(12)]
        stuck = pod(name="stuck-pod", selector={wk.ZONE: "zone-nowhere"})
        op.cluster.add_pods(pods + [stuck])
        mgr.tick()                    # opens the batch window
        clock[0] += 1.1               # idle elapses
        mgr.tick()                    # provisions

        # underutilize every node (keep one pod each so emptiness can't
        # short-circuit the consolidation sweep), wait out node
        # stabilization, then run disruption on its next interval
        keep = set()
        for p in list(op.cluster.pods.values()):
            if p.node_name and p.node_name in keep:
                op.cluster.delete_pod(p)
            elif p.node_name:
                keep.add(p.node_name)
        clock[0] += 600
        mgr.tick()

        traces = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/debug/traces", timeout=10).read())

        print(f"# /debug/traces — {len(traces['traces'])} trace(s), "
              "newest first\n")
        for t in reversed(traces["traces"]):   # oldest first reads better
            print("\n".join(render(t)))
            print()

        prov = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/debug/pods/stuck-pod",
            timeout=10).read())
        print("# /debug/pods/stuck-pod — decision provenance")
        print(f"  constraint: {prov['constraint']}"
              + (f" ({prov['dimension']})" if prov["dimension"] else ""))
        print(f"  message:    {prov['message']}")

        # ?span= prefix filter: only the disruption family of roots
        filtered = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/debug/traces?span=disruption.",
            timeout=10).read())
        print(f"\n# /debug/traces?span=disruption. — "
              f"{len(filtered['traces'])} of {len(traces['traces'])} trace(s)")

        # trip the solver degradation ladder (a watchdog-style timeout
        # demotes immediately) so the flight recorder captures a bundle
        health = getattr(mgr.controllers["provisioning"], "health", None)
        if health is not None and mgr.flight is not None:
            health.report_failure("jax", reason="timeout")
            index = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/debug/incidents",
                timeout=10).read())
            print(f"\n# /debug/incidents — {len(index['bundles'])} "
                  f"bundle(s), by kind {index['by_kind']}")
            newest = index["bundles"][-1]
            bundle = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/debug/incidents/{newest['id']}",
                timeout=10).read())
            print(f"\n# /debug/incidents/{newest['id']} — newest bundle")
            print(f"  kind:    {bundle['kind']}  (detail: "
                  f"{json.dumps(bundle['detail'], sort_keys=True)})")
            print(f"  window:  [{bundle['window'][0]:.0f}, "
                  f"{bundle['window'][1]:.0f}]  "
                  f"ring entries: {bundle['ring_entries']}")
            changed = bundle["metrics"].get("changed", {})
            print(f"  metric deltas over the window: {len(changed)} series")
            for key in sorted(changed)[:8]:
                print(f"    {key:<58} {changed[key]:+g}")
            print(f"  traces captured: {len(bundle['traces'])}; health "
                  f"rungs: "
                  f"{sorted(bundle['health']['solver']['rungs'])}")
        return 0
    finally:
        mgr.stop()


if __name__ == "__main__":
    sys.exit(main())
