#!/usr/bin/env python3
"""Smoke run of karpenter_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; the last line is printed only when all
pass):

  1. probe   — the card's name and power limit (nvidia-smi), torch, CUDA
               and nvcc versions;
  2. build   — compile csrc/*.cu with nvcc for sm_90a at first use and
               print the ptxas register / shared-memory lines;
  3. kernels — each kernel (K1 precompute, K2 scan, K3 assign decode,
               K4 aggregate) against its plain PyTorch version on the card,
               at the headline shapes, on the real tensorized batch and on
               seeded perturbations of it (score overflow, pool ranks,
               hostname caps, slot exhaustion, overcommitted existing
               nodes).  Integers must be equal; the aggregate's float32
               total_cost may differ by relative 1e-5 (summation order);
  4. main path — tensorize + solve_classpack(guide=None) on the card, 50k
               pods × 600 instance types, decode on and off, with and
               without 512 existing nodes; every plan must reproduce the
               golden digest the JAX package computes on the CPU, and every
               kernel's launch counter must have moved; then warm p50
               timings and per-kernel CUDA-event times.

Prints the kernel table as one JSON line, the card's name and power limit,
and last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

MEM_BW = 3.35e12        # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
F32_PEAK = 67e12        # H100 SXM float32 outside the tensor cores, op/s
REL_TOL = 1e-5          # aggregate total_cost: float32 sums in another order
SEED = 7


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# phase 1: probe
# ---------------------------------------------------------------------------

def probe(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    from karpenter_tpu_torch._build import find_nvcc
    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60)
    nvcc_line = [l for l in nvcc.stdout.splitlines() if l.strip()][-1]
    log(f"[probe] card: {card}")
    log(f"[probe] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"[probe] nvcc: {nvcc_line}")
    return card


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def build():
    from karpenter_tpu_torch import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.3f} s")
    for stem in libs:
        for line in _build.build_log(stem).splitlines():
            if "ptxas" in line and ("Used" in line or "spill" in line
                                    or "Compiling" in line):
                log("[build]   " + line.strip())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def headline_problem():
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.api.objects import NodePool
    from karpenter_tpu_torch.catalog.generate import generate_catalog
    from karpenter_tpu_torch.ops.tensorize import tensorize
    pods = workloads.build_pods(
        rng=np.random.default_rng(workloads.HEADLINE_SEED),
        **workloads.HEADLINE)
    catalog = generate_catalog(workloads.HEADLINE_TYPES)
    return pods, catalog, [NodePool()], tensorize(pods, catalog, [NodePool()])


def existing(problem):
    from karpenter_tpu_torch import workloads
    a, u, c = workloads.existing_nodes(
        problem, workloads.HEADLINE_EXISTING,
        np.random.default_rng(workloads.EXISTING_SEED))
    return dict(existing_alloc=a, existing_used=u, existing_compat=c)


def perturbed(low, rng):
    """Seeded variant of a lowered batch: scrambled prices with a few near
    float32 max (price × nodes overflows and clamps at SCORE_CAP), a second
    pool-weight rank, hostname caps, scaled counts."""
    import dataclasses
    price = low.price_p.copy()
    fin = np.isfinite(price)
    price[fin] *= rng.uniform(0.5, 2.0, fin.sum()).astype(np.float32)
    hot = fin & (rng.random(price.shape[0]) < 0.05)
    price[hot] = np.float32(3e38)
    rank = low.rank_p.copy()
    rank[fin & (rng.random(rank.shape[0]) < 0.1)] = 1
    cap = low.cap_p.copy()
    real = low.cnt_p > 0
    capped = real & (rng.random(cap.shape[0]) < 0.1)
    cap[capped] = rng.integers(1, 4, capped.sum())
    cnt = low.cnt_p.copy()
    cnt[real] = (cnt[real] * rng.uniform(0.5, 1.5, real.sum())).astype(np.int32) + 1
    return dataclasses.replace(low, price_p=price, rank_p=rank, cap_p=cap,
                               cnt_p=cnt)


def compare_kernels(torch, problem, ex):
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    from karpenter_tpu_torch.ops.classpack import lower_problem
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    base = lower_problem(problem)
    with_ex = lower_problem(problem, **ex)
    cases = [("real", base, None), ("real+existing", with_ex, None),
             ("seeded", perturbed(base, rng), None),
             ("seeded+existing", perturbed(with_ex, rng), None),
             ("slot-exhaustion K=1024", base, 1024)]
    err = {k: 0.0 for k in ck.KERNELS}
    shapes = None
    for name, low, k_override in cases:
        t = lambda a: None if a is None else torch.tensor(a, device=dev)  # noqa: E731
        req, cnt, packed, cap = map(t, (low.req_p, low.cnt_p, low.packed,
                                        low.cap_p))
        alloc, price, rank = map(t, (low.alloc_i, low.price_p, low.rank_p))
        iopt, iused = t(low.init_option), t(low.init_used)
        K = k_override or low.K
        if k_override and iopt is not None:
            iopt, iused = iopt[:K].contiguous(), iused[:K].contiguous()
        # K1
        m, ok = ck.classpack_precompute(req, cap, packed, alloc, price, rank)
        m0, ok0 = ck.classpack_precompute_plain(req, cap, packed, alloc,
                                                price, rank)
        torch.cuda.synchronize()
        check(torch.equal(m, m0) and torch.equal(ok, ok0),
              f"K1 precompute differs from plain ({name})")
        # K2, emitting takes and not
        outs = {}
        for emit in (True, False):
            got = ck.classpack_scan(req, cnt, packed, cap, alloc, price, m, ok,
                                    iopt, iused, K, emit)
            ref = ck.classpack_scan_plain(req, cnt, packed, cap, alloc, price,
                                          m0, ok0, iopt, iused, K, emit)
            torch.cuda.synchronize()
            for a, b, what in zip(got, ref, ("slot_option", "slot_used",
                                             "n_open", "n_unsched", "takes")):
                check(torch.equal(a.to(b.dtype), b),
                      f"K2 scan {what} differs (emit={emit}, {name})")
            outs[emit] = got
        slot_option, _, n_open, n_unsched, takes = outs[True]
        # K3
        a = ck.classpack_assign_decode(takes, cnt, low.Ppad)
        a0 = ck.classpack_assign_decode_plain(takes, cnt, low.Ppad)
        torch.cuda.synchronize()
        check(a.dtype == a0.dtype and torch.equal(a, a0),
              f"K3 assign decode differs ({name})")
        # K4
        g = ck.classpack_aggregate(slot_option, price, n_open, n_unsched)
        g0 = ck.classpack_aggregate_plain(slot_option, price, n_open, n_unsched)
        torch.cuda.synchronize()
        check(torch.equal(g[1:], g0[1:]),
              f"K4 aggregate counts differ ({name})")
        tc, tc0 = float(g[0]), float(g0[0])
        check(math.isfinite(tc) and abs(tc - tc0) <= REL_TOL * max(abs(tc0), 1e-30),
              f"K4 total_cost {tc} vs {tc0} ({name})")
        err["classpack_aggregate"] = max(err["classpack_aggregate"],
                                         abs(tc - tc0))
        log(f"[kernels] {name}: Cpad={low.req_p.shape[0]} "
            f"Opad={low.price_p.shape[0]} K={K} R={low.req_p.shape[1]} "
            f"Ppad={low.Ppad} n_open={int(n_open)} n_unsched={int(n_unsched)} "
            f"-> K1-K4 equal to plain (total_cost |d|={abs(tc - tc0):.3g})")
        if name == "real":
            shapes = dict(req=req, cnt=cnt, packed=packed, cap=cap,
                          alloc=alloc, price=price, rank=rank, m=m, ok=ok,
                          K=K, Ppad=low.Ppad, takes=takes,
                          slot_option=slot_option, n_open=n_open,
                          n_unsched=n_unsched)
    return err, shapes


# ---------------------------------------------------------------------------
# phase 4: main path, fingerprints, timings
# ---------------------------------------------------------------------------

def main_path(torch, pods, catalog, pools, problem, ex):
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    from karpenter_tpu_torch.ops.classpack import solve_classpack
    from karpenter_tpu_torch.ops.tensorize import tensorize
    ck.reset_launches()
    t0 = time.perf_counter()
    prob = tensorize(pods, catalog, pools)
    results = {}
    for n_ex, kw in ((0, {}), (workloads.HEADLINE_EXISTING, ex)):
        for decode in (True, False):
            res = solve_classpack(prob, guide=None, decode=decode, **kw)
            results[(n_ex, decode)] = res
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    log(f"[main] four headline solves in {wall:.3f} s (first use, incl. "
        f"uploads); launches {launches}")
    for name in ck.KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the main path")
    for key, res in results.items():
        digest, total = workloads.plan_digest(prob, res, decode=key[1])
        gold, gold_total = workloads.GOLDEN[key]
        check(digest == gold, f"plan digest {key} {digest} != golden {gold}")
        check(abs(total - gold_total) <= REL_TOL * gold_total,
              f"total_price {key} {total} vs golden {gold_total}")
        check(math.isfinite(total) and len(res.nodes) > 0, f"empty plan {key}")
        log(f"[main] E={key[0]} decode={key[1]}: {len(res.nodes)} nodes, "
            f"{len(res.unschedulable)} unschedulable, "
            f"{len(res.existing_assignments)} on existing, total "
            f"{total!r} — golden digest matches")
    return launches, prob


def p50_ms(fn, iters=7, sync=None):
    xs = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        if sync:
            sync()
        xs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(xs), xs


def event_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def timings(torch, card, pods, catalog, pools, prob, ex):
    from karpenter_tpu_torch.ops import classpack as cp
    from karpenter_tpu_torch.ops.tensorize import tensorize
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    low = cp.lower_problem(prob)
    pod_args, cat_args, _ = cp.device_args(low, dev)

    def kernels():
        return cp.class_pack_assign_kernel_fresh(*pod_args, *cat_args, low.K,
                                                 low.Ppad)
    assignment, slot_option, _ = kernels()
    a_host, so_host = assignment.cpu().numpy(), slot_option.cpu().numpy()
    out = {}
    out["tensorize"] = p50_ms(lambda: tensorize(pods, catalog, pools))
    out["lower (sort, pad, packbits)"] = p50_ms(lambda: cp.lower_problem(prob))
    out["device args (cache hit: hash + lookup)"] = p50_ms(
        lambda: cp.device_args(low, dev), sync=sync)
    out["kernels (K1+K2+K3, fresh)"] = p50_ms(kernels, sync=sync)
    out["device to host (assignment, slot_option)"] = p50_ms(
        lambda: (assignment.cpu(), slot_option.cpu()))
    out["host decode (rows -> NodeDecisions)"] = p50_ms(
        lambda: cp.decode_plan(prob, low, a_host, so_host))
    out["solve decode=True"] = p50_ms(
        lambda: cp.solve_classpack(prob, guide=None), sync=sync)
    out["solve decode=False"] = p50_ms(
        lambda: cp.solve_classpack(prob, guide=None, decode=False), sync=sync)
    out["solve decode=True E=512"] = p50_ms(
        lambda: cp.solve_classpack(prob, guide=None, **ex), sync=sync)

    def e2e():
        cp.solve_classpack(tensorize(pods, catalog, pools), guide=None)
    out["e2e tensorize+solve decode=True"] = p50_ms(e2e, sync=sync)
    for k, (p50, xs) in out.items():
        log(f"[time] {k}: p50 {p50:.3f} ms over {len(xs)} warm runs "
            f"(min {min(xs):.3f}, max {max(xs):.3f}) on {card}")
    host = out["solve decode=True"][0] - out["kernels (K1+K2+K3, fresh)"][0]
    log(f"[time] host share of the decoded solve (lower + D2H + decode): "
        f"{host:.3f} ms on {card}")
    busy = device_busy(torch, lambda: cp.solve_classpack(prob, guide=None))
    log(f"[trace] decoded solve: device busy {busy['device_ms']:.3f} of "
        f"{busy['wall_ms']:.3f} ms wall per solve, idle share "
        f"{busy['idle_share']:.4f}; by kernel {busy['by_kernel']} on {card}")
    return out


def device_busy(torch, fn, iters=3):
    """Device busy time per call from a torch.profiler trace (CUPTI): the
    sum of CUDA kernel and copy self times over the wall time of `iters`
    synchronised calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    by = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            by[ev.key] = ev.self_device_time_total / 1e3 / iters
    dev = sum(by.values())
    short = {k[:40]: round(v, 4) for k, v in
             sorted(by.items(), key=lambda kv: -kv[1])[:6]}
    return dict(device_ms=dev, wall_ms=wall, idle_share=1 - dev / wall,
                by_kernel=short)


def kernel_table(torch, card, shapes, launches, err):
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    s = shapes
    C, R = s["req"].shape
    O = s["price"].shape[0]
    K, Ppad = s["K"], s["Ppad"]
    OB = s["packed"].shape[1]
    src = "karpenter_tpu_torch/csrc/classpack.cu"
    rows = []

    def row(name, replaces, fn, plain, library, nbytes, nops, iters):
        ms = event_ms(torch, fn, iters)
        plain_ms = event_ms(torch, plain, 1)
        lib_ms = event_ms(torch, library, iters) if library else None
        t_b, t_o = nbytes / MEM_BW * 1e3, nops / F32_PEAK * 1e3
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=err[name], ms=ms,
            plain_ms=plain_ms, bound_ms=max(t_b, t_o),
            bound_by="bytes" if t_b >= t_o else "operations",
            library_ms=lib_ms))
        log(f"[kernel] {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, "
            f"library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
            f"bound {max(t_b, t_o) * 1e3:.3f} us by "
            f"{'bytes' if t_b >= t_o else 'operations'}) on {card}")

    args1 = (s["req"], s["cap"], s["packed"], s["alloc"], s["price"], s["rank"])
    row("classpack_precompute", "karpenter_tpu/ops/classpack.py:75",
        lambda: ck.classpack_precompute(*args1),
        lambda: ck.classpack_precompute_plain(*args1), None,
        C * R * 4 + C * 4 + C * OB + O * R * 4 + O * 8 + C * O * 5,
        C * O * (2 * R + 4), 20)
    args2 = (s["req"], s["cnt"], s["packed"], s["cap"], s["alloc"],
             s["price"], s["m"], s["ok"], None, None, K, True)
    n_open = int(s["n_open"])
    row("classpack_scan", "karpenter_tpu/ops/classpack.py:87",
        lambda: ck.classpack_scan(*args2),
        lambda: ck.classpack_scan_plain(*args2), None,
        C * (R * 4 + 13 + OB) + O * (R * 4 + 4) + C * O * 5
        + K * (4 + R * 4) + C * K * 4 + 8,
        # work this run's data needs: fit over the slots open so far
        # (bounded by the final count) and the score over every option
        C * (n_open * (2 * R + 6) + O * 5), 3)
    flat_i32 = s["takes"].reshape(-1)
    q = torch.arange(Ppad, dtype=torch.int32, device=flat_i32.device)

    def lib3():
        f = torch.cumsum(flat_i32, 0, dtype=torch.int32)
        torch.searchsorted(f, q, right=True)
    row("classpack_assign_decode", "karpenter_tpu/ops/classpack.py:228",
        lambda: ck.classpack_assign_decode(s["takes"], s["cnt"], Ppad),
        lambda: ck.classpack_assign_decode_plain(s["takes"], s["cnt"], Ppad),
        lib3, C * K * 4 + C * 4 + Ppad * (2 if K < 2**15 else 4),
        C * K + Ppad * (int(math.log2(C)) + int(math.log2(K)) + 6), 20)
    opt = s["slot_option"].clamp(min=0).long()
    w = (s["slot_option"] >= 0).float()
    row("classpack_aggregate", "karpenter_tpu/ops/classpack.py:169",
        lambda: ck.classpack_aggregate(s["slot_option"], s["price"],
                                       s["n_open"], s["n_unsched"]),
        lambda: ck.classpack_aggregate_plain(s["slot_option"], s["price"],
                                             s["n_open"], s["n_unsched"]),
        lambda: torch.bincount(opt, weights=w, minlength=O),
        K * 4 + O * 4 + 8 + (3 + O) * 4, K * 3, 50)
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this smoke "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    import karpenter_tpu_torch  # noqa: F401  (fails outside the repo)
    t_start = time.perf_counter()
    card = probe(torch)
    build()
    pods, catalog, pools, problem = headline_problem()
    ex = existing(problem)
    err, shapes = compare_kernels(torch, problem, ex)
    log(f"[kernels] all kernels equal to their plain versions "
        f"({time.perf_counter() - t_start:.1f} s so far)")
    launches, prob = main_path(torch, pods, catalog, pools, problem, ex)
    timings(torch, card, pods, catalog, pools, prob, ex)
    rows = kernel_table(torch, card, shapes, launches, err)
    bad = [m for m in sys.modules if m == "jax" or m == "karpenter_tpu"
           or m.startswith("karpenter_tpu.")]
    check(not bad, f"the port loaded {bad}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
