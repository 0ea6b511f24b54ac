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
               K1 and K4 are launched twice, bit-equal, and K1 also for m
               alone (with_ok=False, as the sweep calls it).  Then K1 (tiles
               of classes x options, clusters along the options) at each
               main path's shape on seeded inputs with its parity traps —
               the headline (C 256 x O 4096), the live cell's round 2
               (256 x 8192), the consolidation tick (1024 x 512) and, as
               K1s, the megafleet's row 17 (8 x 64 x 512) — twice, bit-equal
               to plain, and for m alone.  Then K2 (one cluster of CTAs per
               shard) on the
               headline batch with every fifth non-empty class emptied and
               one count negative (empty classes between non-empty ones),
               at slot counts whose plans take each cluster size (K = 64,
               256, 512, 1024, 2048, 8192), and at K = 1, 37 and 32 768
               (also over 32 axes: the state in a global slice),
               emitting takes and not, each launched twice, bit-equal to
               its plain version.  Then K3 and K3s (one
               launch per call) on the edge inputs of
               `workloads.assign_decode_edges` (every pod in one class,
               empty classes, all takes zero, padding rows, a truncated
               repeat, a seeded case) at C = 200, K = 8192 and at
               K = 32 768 (int32 slots), K3s on their shard stack and on
               two shards sharing one counts row; K3 also on the inputs
               recorded from the consolidation tick and the provisioning
               cells' rounds (after phase 10);
  4. main path — tensorize + solve_classpack(guide=None) on the card, 50k
               pods × 600 instance types, decode on and off, with and
               without 512 existing nodes; every plan must reproduce the
               golden digest the JAX package computes on the CPU, and every
               kernel's launch counter must have moved; then warm p50
               timings and per-kernel CUDA-event times; the decoded
               solve's profiler trace must show one K3 kernel.
  5. sweep   — K5 (classpack_sweep) against its plain version on the card,
               on the consolidation cell's real arena arrays (the delete
               face at B = 32 and 512, the replace face at B = 128), on
               `workloads.launch_probes` (replace-face rows that launch new
               nodes, whose sweep must also reproduce GOLDEN_LAUNCH_SWEEP)
               and on seeded perturbations (caps masking half the options,
               an all-masked row, zero-count rows, rows that must launch,
               slot exhaustion at a small K), every call launched twice
               and bit-equal; then one row (B = 1) and the replace face
               over K = 8192 slots (a row's state past the shared memory a
               block may opt into: the global layout).
  6. consolidation main path — DisruptionController(...).consolidation_action
               over the 500-node under-utilized fleet at 100 and 500
               candidates, each run with the launch counts set to 0 just
               before and read just after: K1, K2, K3 and K5 must have
               launched in it.  Then the arena's full prefix and singles
               sweeps (not part of a tick); every result must reproduce
               GOLDEN_CONSOLIDATION (the JAX package's, on the CPU).  Then
               the arena build, the warm tick p50, each sweep call's
               CUDA-event time and the tick's device idle share.
  7. pdhg    — the PDHG LP kernel against its plain version (float32, no
               TF32) on the card: the headline's restricted master (captured
               from exact_lp_mix(device=True); both must cap at 20 000
               iterations), the two masters of each `workloads.lp_problems()`
               instance (they converge), random LPs of tests/test_lpsolve.py
               at (20, 5, 8), (80, 20, 30) and one padded to 2048 columns, a
               u with finite and infinite entries, a B = 4 batch against its
               four singles, and a warm-started re-solve: every one of
               them fits the SMs' shared memory and must take the resident
               kernel.  Then a B = 2 batch of the headline master (over the
               shared-memory budget: the streaming kernel), capped at 2000
               iterations.  Criteria: the kernel the launch counter names,
               two launches equal bit for bit, and against the plain
               version the same status, objectives within relative 1e-3, x
               within 2e-2 (of the pod-count scale on the masters),
               iterations within a factor 1.5; the batch's members equal
               their solo launches.
  8. guided main path — the product's default solve_classpack(prob) on the
               headline, cold (mix caches cleared) and warm, with HiGHS
               masters, with device_lp=True (the master caps and demotes
               the ladder one strike) and with an off-tick refinery (the
               cold tick answers the greedy GOLDEN plan, the next tick the
               refined one); every guided plan must reproduce
               GOLDEN_GUIDED (the JAX package's, on the CPU).  Then the LP
               instances as guided solves with device_lp=True (masters
               converge, the ladder stays healthy) against GOLDEN_LP.  Each
               run with the launch counts zeroed just before it.  Then
               timings: cold and warm guided headline, exact_lp_mix with
               HiGHS against the device, the PDHG kernel on each master
               beside its bound (the largest of its HBM, on-chip and
               operations terms, the binding one named), and the warm
               guided headline's device idle share.
  9. slab + ffd — K6 (classpack_slab) against its plain version on random
               slot vectors at K = 256, 2048 and 8192, all rows placed, none
               placed, and one input above the reference's (K+1)·n < 2^31
               guard (K = 8192, n = 300 000); K7 (ffd_scan) against its
               plain version on tests/test_native.py's edge cases (an
               inf-priced only fit, a score overflow, a NaN price, a node
               cap, existing nodes; solve_ffd on the card must also equal
               the host greedy rung there), on seeded P = 4096 scans
               (existing slots, caps, slot exhaustion) and on
               `workloads.FFD_CURSOR_CASES` (rows of one class that differ
               in request, compat row or node cap, invalid rows inside a
               class, a class out of slots: the first-fit cursor resets).
               Outputs equal, the float32 slot usage bit for bit, and two
               launches of K7 equal bit for bit.
 10. provisioning — Provisioner.provision through the four cells of
               `workloads.PROVISION_CELLS` at full width (600 types):
               provision-live-50k-20k (the default Provisioner with
               DeviceDecode: a guided 50k burst, then 20k more against the
               1463-node live cluster, the slab programs with E > 0),
               provision-noguide-50k (lp_guide=False: the fresh slab
               program), provision-small-3x64 (three 64-pod bursts:
               solve_ffd) and provision-ffd-50k (solver="ffd": K7 at
               P = 50 000, K = 2048).  Every round must reproduce
               GOLDEN_PROVISION (the JAX package's, on the CPU), each with
               the launch counts zeroed just before it; the SolverHealth
               ladder and the DecodeHealth breaker must book no failure;
               K6 must launch in the first two cells, K7 in the last two.
               Then warm p50s on the live cell's frozen round-2 state
               (Provisioner.solve, and whole provision() rounds on fresh
               copies with their tensorize / pack / launch split), K7
               against its plain version on every provision-small batch
               (twice, bit-equal) with its card time there, and the times
               of K6, the slab programs (rows 7-8) and K7 (row 11) at the
               cells' own inputs, beside their bounds, plain versions and
               (K6) argsort + scatter_add_.  K7's bound is the largest of
               its bytes, its operations and its row-to-row dependency,
               from the rows' counts (`ffd_counts`: runs, steps, slots a
               first fit tests from its cursor, new nodes) and the card's
               cycles of a least row step and a dependent float32 add,
               measured by `ffd_kernels.step_cycles`.  The slab program's
               trace, with the launch counts read around the same calls,
               gives K6's split by launch and must name no kernel of K6's
               earlier design.
 11. sharded kernels — the shard-batched K1-K4 and K6 and K8 shard_psum
               (one launch over the n = 8 shards of a mesh laid on the card)
               against their plain versions, and shard for shard against n
               serial launches of the single-device kernels, on the real
               inputs of rows 13-17 and of the provision-sharded-50k-20k
               cell's row 17 in both rounds (each launched twice,
               bit-equal; recorded in phase 12's counted
               runs, which run first) and on seeded perturbations: two
               empty shards, slot
               exhaustion in one shard only (its pods x4 at K = 2048), all
               512 existing columns owned by one shard (overcommitted ones
               among them), K8 on the 2 x 4 host mesh against the flat 8,
               and n = 1.  K6s also on each row-17 input's slots as int16
               and int32, twice each.  Integers equal, K8 bit for bit, K4's
               cost within relative 1e-5.
 12. sharded paths — the megafleet (solve_partitioned on
               `workloads.megafleet_problem(8)`, 1 000 000 pods: decode=False,
               decode=True, device_decode=True), the headline through
               solve_sharded on an 8-shard and a 2 x 4 mesh (decode off, and
               on with 512 existing nodes), and the provision-sharded-50k-20k
               cell through Provisioner(sharded_solve=True).provision, each
               run with the launch counts zeroed just before it: every one
               must reproduce GOLDEN_SHARDED (the JAX package's, on the CPU;
               a psum'd cost within relative 1e-6), the shard-batched kernels
               must have launched, the single-device scan only in the
               megafleet's residual reconcile (once).  Then (after phase
               11) warm p50s of each mode, the cell's round-2 split, the
               device time of each shard-batched kernel beside n serial
               single-device launches of the same shards, the five
               programs (rows 13-17) held against their plain compositions
               and timed, and the device idle share (the slab solve's
               trace read as phase 10's, with K6s's split by launch at
               row 17's input).

The timings also give K2's time per class step at the headline, the live
round 2 and the megafleet's row 17, and K5's per row step at each sweep
family's first call; `[probe]` lines give the class step in clusters of
every size and thread count (`classpack_kernels.step_cycles`, clock64),
whose least is the dependency term of the bounds of K2, K2s, K5 and the
programs that run them (rows 7, 8, 10, 13-17); and one trace each (the decoded
headline solve for K2 and K1, the aggregate headline solve for K4, the first
frontier sweep, the megafleet slab solve), read with the launch counters
around the same calls, must name the new kernel (`cluster_scan_kernel`,
`precompute_tile_kernel`, `aggregate_cluster_kernel`, `row_sweep_kernel`)
and none of the old (`precompute_kernel`, `aggregate_kernel`).  `[probe]
empty launch` gives the card time of a near-empty kernel
(torch.cuda._sleep(0)) on the kernels' measure: the floor under every row,
beside which K1's and K4's lines state their times.

Prints the kernel table as one JSON line (each row's `launches` from its
own path, `launches_by_path` from every main path), the card's name and
power limit, and last `{"ok": true, "device": {...}}`.  A kernel's `ms` is
its device time per call (`card_ms`: calls queued behind a spinning
kernel, then CUDA events around them, so no host time falls between
them), `host_ms` the CUDA-event time of back-to-back calls from the host
(for a short kernel, the host's launch rate); a whole program's `ms` (rows
7-8, 13-17) is CUDA-event time over the call, host work between its
launches included.
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
SMEM_BYTES_PER_CLOCK = 128   # shared memory per SM per clock (Hopper)
SM_CLOCK_HZ = None      # the card's maximum SM clock (nvidia-smi), set by probe
REL_TOL = 1e-5          # aggregate total_cost: float32 sums in another order
SEED = 7
# the main path whose run gives a kernel row's `launches`: slice 1's
# headline solves for K1-K4, the 500-candidate consolidation tick for K5
HEADLINE_PATH = "headline"
SWEEP_PATH = "consolidation-500"
# the guided main paths; the PDHG row's `launches` is the device-LP
# headline's run
GUIDED_PATH = "guided-headline"
DEVICE_LP_PATH = "guided-headline-device-lp"
REFINERY_PATH = "guided-headline-refinery"
LP_RTOL = 1e-3          # PDHG objectives (tests/test_lpsolve.py's RTOL)
LP_XTOL = 2e-2          # PDHG primal, absolute (relative to the pod scale
#                         on the restricted masters)
LP_ITER_FACTOR = 1.5
STREAM_ITERS = 2000     # the streaming PDHG check's iteration cap


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
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    check(clk.returncode == 0, f"nvidia-smi failed: {clk.stderr.strip()}")
    global SM_CLOCK_HZ
    SM_CLOCK_HZ = float(clk.stdout.strip().splitlines()[0]) * 1e6
    from karpenter_tpu_torch._build import find_nvcc
    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60)
    nvcc_line = [l for l in nvcc.stdout.splitlines() if l.strip()][-1]
    log(f"[probe] card: {card}, max SM clock {SM_CLOCK_HZ / 1e6:.0f} MHz")
    log(f"[probe] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"[probe] nvcc: {nvcc_line}")
    import scipy
    log(f"[probe] scipy {scipy.__version__}, numpy {np.__version__}")
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
                                    or "Compiling" in line) or (
                    "spill" in line and "0 bytes spill stores, 0 bytes "
                    "spill loads" not in line):
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
        # K1, launched twice, and for m alone
        m, ok = ck.classpack_precompute(req, cap, packed, alloc, price, rank)
        m2, ok2 = ck.classpack_precompute(req, cap, packed, alloc, price,
                                          rank)
        m1, none = ck.classpack_precompute(req, cap, packed, alloc, price,
                                           rank, with_ok=False)
        m0, ok0 = ck.classpack_precompute_plain(req, cap, packed, alloc,
                                                price, rank)
        torch.cuda.synchronize()
        check(torch.equal(m, m0) and torch.equal(ok, ok0),
              f"K1 precompute differs from plain ({name})")
        check(torch.equal(m, m2) and torch.equal(ok, ok2),
              f"K1 precompute: two launches differ ({name})")
        check(none is None and torch.equal(m1, m0),
              f"K1 precompute with_ok=False differs ({name})")
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
        # K4, launched twice
        g = ck.classpack_aggregate(slot_option, price, n_open, n_unsched)
        g2 = ck.classpack_aggregate(slot_option, price, n_open, n_unsched)
        g0 = ck.classpack_aggregate_plain(slot_option, price, n_open, n_unsched)
        torch.cuda.synchronize()
        check(torch.equal(g[1:], g0[1:]),
              f"K4 aggregate counts differ ({name})")
        check(torch.equal(g, g2), f"K4 aggregate: two launches differ ({name})")
        tc, tc0 = float(g[0]), float(g0[0])
        check(math.isfinite(tc) and abs(tc - tc0) <= REL_TOL * max(abs(tc0), 1e-30),
              f"K4 total_cost {tc} vs {tc0} ({name})")
        err["classpack_aggregate"] = max(err["classpack_aggregate"],
                                         abs(tc - tc0))
        log(f"[kernels] {name}: Cpad={low.req_p.shape[0]} "
            f"Opad={low.price_p.shape[0]} K={K} R={low.req_p.shape[1]} "
            f"Ppad={low.Ppad} n_open={int(n_open)} n_unsched={int(n_unsched)} "
            f"-> K1-K4 equal to plain, K1 and K4 twice bit-equal, K1 "
            f"with_ok=False the same m (total_cost |d|={abs(tc - tc0):.3g})")
        if name == "real":
            shapes = dict(req=req, cnt=cnt, packed=packed, cap=cap,
                          alloc=alloc, price=price, rank=rank, m=m, ok=ok,
                          K=K, Ppad=low.Ppad, takes=takes,
                          slot_option=slot_option, n_open=n_open,
                          n_unsched=n_unsched)
    return err, shapes


# (n, C, O, R) of K1 on each main path: the headline, the live cell's round
# 2, the consolidation-500 tick and the megafleet's row 17 (K1s, 8 shards)
K1_PATH_SHAPES = {"headline": (1, 256, 4096, 7),
                  "live-round-2": (1, 256, 8192, 7),
                  "consolidation-500": (1, 1024, 512, 7),
                  "megafleet-row-17": (8, 64, 512, 2)}


def precompute_inputs(torch, rng, n, C, O, R):
    """Seeded K1 inputs at (n, C, O, R) on the card, with K1's parity
    traps: requests of 0 and below (masked), of 1 and past 2^30, node caps
    of 0 and 1, negative and extreme allocations, +inf and NaN prices,
    classes with no compatible option, pool ranks.  Returns [requests
    n×C×R, node_cap n×C, compat_packed n×C×ceil(O/8), alloc, price,
    rank]."""
    req = rng.integers(1, 9000, (n, C, R)).astype(np.int32)
    req[rng.random(req.shape) < 0.25] = 0
    req[rng.random(req.shape) < 0.05] = -7
    req[..., 0][rng.random((n, C)) < 0.15] = 1
    req[rng.random(req.shape) < 0.05] = 2**30 + 1
    cap = np.where(rng.random((n, C)) < 0.3, rng.integers(0, 3, (n, C)),
                   2**30).astype(np.int32)
    comp = rng.random((n, C, O)) < 0.6
    comp[:, ::7] = False
    alloc = rng.integers(0, 64_000, (O, R)).astype(np.int32)
    alloc[rng.random((O, R)) < 0.1] *= -1
    alloc[0, 0], alloc[-1, -1] = -2**31, 2**31 - 1
    price = rng.uniform(0.05, 5.0, O).astype(np.float32)
    price[rng.random(O) < 0.2] = np.inf
    price[rng.random(O) < 0.02] = np.nan
    rank = rng.integers(0, 3, O).astype(np.int32)
    return [torch.tensor(a, device="cuda") for a in (
        req, cap, np.packbits(comp, axis=2), alloc, price, rank)]


def compare_precompute_shapes(torch):
    """K1 at each main path's shape on seeded inputs (K1s over the
    megafleet's 8 shards): twice, bit-equal to plain; K1 also with
    with_ok=False (the same m, no ok).  Returns each shape's arguments."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    rng = np.random.default_rng(SEED)
    out = {}
    for name, (n, C, O, R) in K1_PATH_SHAPES.items():
        args = precompute_inputs(torch, rng, n, C, O, R)
        if n == 1:
            args = [a[0] for a in args[:3]] + args[3:]
            fn, plain = ck.classpack_precompute, ck.classpack_precompute_plain
        else:
            fn = ck.classpack_precompute_sharded
            plain = ck.classpack_precompute_sharded_plain
        got, again, want = fn(*args), fn(*args), plain(*args)
        torch.cuda.synchronize()
        for g, h, w, what in zip(got, again, want, ("m", "ok")):
            check(torch.equal(g, w), f"K1 at {name}: {what} differs from plain")
            check(torch.equal(g, h), f"K1 at {name}: two launches differ "
                                     f"({what})")
        if n == 1:
            m1, none = fn(*args, with_ok=False)
            torch.cuda.synchronize()
            check(none is None and torch.equal(m1, want[0]),
                  f"K1 at {name}: with_ok=False differs")
        plan = ck.precompute_plan_for(torch.device("cuda"), C, O, R, n)
        log(f"[kernels] K1 at {name} (n={n}, C={C}, O={O}, R={R}; {plan}): "
            f"equal to plain, two launches bit-equal"
            f"{', with_ok=False the same m' if n == 1 else ''}; "
            f"{int(got[1].sum())} ok of {n * C * O}")
        out[name] = args
    return out


def scan_twice(torch, args, K, emit, what, want=None):
    """K2 launched twice on `args`, each bit-equal to the plain version
    (`want`, computed here when not given); returns the plain outputs."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    got = ck.classpack_scan(*args, K, emit)
    again = ck.classpack_scan(*args, K, emit)
    if want is None:
        want = ck.classpack_scan_plain(*args, K, emit)
    torch.cuda.synchronize()
    for g, h, w, name in zip(got, again, want, ("slot_option", "slot_used",
                                                "n_open", "n_unsched",
                                                "takes")):
        check(torch.equal(g, h), f"K2 {what}: two launches differ ({name})")
        check(torch.equal(g, w), f"K2 {what}: {name} differs from plain "
                                 f"(emit={emit})")
    return want


def compare_scan_edges(torch, problem):
    """K2 on the headline's lowered batch with every fifth non-empty class
    emptied and one count made negative (empty classes between non-empty
    ones: exact no-ops the kernel skips) at slot counts that make
    `scan_plan` pick each cluster size (K = 64, 256, 512, 1024, 2048 and
    the headline's 8192), at K = 1 and K = 37 (slot exhaustion; no cluster
    size divides 37) and at K3's widest K = 32 768, there also over 32
    axes (the slot state in a global slice).  Emitting takes and not, each
    launched twice, bit-equal to plain."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    from karpenter_tpu_torch.ops.classpack import lower_problem
    dev = torch.device("cuda")
    low = lower_problem(problem)
    cnt = low.cnt_p.copy()
    real = np.nonzero(cnt > 0)[0]
    cnt[real[::5]] = 0
    cnt[real[1]] = -3
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    req, cnt_t, packed, cap = map(t, (low.req_p, cnt, low.packed, low.cap_p))
    alloc, price, rank = map(t, (low.alloc_i, low.price_p, low.rank_p))
    m, ok = ck.classpack_precompute(req, cap, packed, alloc, price, rank)
    args = (req, cnt_t, packed, cap, alloc, price, m, ok, None, None)
    R, O = low.req_p.shape[1], low.price_p.shape[0]
    picked = set()
    for K in (1, 37, 64, 256, 512, 1024, 2048, low.K, 32_768):
        plan = ck.scan_plan_for(dev, K, R, O, 1)
        check(plan.state_smem and plan.stage,
              f"K2 headline at K={K}: plan {plan}")
        picked.add(plan.cluster)
        for emit in (True, False):
            want = scan_twice(torch, args, K, emit,
                              f"headline, empty classes between, K={K}")
        log(f"[kernels] K2 headline at K={K} with {len(real[::5])} empty "
            f"classes between non-empty ones and one negative count "
            f"({plan}): equal to plain, emit on and off, two launches "
            f"bit-equal; n_open {int(want[2])}, n_unsched {int(want[3])}")
    check(set(ck.SCAN_CLUSTERS) <= picked,
          f"K2: the plans took clusters of only {sorted(picked)}")
    # the spill layout: the same classes over 32 axes (zero requests and
    # allocations on the 25 added), K = 32 768, whose slot state no
    # cluster's shared memory holds
    pad = lambda a: torch.nn.functional.pad(a, (0, ck.MAX_R - R))  # noqa: E731
    req32, alloc32 = pad(req).contiguous(), pad(alloc).contiguous()
    m32, ok32 = ck.classpack_precompute(req32, cap, packed, alloc32, price,
                                        rank)
    args32 = (req32, cnt_t, packed, cap, alloc32, price, m32, ok32, None,
              None)
    plan = ck.scan_plan_for(dev, 32_768, ck.MAX_R, O, 1)
    check(not plan.state_smem, f"K2 at K=32768, R=32: plan {plan}")
    for emit in (True, False):
        want = scan_twice(torch, args32, 32_768, emit,
                          "headline over 32 axes, K=32768")
    log(f"[kernels] K2 headline over {ck.MAX_R} axes at K=32768 ({plan}): "
        f"equal to plain, emit on and off, two launches bit-equal; n_open "
        f"{int(want[2])}, n_unsched {int(want[3])}")


# K3 inputs recorded from the main paths' runs: name -> (takes, counts,
# n_pods) of the path's last K3 call
K3_RECORDED = {}
K3_EDGE_SETS = ((200, 8192, 50176), (64, 2**15, 50176))   # (C, K, n_pods)


def same_k3(torch, got, want, what):
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and torch.equal(got, want),
          f"{what}: kernel differs from its plain version")


def compare_assign_decode(torch):
    """K3 and K3s (one launch each) against their plain versions on the
    edge inputs of `workloads.assign_decode_edges`, at the headline's
    width (C = 200, K = 8192) and at K = 32 768 (int32 slots); K3s on the
    stack of each width's cases and on two shards sharing one counts
    row."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    for C, K, n_pods in K3_EDGE_SETS:
        cases = workloads.assign_decode_edges(C, K, n_pods, rng)
        ts, cs = [], []
        for name, (takes, counts, _) in cases.items():
            t = torch.tensor(takes, device=dev)
            c = torch.tensor(counts, device=dev)
            before = ck.LAUNCHES["classpack_assign_decode"]
            got = ck.classpack_assign_decode(t, c, n_pods)
            check(ck.LAUNCHES["classpack_assign_decode"] == before + 1,
                  "K3 is one launch per call")
            want = ck.classpack_assign_decode_plain(t, c, n_pods)
            same_k3(torch, got, want, f"K3 on '{name}' (K={K})")
            check(got.dtype == (torch.int16 if K < 2**15 else torch.int32),
                  f"K3 slot type {got.dtype} at K={K}")
            ts.append(t)
            cs.append(c)
        ts, cs = torch.stack(ts), torch.stack(cs)
        before = ck.LAUNCHES["classpack_assign_decode_sharded"]
        got = ck.classpack_assign_decode_sharded(ts, cs, n_pods)
        check(ck.LAUNCHES["classpack_assign_decode_sharded"] == before + 1,
              "K3s is one launch per call")
        same_k3(torch, got, ck.classpack_assign_decode_sharded_plain(
            ts, cs, n_pods), f"K3s on the {len(cases)} edge shards (K={K})")
        shared = cs[1].expand(2, C)
        pair = torch.stack([ts[1], torch.zeros_like(ts[1])])
        same_k3(torch, ck.classpack_assign_decode_sharded(pair, shared,
                                                          n_pods),
                ck.classpack_assign_decode_sharded_plain(pair, shared,
                                                         n_pods),
                f"K3s on two shards sharing counts (K={K})")
        log(f"[kernels] K3 / K3s edges at C={C} K={K} n_pods={n_pods} "
            f"({', '.join(cases)}): equal to plain, one launch per call, "
            f"{got.dtype} slots")


def compare_recorded_k3(torch):
    """K3 against its plain version on the inputs recorded from the main
    paths' runs (the consolidation tick, the provisioning cells)."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    check(K3_RECORDED, "no K3 input was recorded on the main paths")
    for name, (takes, counts, n_pods) in K3_RECORDED.items():
        same_k3(torch, ck.classpack_assign_decode(takes, counts, n_pods),
                ck.classpack_assign_decode_plain(takes, counts, n_pods),
                f"K3 on {name}'s input")
        log(f"[kernels] K3 on {name}'s input (C={takes.shape[0]} "
            f"K={takes.shape[1]} n_pods={n_pods}): equal to plain")


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
    for name in ("classpack_precompute", "classpack_scan",
                 "classpack_assign_decode", "classpack_aggregate"):
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


def card_ms(torch, fn, iters, cycles=2e8):
    """Device time of one call of `fn`: `iters` calls queued behind a
    spinning kernel (`torch.cuda._sleep`, about 0.1 s), so the host
    enqueues them while the card is busy and the card then runs them back
    to back, timed by CUDA events around the queued calls.  `event_ms`
    without the queue measures, for a short kernel, the host's launch
    rate.  If the host took longer to enqueue than the card slept (a call
    that synchronises), the spin doubles, up to three tries; past them the
    time is logged as host-bound."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        s0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s0.record()
        torch.cuda._sleep(int(cycles))
        a.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        b.record()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host < 0.8 * s0.elapsed_time(a):
            return a.elapsed_time(b) / iters
        cycles *= 2
    log(f"[time] card_ms: the host took {host:.3f} ms to enqueue {iters} "
        f"calls, longer than the card slept: {a.elapsed_time(b) / iters:.4f}"
        f" ms per call is host-bound")
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
    busy = trace_kernel(torch, card, "decoded solve",
                        lambda: cp.solve_classpack(prob, guide=None),
                        "classpack_scan", "cluster_scan_kernel",
                        ("::scan_kernel<",))
    log(f"[trace] decoded solve: device busy {busy['device_ms']:.3f} of "
        f"{busy['wall_ms']:.3f} ms wall per solve, idle share "
        f"{busy['idle_share']:.4f}; by kernel {busy['by_kernel']} on {card}")
    # K3 is one kernel now: the four of its earlier design are gone
    k3 = [k for k in busy["names"] if "assign_decode_kernel" in k]
    earlier = [k for k in busy["names"] if any(
        s in k for s in ("tile_scan_kernel", "tile_sums_kernel",
                         "add_back_kernel", "::decode_kernel"))]
    check(len(k3) == 1 and not earlier,
          f"the decoded solve's trace shows K3 as {k3 + earlier}")
    log(f"[trace] decoded solve: K3 is one kernel in the trace: {k3[0]!r} "
        f"({len(busy['names'])} kernel names in all)")
    # K1's tile kernel on the decoded solve, K4's cluster kernel on the
    # aggregate solve: no kernel of their earlier designs
    trace_kernel(torch, card, "decoded solve", lambda: cp.solve_classpack(
        prob, guide=None), "classpack_precompute", "precompute_tile_kernel",
        ("precompute_kernel",))
    trace_kernel(torch, card, "aggregate solve", lambda: cp.solve_classpack(
        prob, guide=None, decode=False), "classpack_aggregate",
        "aggregate_cluster_kernel", ("aggregate_kernel",))
    return out


def trace_kernel(torch, card, what, fn, counter, new, old, iters=3):
    """`device_busy` of `fn` with the launch counter `counter` read around
    the same calls: it must have launched at least once a call, and the
    trace must name the kernel of this design (`new`) and none of the
    earlier design's (`old`)."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    before = ck.LAUNCHES[counter]
    busy = device_busy(torch, fn, iters)
    calls = ck.LAUNCHES[counter] - before
    hit = [k for k in busy["names"] if new in k]
    stale = [k for k in busy["names"] if any(o in k for o in old)]
    check(calls >= iters + 1 and hit and not stale,
          f"{what}: {counter} launched {calls} times in {iters + 1} calls; "
          f"the trace names {hit} of this design and {stale} of the earlier")
    log(f"[trace] {what}: {counter} launched {calls} times in {iters + 1} "
        f"calls; the trace names {[k[:60] for k in hit]} "
        f"({sum(busy['events'][k] for k in hit)} launches recorded, "
        f"{sum(busy['per_kernel'][k] for k in hit):.4f} ms a call) and no "
        f"kernel of the earlier design on {card}")
    return busy


def device_busy(torch, fn, iters=3):
    """Device busy time per call from a torch.profiler trace (CUPTI): the
    sum of CUDA kernel and copy self times over the wall time of `iters`
    synchronised calls; `per_kernel` is each name's device ms per call,
    `events` the launches of each name the trace recorded."""
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
    by, events = {}, {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            by[ev.key] = ev.self_device_time_total / 1e3 / iters
            events[ev.key] = ev.count
    dev = sum(by.values())
    short = {k[:40]: round(v, 4) for k, v in
             sorted(by.items(), key=lambda kv: -kv[1])[:6]}
    return dict(device_ms=dev, wall_ms=wall, idle_share=1 - dev / wall,
                by_kernel=short, names=sorted(by), per_kernel=by,
                events=events)


# ---------------------------------------------------------------------------
# phase 5: K5 against its plain version on the consolidation cell
# ---------------------------------------------------------------------------

def consolidation_controller(n_cands):
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.controllers.disruption import \
        DisruptionController
    f = workloads.consolidation_fleet()
    return DisruptionController(f.provider, f.cluster, f.pools,
                                clock=f.clock, max_candidates=n_cands)


def sweep_lowerings(arena, n_cands):
    """(name, SweepLowered) of the three probe families at the cell's full
    width: the first binary-search frontier and every prefix on the delete
    face, every single-candidate screen on the replace face."""
    from karpenter_tpu_torch.controllers.disruption import _search_frontier
    from karpenter_tpu_torch.ops.classpack import lower_sweep
    out = []
    for name, probes in (
            ("delete face, first frontier",
             arena.prefix_probes(_search_frontier(1, n_cands))),
            ("delete face, every prefix",
             arena.prefix_probes(range(1, n_cands + 1))),
            ("replace face, every single", arena.singles_probes())):
        side, counts, mask, caps, max_nodes = probes
        out.append((name, lower_sweep(side.problem, counts,
                                      **arena.sweep_inputs(side, mask, caps,
                                                           max_nodes))))
    return out


def perturbed_sweep(low, rng, small_k=None):
    """Seeded rows over a replace-face lowering: caps at the median option
    price (half the options masked) on every other row, an all-masked row,
    zero-count rows, rows holding ten candidates' pods with most existing
    columns masked (they must launch), and rows holding every candidate's
    pods with almost every existing column masked (they run out of
    slots).  `small_k` cuts the slots to two past the existing columns."""
    import dataclasses
    B = min(low.chunk, low.cnt_p.shape[0])
    cnt = low.cnt_p[:B].copy()
    mask = low.mask_p[:B].copy()
    caps = low.caps_b[:B].copy()
    fin = low.price_p[np.isfinite(low.price_p)]
    caps[::2] = np.median(fin)
    mask[1] = False
    cnt[2:6] = 0
    busy = np.nonzero(low.cnt_p.sum(1) > 0)[0]
    cols = low.init_option[low.init_option >= 0]
    for rows, share, keep in ((range(6, 14), 10, 0.2),
                              (range(14, 22), len(busy), 0.05)):
        for r in rows:
            pick = rng.choice(busy, size=min(share, len(busy)), replace=False)
            cnt[r] = low.cnt_p[pick].sum(0)
            mask[r, cols] = rng.random(len(cols)) < keep
    kw = dict(cnt_p=cnt, mask_p=mask, caps_b=caps)
    if small_k is not None:
        kw.update(K=small_k, init_option=low.init_option[:small_k].copy(),
                  init_used=low.init_used[:small_k].copy())
    return dataclasses.replace(low, **kw)


def compare_sweep(torch, low, name, err):
    """K5 against classpack_sweep_plain on every device call of `low`;
    returns the device tensors of the first call."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    from karpenter_tpu_torch.ops.classpack import sweep_device_args
    dev = torch.device("cuda")
    req, packed, cap, alloc, price, rank, iopt, iused = \
        sweep_device_args(low, dev)
    m_all, _ = ck.classpack_precompute(req, cap, packed, alloc, price, rank)
    first = None
    calls = 0
    for s, e, cb, mb, pb in low.chunks():
        t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
        args = (req, t(cb), packed, cap, alloc, price, rank, t(mb), t(pb),
                iopt, iused, m_all, low.K)
        got = ck.classpack_sweep(*args)
        again = ck.classpack_sweep(*args)
        want = ck.classpack_sweep_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, again),
              f"K5 sweep: two launches differ ({name}, rows {s}-{e})")
        check(torch.equal(got[:, 1:], want[:, 1:]),
              f"K5 sweep n_new/n_unsched differ from plain ({name}, rows "
              f"{s}-{e})")
        g, w = got[:, 0].double(), want[:, 0].double()
        d = float((g - w).abs().max())
        check(bool(torch.isfinite(g).all())
              and bool(((g - w).abs() <= REL_TOL * w.abs()).all()),
              f"K5 sweep cost differs from plain by {d} ({name})")
        err["classpack_sweep"] = max(err["classpack_sweep"], d)
        calls += 1
        if first is None:
            first = dict(args=args, cb=cb, mb=mb, pb=pb, low=low,
                         launched=int(got[:, 1].sum()),
                         unsched=int(got[:, 2].sum()))
    log(f"[sweep] {name}: {calls} call(s) of B={first['cb'].shape[0]}, "
        f"Cpad={low.req_p.shape[0]} Opad={low.price_p.shape[0]} K={low.K} "
        f"E={int((low.init_option >= 0).sum())} -> K5 equal to plain, two "
        f"launches bit-equal "
        f"(first call: {first['launched']} launches, {first['unsched']} "
        f"unschedulable)")
    return first


def compare_sweeps(torch, err):
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.ops.classpack import (lower_sweep,
                                                   solve_classpack_sweep)
    n = max(workloads.CONSOLIDATION_SHAPES)
    ctrl = consolidation_controller(n)
    cands = ctrl.candidates()
    arena = ctrl._arena_for(cands)
    rng = np.random.default_rng(SEED)
    firsts = {}
    lows = sweep_lowerings(arena, n)
    for name, low in lows:
        firsts[name] = compare_sweep(torch, low, name, err)
    # rows that launch new nodes: K5's option pass, pool rank, price cap
    # and cost sum, against the JAX package's golden and the plain version
    problem, counts, kw = workloads.launch_probes(arena)
    res = solve_classpack_sweep(problem, counts, device="cuda", **kw)
    digest, total = workloads.sweep_digest(res)
    gold, gold_total = workloads.GOLDEN_LAUNCH_SWEEP
    check(digest == gold, f"launch-probe sweep rows {digest} != golden {gold}")
    check(abs(total - gold_total) <= REL_TOL * gold_total,
          f"launch-probe sweep cost {total} vs golden {gold_total}")
    log(f"[sweep] launch probes: {len(res.new_nodes)} rows, "
        f"{int(res.new_nodes.sum())} launches, cost {total!r} — golden "
        f"digest matches")
    name = "replace face, launch probes"
    firsts[name] = compare_sweep(torch, lower_sweep(problem, counts, **kw),
                                 name, err)
    replace = lows[-1][1]
    compare_sweep(torch, perturbed_sweep(replace, rng),
                  "replace face, seeded perturbation", err)
    small = int((replace.init_option >= 0).sum()) + 2
    compare_sweep(torch, perturbed_sweep(replace, rng, small_k=small),
                  f"replace face, slot exhaustion K={small}", err)
    compare_sweep_edges(torch, firsts, lows, err)
    return firsts


def compare_sweep_edges(torch, firsts, lows, err):
    """K5 at one row (the first frontier's first row, B = 1 exactly), and
    past the shared memory a block may opt into: the replace face's rows
    over K = 8192 slots (its existing columns, then closed slots), whose
    state (256 KB a row) the plan keeps in a global slice.  Each launched
    twice, bit-equal, and against the plain version."""
    import dataclasses
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    args = list(firsts["delete face, first frontier"]["args"])
    for i in (1, 7, 8):
        args[i] = args[i][:1].contiguous()
    got, again = ck.classpack_sweep(*args), ck.classpack_sweep(*args)
    want = ck.classpack_sweep_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, again) and torch.equal(got[:, 1:], want[:, 1:])
          and float((got[:, 0] - want[:, 0]).abs().max())
          <= REL_TOL * max(float(want[:, 0].abs().max()), 1e-30),
          "K5 at B = 1 differs from plain or between launches")
    log(f"[sweep] delete face, one row (B=1): K5 equal to plain, two "
        f"launches bit-equal ({got.tolist()})")
    replace = lows[-1][1]
    K = ck.SWEEP_MAX_SLOTS
    R = replace.init_used.shape[1]
    iopt = np.full(K, -1, np.int32)
    iused = np.zeros((K, R), np.int32)
    iopt[:replace.K], iused[:replace.K] = replace.init_option, \
        replace.init_used
    wide = dataclasses.replace(replace, K=K, init_option=iopt,
                               init_used=iused)
    plan = ck.sweep_plan_for(torch.device("cuda"), K, R,
                             replace.price_p.shape[0], replace.chunk)
    check(not plan.state_smem, f"K5 at K={K}: the plan {plan} keeps the "
                               f"state in shared memory")
    compare_sweep(torch, wide, f"replace face at K={K} (state in a global "
                               f"slice)", err)


# ---------------------------------------------------------------------------
# phase 6: the consolidation main path, goldens, timings
# ---------------------------------------------------------------------------

def consolidation_path(torch, card):
    """{path name: launch counts of that path's run} for each shape."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.ops import classpack as cp
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    from karpenter_tpu_torch.ops.tensorize import SimulationArena
    sync = torch.cuda.synchronize
    by_path = {}
    for n in workloads.CONSOLIDATION_SHAPES:
        ctrl = consolidation_controller(n)
        # the main path alone: one tick, counts zeroed just before it
        ck.reset_launches()
        t0 = time.perf_counter()
        with captured(cp, "classpack_assign_decode") as k3:
            cands = ctrl.candidates()
            action = ctrl.consolidation_action(cands)
        sync()
        wall = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        by_path[f"consolidation-{n}"] = launches
        if k3:
            K3_RECORDED[f"consolidation-{n} tick"] = k3[-1]
        for k in ("classpack_precompute", "classpack_scan",
                  "classpack_assign_decode", "classpack_sweep"):
            check(launches[k] > 0,
                  f"kernel {k} never launched on the consolidation path ({n})")
        # the arena's full sweeps, which a tick does not run, for the goldens
        arena = ctrl._arena_for(cands)
        prefixes, singles = arena.sweep_prefixes(), arena.sweep_singles()
        got = workloads.consolidation_digests(action, prefixes, singles)
        gold = workloads.GOLDEN_CONSOLIDATION[n]
        check(got["action"] == gold["action"],
              f"consolidation action ({n} candidates) differs from golden")
        for face in ("prefixes", "singles"):
            check(got[face][0] == gold[face][0],
                  f"{face} sweep rows ({n} candidates) differ from golden")
            check(abs(got[face][1] - gold[face][1])
                  <= REL_TOL * max(abs(gold[face][1]), 1e-30),
                  f"{face} sweep cost ({n} candidates) {got[face][1]} vs "
                  f"golden {gold[face][1]}")
        side = arena.delete_side
        log(f"[consolidation] {n} candidates: {action.name} of "
            f"{len(action.candidates)} nodes, arena C={side.problem.num_classes} "
            f"E={len(side.node_list)}; prefix rows {len(prefixes.new_nodes)} "
            f"({prefixes.device_calls} call), singles rows "
            f"{len(singles.new_nodes)} ({singles.device_calls} calls), "
            f"{int(prefixes.unschedulable.sum())} / "
            f"{int(singles.unschedulable.sum())} pods unschedulable, "
            f"{int(singles.new_nodes.sum())} replacements — golden digests "
            f"match; first tick {wall:.3f} s; the tick's launches {launches}")

        # timings: a fresh arena (the cold part of a tick), the warm tick
        # on the cached arena, and its pieces
        best = len(action.candidates)
        out = {}
        out["arena build, delete face"] = p50_ms(
            lambda: SimulationArena(cands, ctrl.cluster,
                                    ctrl.provider.get_instance_types(),
                                    list(ctrl.nodepools.values()),
                                    device=ctrl.device).delete_side,
            iters=3)
        out["arena build, replace face"] = p50_ms(
            lambda: SimulationArena(cands, ctrl.cluster,
                                    ctrl.provider.get_instance_types(),
                                    list(ctrl.nodepools.values()),
                                    device=ctrl.device).replace_side,
            iters=3)
        from karpenter_tpu_torch.controllers.disruption import \
            _search_frontier
        out["prefix sweep, first frontier (K1+K5, D2H)"] = p50_ms(
            lambda: arena.sweep_prefix_subset(_search_frontier(1, n)),
            sync=sync)
        out["decoded accept (simulate, K1+K2+K3, decode)"] = p50_ms(
            lambda: ctrl._decoded_delete_action(cands[:best]), iters=5,
            sync=sync)
        out["singles sweep, replace face (K1+K5 x calls, D2H)"] = p50_ms(
            lambda: arena.sweep_singles(), iters=5, sync=sync)
        out["warm tick consolidation_action"] = p50_ms(
            lambda: ctrl.consolidation_action(cands), sync=sync)
        for k, (p50, xs) in out.items():
            log(f"[time] consolidation {n}: {k}: p50 {p50:.3f} ms over "
                f"{len(xs)} runs (min {min(xs):.3f}, max {max(xs):.3f}) on "
                f"{card}")
        if n == max(workloads.CONSOLIDATION_SHAPES):
            trace_kernel(torch, card, f"consolidation {n} first frontier "
                         f"sweep", lambda: arena.sweep_prefix_subset(
                             _search_frontier(1, n)), "classpack_sweep",
                         "row_sweep_kernel", ("::sweep_kernel<",))
        busy = device_busy(torch, lambda: ctrl.consolidation_action(cands))
        log(f"[trace] consolidation {n}: warm tick device busy "
            f"{busy['device_ms']:.3f} of {busy['wall_ms']:.3f} ms wall, idle "
            f"share {busy['idle_share']:.4f}; by kernel {busy['by_kernel']} "
            f"on {card}")
    return by_path


def sweep_bound(first):
    """(bound ms, "bytes" or "operations", binding term, {term: ms}) of one
    sweep call — row 10's function, K1 + K5, and the least that K5 alone
    must do of it — the largest of three terms:
      bytes       row 10's own inputs and outputs, each read or written
                  once, over the memory rate (K1's `m_all` is an
                  intermediate of the K1 -> K5 split, not counted);
      operations  the fit pass over the open slots for every (row, class)
                  pair with pods (the option pass and K1's fits are not
                  counted, so the term stays a floor), over the float32
                  peak;
      dependency  a row's class steps run one after another, each at least
                  the fill's block-wide scan: the card's least bare
                  exchange on one CTA of any thread count (`least_step`);
                  rows run side by side, so the longest row's steps, at
                  the maximum SM clock.  Operations in sequence: its
                  bound_by is "operations"."""
    low, cb, mb, pb = first["low"], first["cb"], first["mb"], first["pb"]
    R = low.req_p.shape[1]
    O = low.price_p.shape[0]
    nbytes = (low.req_p.nbytes + cb.nbytes + low.packed.nbytes
              + low.cap_p.nbytes + low.alloc_p.nbytes + low.price_p.nbytes
              + low.rank_p.nbytes + mb.nbytes + pb.nbytes
              + low.init_option.nbytes + low.init_used.nbytes
              + cb.shape[0] * 3 * 4)
    n_open = int((low.init_option >= 0).sum())
    nops = int((cb > 0).sum()) * n_open * (2 * R + 6)
    bare, _ = least_step((1,))
    steps = int((cb > 0).sum(1).max())
    terms = {"bytes": nbytes / MEM_BW * 1e3,
             "operations": nops / F32_PEAK * 1e3,
             "dependency": steps * bare / SM_CLOCK_HZ * 1e3}
    term = max(terms, key=terms.get)
    return (terms[term], "bytes" if term == "bytes" else "operations", term,
            terms)


def sweep_call_times(torch, card, firsts):
    """CUDA-event time of each sweep probe family's first device call:
    K1 + K5 as the sweep runs them, and K5 alone, beside row 10's bound
    and K1's plain version at the call's shapes.  Returns {family: (K5's
    device time, K5's back-to-back CUDA-event time), ms}."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    from karpenter_tpu_torch.ops.classpack import \
        class_pack_sweep_kernel_packed
    k5_ms = {}
    for name, f in firsts.items():
        steps = int((f["cb"] > 0).sum(1).max())
        (req, cb, packed, cap, alloc, price, rank, mb, pb, iopt, iused,
         m_all, K) = f["args"]
        both = event_ms(torch, lambda: class_pack_sweep_kernel_packed(
            req, cb, packed, cap, alloc, price, rank, mb, pb, iopt, iused,
            K), 10)
        k5_ms[name] = (card_ms(torch, lambda: ck.classpack_sweep(*f["args"]),
                               10),
                       event_ms(torch, lambda: ck.classpack_sweep(*f["args"]),
                                10))
        k1_plain = event_ms(torch, lambda: ck.classpack_precompute_plain(
            req, cap, packed, alloc, price, rank), 1)
        bound, by, term, _ = sweep_bound(f)
        log(f"[time] sweep call, {name} (B={cb.shape[0]}): K1+K5 "
            f"{both:.4f} ms, K5 {k5_ms[name][1]:.4f} ms (CUDA events), K5 "
            f"{k5_ms[name][0]:.4f} ms on the card (queued), "
            f"{k5_ms[name][0] / max(steps, 1) * 1e3:.3f} us a row step "
            f"({steps} steps in its longest row); bound of row 10 "
            f"{bound * 1e3:.3f} us ({term}); K1 plain {k1_plain:.3f} ms on "
            f"{card}")
    return k5_ms


def sweep_row(torch, card, first, ms, launches_by_path, err):
    """The kernel-table row of K5 at the tick's own call: the first
    binary-search frontier on the delete face at 500 candidates, timed
    (`ms`: device time, back-to-back host rate) by `sweep_call_times`."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    args, low, cb = first["args"], first["low"], first["cb"]
    ms, host_ms = ms
    plain_ms = event_ms(torch, lambda: ck.classpack_sweep_plain(*args), 1)
    bound_ms, bound_by, term, terms = sweep_bound(first)
    log(f"[kernel] classpack_sweep: {ms:.4f} ms on the card (back-to-back "
        f"host rate {host_ms:.4f} ms; plain {plain_ms:.3f} ms, "
        f"library None, bound {bound_ms * 1e3:.3f} us by {term}, terms "
        f"{terms}; {ms / bound_ms:.2f}x the bound) at "
        f"B={cb.shape[0]} Cpad={low.req_p.shape[0]} "
        f"Opad={low.price_p.shape[0]} K={low.K} on {card}")
    return dict(name="classpack_sweep", route="cuda",
                source="karpenter_tpu_torch/csrc/classpack.cu",
                replaces="karpenter_tpu/ops/classpack.py:332",
                launches=launches_by_path[SWEEP_PATH]["classpack_sweep"],
                path=SWEEP_PATH,
                launches_by_path={p: c["classpack_sweep"]
                                  for p, c in launches_by_path.items()},
                max_abs_err=err["classpack_sweep"], ms=ms, host_ms=host_ms,
                plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, bound_term=term,
                bound_terms=terms, library_ms=None)


STEP_PROBES = {}
STEP_LEAST = {}
STEP_THREADS = (128, 256, 512, 1024)


def least_step(clusters=None):
    """(cycles of a bare exchange, of an exchange and a block reduction):
    the least class step this card takes in any layout, the least of each
    over clusters of every size in `clusters` (default: every size K2
    takes) and every thread count of STEP_THREADS, each measured by
    `classpack_kernels.step_cycles` (clock64, the least of three chains)
    and logged on a [probe] line once; a size the card refuses is logged
    and left out."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    clusters = tuple(clusters or ck.SCAN_CLUSTERS)
    if clusters in STEP_LEAST:
        return STEP_LEAST[clusters]
    for cs in clusters:
        for T in STEP_THREADS:
            if (cs, T) in STEP_PROBES:
                continue
            try:
                bare = min(ck.step_cycles(cs, T, False) for _ in range(3))
                full = min(ck.step_cycles(cs, T, True) for _ in range(3))
            except ck.KernelError as e:
                STEP_PROBES[(cs, T)] = None
                log(f"[probe] least class step, clusters of {cs} x {T} "
                    f"threads: refused ({e})")
                continue
            STEP_PROBES[(cs, T)] = (bare, full)
            log(f"[probe] least class step, clusters of {cs} x {T} threads "
                f"(clock64, {ck.STEP_CHAIN} dependent steps): {bare:.1f} SM "
                f"cycles an exchange, {full:.1f} with a block reduction; at "
                f"the maximum SM clock {SM_CLOCK_HZ / 1e6:.0f} MHz")
    got = {k: v for k, v in STEP_PROBES.items() if v and k[0] in clusters}
    check(got, "no least class step was measured")
    bare = min(got, key=lambda k: got[k][0])
    full = min(got, key=lambda k: got[k][1])
    log(f"[probe] least class step over clusters of "
        f"{sorted({k[0] for k in got})} x {list(STEP_THREADS)} threads: "
        f"{got[bare][0]:.1f} cycles an exchange ({bare[0]} x {bare[1]}), "
        f"{got[full][1]:.1f} with a block reduction ({full[0]} x {full[1]})")
    STEP_LEAST[clusters] = got[bare][0], got[full][1]
    return STEP_LEAST[clusters]


def scan_counts(cnt, takes, init_open, K):
    """The class steps one K2 scan runs, from its counts and emitted takes
    (C x K; open slots a prefix, as every main path lays them): `steps`
    the non-empty classes, `option_steps` those left with pods while a
    slot is free (the option argmin runs), `fit_tests` the open slots the
    fit tests over all steps."""
    cnt = np.asarray(cnt)
    takes = np.asarray(takes)
    n_open, c = int(init_open), dict(steps=0, option_steps=0, fit_tests=0)
    for k in np.nonzero(cnt > 0)[0]:
        row = takes[k]
        c["steps"] += 1
        c["fit_tests"] += n_open
        if int(cnt[k]) - int(row[:n_open].sum()) > 0 and n_open < K:
            c["option_steps"] += 1
        n_open += int((row[n_open:] > 0).sum())
    return c


def scan_bound(nbytes, shard_counts, R, O, cycles):
    """(bound ms, "bytes" or "operations", binding term, {term: ms}) of one
    K2 launch over the shards whose `scan_counts` are `shard_counts`, the
    largest of three terms:
      bytes       its inputs and outputs, each once, over the memory rate;
      operations  the fit tests over the open slots (2R + 6 each) and the
                  option scores of each option step (5 an option), over
                  the card's float32 peak;
      dependency  each class step reads the state the step before wrote:
                  at least a bare exchange a step, and an exchange with a
                  block reduction an option step (`cycles`, the card's
                  measured least steps), over the longest shard (shards run
                  side by side), at the maximum SM clock.  Operations in
                  sequence: its bound_by is "operations"."""
    bare, full = cycles
    nops = sum(c["fit_tests"] * (2 * R + 6) + c["option_steps"] * O * 5
               for c in shard_counts)
    dep = max((c["steps"] - c["option_steps"]) * bare
              + c["option_steps"] * full for c in shard_counts)
    terms = {"bytes": nbytes / MEM_BW * 1e3,
             "operations": nops / F32_PEAK * 1e3,
             "dependency": dep / SM_CLOCK_HZ * 1e3}
    term = max(terms, key=terms.get)
    return (terms[term], "bytes" if term == "bytes" else "operations", term,
            terms)


def scan_step_line(card, what, R, O, K, n, ms, counts):
    """Log K2's time per class step at one input, in the layout its plan
    picks."""
    import torch
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    plan = ck.scan_plan_for(torch.device("cuda"), K, R, O, n)
    steps = max(c["steps"] for c in counts)
    log(f"[time] K2 {what}: {ms:.4f} ms on the card, {steps} class steps "
        f"(of its longest shard; {sum(c['option_steps'] for c in counts)} "
        f"option steps in all): {ms / steps * 1e3:.3f} us a step, plan "
        f"{plan} on {card}")


def shard_scan_counts(s):
    """`scan_counts` of each shard of a stacked row 13-17 input (`stacked`),
    from the takes of one K2s launch over it."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    m, ok = ck.classpack_precompute_sharded(
        s["req"], s["cap"], s["packed"], s["alloc"], s["price"], s["rank"])
    takes = ck.classpack_scan_sharded(
        s["req"], s["cnt"], s["packed"], s["cap"], s["alloc"], s["price"], m,
        ok, s["iopt"], s["iused"], s["K"], True)[4].cpu().numpy()
    cnt = s["cnt"].cpu().numpy()
    return [scan_counts(cnt[i], takes[i], 0 if s["iopt"] is None else
                        int((s["iopt"][i] >= 0).sum()), s["K"])
            for i in range(cnt.shape[0])]


FLOOR_MS = None   # the empty launch's card time (`launch_floor`)


def launch_floor(torch, card):
    """The card's time for a near-empty kernel on `card_ms`'s measure
    (torch.cuda._sleep(0): one launch that spins no cycle), the floor under
    which no kernel of the table can go; logged on a [probe] line once."""
    global FLOOR_MS
    if FLOOR_MS is None:
        FLOOR_MS = card_ms(torch, lambda: torch.cuda._sleep(0), 50)
        log(f"[probe] empty launch: card_ms {FLOOR_MS:.4f} ms "
            f"(torch.cuda._sleep(0), 50 calls queued behind a spinning "
            f"kernel) on {card}")
    return FLOOR_MS


def k1_bytes_ops(n, C, O, R, with_ok=True):
    """K1's bytes (each input once, a shared catalog once, m and ok written
    once) and operations (2R + 4 a class and option) at (n, C, O, R)."""
    nbytes = (n * (C * R * 4 + C * 4 + C * ((O + 7) // 8)) + O * R * 4
              + O * 8 + n * C * O * (5 if with_ok else 4))
    return nbytes, n * C * O * (2 * R + 4)


def kernel_table(torch, card, shapes, launches_by_path, err, k1_inputs):
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    s = shapes
    floor = launch_floor(torch, card)
    C, R = s["req"].shape
    O = s["price"].shape[0]
    K, Ppad = s["K"], s["Ppad"]
    OB = s["packed"].shape[1]
    src = "karpenter_tpu_torch/csrc/classpack.cu"
    rows = []

    def row(name, replaces, fn, plain, library, nbytes, nops, iters):
        ms = card_ms(torch, fn, iters)
        host_ms = event_ms(torch, fn, iters)
        plain_ms = event_ms(torch, plain, 1)
        lib_ms = card_ms(torch, library, iters) if library else None
        t_b, t_o = nbytes / MEM_BW * 1e3, nops / F32_PEAK * 1e3
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches_by_path[HEADLINE_PATH][name],
            path=HEADLINE_PATH,
            launches_by_path={p: c[name]
                              for p, c in launches_by_path.items()},
            max_abs_err=err[name], ms=ms, host_ms=host_ms,
            plain_ms=plain_ms, bound_ms=max(t_b, t_o),
            bound_by="bytes" if t_b >= t_o else "operations",
            library_ms=lib_ms, floor_ms=floor))
        log(f"[kernel] {name}: {ms:.4f} ms on the card (back-to-back host "
            f"rate {host_ms:.4f} ms; plain {plain_ms:.3f} ms, "
            f"library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
            f"bound {max(t_b, t_o) * 1e3:.3f} us by "
            f"{'bytes' if t_b >= t_o else 'operations'}: "
            f"{ms / max(t_b, t_o):.2f}x the bound, {ms / floor:.2f}x the "
            f"empty launch) on {card}")

    args1 = (s["req"], s["cap"], s["packed"], s["alloc"], s["price"], s["rank"])
    row("classpack_precompute", "karpenter_tpu/ops/classpack.py:75",
        lambda: ck.classpack_precompute(*args1),
        lambda: ck.classpack_precompute_plain(*args1), None,
        *k1_bytes_ops(1, C, O, R), 20)
    # K1 at each main path's shape (seeded inputs, phase 3), and for m alone
    k1 = rows[-1]
    k1["shapes"] = {}
    dev = torch.device("cuda")
    for name, args in k1_inputs.items():
        n_, C_, O_, R_ = K1_PATH_SHAPES[name]
        fn = ck.classpack_precompute if n_ == 1 else \
            ck.classpack_precompute_sharded
        entry = {}
        for with_ok in ((True, False) if n_ == 1 else (True,)):
            kw = {} if with_ok else dict(with_ok=False)
            ms = card_ms(torch, lambda: fn(*args, **kw), 20)
            b_, o_ = k1_bytes_ops(n_, C_, O_, R_, with_ok)
            bound = max(b_ / MEM_BW, o_ / F32_PEAK) * 1e3
            entry["ms" if with_ok else "m_only_ms"] = ms
            entry["bound_ms" if with_ok else "m_only_bound_ms"] = bound
            log(f"[kernel] classpack_precompute at {name} (n={n_}, C={C_}, "
                f"O={O_}, R={R_}{'' if with_ok else ', m only'}): {ms:.4f} ms "
                f"on the card, bound {bound * 1e3:.3f} us by bytes "
                f"({ms / bound:.2f}x), {ms / floor:.2f}x the empty launch "
                f"({floor:.4f} ms); plan "
                f"{ck.precompute_plan_for(dev, C_, O_, R_, n_)} on {card}")
        entry["floor_ms"] = floor
        k1["shapes"][name] = entry
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
    k2 = rows[-1]
    counts = scan_counts(s["cnt"].cpu().numpy(), s["takes"].cpu().numpy(), 0,
                         K)
    cycles = least_step()
    nbytes = (C * (R * 4 + 13 + OB) + O * (R * 4 + 4) + C * O * 5
              + K * (4 + R * 4) + C * K * 4 + 8)
    b, by, term, terms = scan_bound(nbytes, [counts], R, O, cycles)
    k2.update(bound_ms=b, bound_by=by, bound_term=term, bound_terms=terms,
              step_cycles=list(cycles), steps=counts)
    scan_step_line(card, "headline", R, O, K, 1, k2["ms"], [counts])
    log(f"[kernel] classpack_scan bound restated: {b:.5f} ms by {term} "
        f"(terms {terms}; {k2['ms'] / b:.2f}x the bound) from {counts} on "
        f"{card}")
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
        # bincount's weighted form, without its host sync (it reads the
        # input's max back)
        lambda: torch.zeros(O, device=w.device).scatter_add_(0, opt, w),
        K * 4 + O * 4 + 8 + (3 + O) * 4, K * 3, 50)
    rows[-1]["plan"] = str(ck.aggregate_plan_for(torch.device("cuda"), K, O,
                                                 1))
    plan_alternatives(torch, card, args1, (s["slot_option"], s["price"],
                                           s["n_open"], s["n_unsched"]))
    return rows


def plan_alternatives(torch, card, k1_args, k4_args):
    """K1 and K4 at the headline's inputs under their plans' own layouts
    and under others (forced for the measurement only): the card time and
    the back-to-back host rate of each, the numbers behind the plans'
    rules (a smaller cluster, fewer CTAs, the staging)."""
    import dataclasses
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    dev = torch.device("cuda")
    C, R = k1_args[0].shape
    O = k1_args[3].shape[0]
    K = k4_args[0].shape[0]
    own = ck.precompute_plan_for(dev, C, O, R, 1)
    alts = [own, dataclasses.replace(own, stage=False,
                                     smem=ck.precompute_smem_bytes(
                                         R, own.options, False, own.classes,
                                         own.threads))]
    for cs, T, ct in ((2, 512, 4), (4, 256, 4), (8, 128, 4), (1, 1024, 1)):
        if cs * 4 * T >= O > (cs - 1) * 4 * T:
            alts.append(ck.PrecomputePlan(
                classes=ct, options=4 * T, cluster=cs, threads=T, groups=1,
                stage=True, smem=ck.precompute_smem_bytes(R, 4 * T, True, ct,
                                                          T)))
    real = ck.precompute_plan_for
    try:
        for plan in alts:
            ck.precompute_plan_for = lambda *a, **k: plan
            ms = card_ms(torch, lambda: ck.classpack_precompute(*k1_args), 20)
            host = event_ms(torch, lambda: ck.classpack_precompute(*k1_args),
                            100)
            log(f"[time] K1 headline under {plan}{' (its own)' if plan == own else ''}: "
                f"{ms:.4f} ms on the card, host rate {host:.4f} ms on {card}")
    finally:
        ck.precompute_plan_for = real
    own4 = ck.aggregate_plan_for(dev, K, O, 1)
    real4 = ck.aggregate_plan_for
    try:
        for cs in (1, 2, 4, 8, 16):
            plan = ck.AggregatePlan(cluster=cs, threads=own4.threads,
                                    per_cta=-(-K // cs), smem=own4.smem)
            ck.aggregate_plan_for = lambda *a, **k: plan
            ms = card_ms(torch, lambda: ck.classpack_aggregate(*k4_args), 50)
            host = event_ms(torch, lambda: ck.classpack_aggregate(*k4_args),
                            100)
            log(f"[time] K4 headline in clusters of {cs}"
                f"{' (its own)' if plan == own4 else ''}: {ms:.4f} ms on the "
                f"card, host rate {host:.4f} ms on {card}")
    finally:
        ck.aggregate_plan_for = real4


# ---------------------------------------------------------------------------
# phase 7: the PDHG kernel against its plain version
# ---------------------------------------------------------------------------

def clear_lp_caches():
    from karpenter_tpu_torch.ops import lpguide, lpsolve
    with lpguide._MIX_LOCK:
        lpguide._MIX_CACHE.clear()
        lpguide._STALE_CACHE.clear()
        lpguide._SUPPORT_CACHE.clear()
    lpsolve.reset_caches()


def capture_masters(fn):
    """Run `fn()` with every `lpsolve._pdhg_kernel` call recorded: returns
    (fn's result, [{ops, eps, iters_cap, check_every, done, iters}])."""
    from karpenter_tpu_torch.ops import lpsolve
    real = lpsolve._pdhg_kernel
    seen = []

    def record(*a, **kw):
        out = real(*a, **kw)
        seen.append(dict(ops=[t.clone() for t in a[:9]], eps=float(a[9]),
                         iters_cap=kw["iters_cap"],
                         check_every=kw["check_every"],
                         done=out[3].cpu().numpy().copy(),
                         iters=out[4].cpu().numpy().copy()))
        return out
    lpsolve._pdhg_kernel = record
    try:
        res = fn()
    finally:
        lpsolve._pdhg_kernel = real
    return res, seen


def random_lp(rng, n, me, mi):
    """tests/test_lpsolve.py's generator (feasible by construction)."""
    x_star = rng.uniform(0.0, 2.0, n)
    A = rng.uniform(-1.0, 1.0, (me, n))
    G = rng.uniform(-1.0, 1.0, (mi, n))
    return (rng.uniform(0.1, 1.0, n), A, A @ x_star, G,
            G @ x_star + rng.uniform(0.1, 1.0, mi), np.full(n, 4.0))


def lp_case(torch, insts, buckets=None):
    from karpenter_tpu_torch.ops import lpsolve
    bt = lpsolve.pad_batch(insts, buckets or lpsolve.LP_BUCKETS)
    ops = [torch.from_numpy(a).cuda() for a in bt.operands()]
    return dict(ops=ops, eps=lpsolve.DEFAULT_EPS,
                iters_cap=lpsolve.DEFAULT_ITERS_CAP,
                check_every=lpsolve.DEFAULT_CHECK_EVERY)


def pdhg_path(torch, case):
    """("resident", plan) or ("streaming", None): the kernel a launch on
    this case's envelope takes on this card."""
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    A, G = case["ops"][0], case["ops"][2]
    plan = lk.device_plan(A.shape[0], A.shape[1] + G.shape[1], A.shape[2],
                          A.device)
    return ("streaming", None) if plan is None else ("resident", plan)


def compare_pdhg_case(torch, name, case, err, pod_scale=False, expect=None,
                      path="resident"):
    """The kernel against `pdhg_plain` on one captured or built batch, on
    the kernel `path` names (checked by its launch counter), and a second
    launch against the first, bit for bit; returns a list of failure
    strings (empty when it agrees)."""
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    args = (*case["ops"], case["eps"], case["iters_cap"],
            case["check_every"])
    before = dict(lk.LAUNCHES)
    first = lk.pdhg(*args)
    second = lk.pdhg(*args)
    torch.cuda.synchronize()
    took = ("resident" if lk.LAUNCHES["pdhg_resident"]
            == before["pdhg_resident"] + 2 else "streaming")
    _, plan = pdhg_path(torch, case)
    log(f"[pdhg] {name}: path {took}"
        + ("" if plan is None else
           f" ({plan.row_bands} x {plan.col_bands} bands of {plan.band_rows}"
           f" x {plan.band_cols} per member, {plan.blocks} blocks, "
           f"{plan.smem_bytes} B of shared memory each)"))
    bad = []
    if took != path or lk.LAUNCHES["pdhg"] != before["pdhg"] + 2:
        bad.append(f"{name} took the {took} kernel, expected {path}")
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        bad.append(f"{name}: two launches differ")
    got = [g.cpu().numpy() for g in first]
    want = [w.cpu().numpy() for w in lk.pdhg_plain(*args)]
    torch.cuda.synchronize()
    c = case["ops"][4].cpu().numpy().astype(np.float64)
    B, n = c.shape
    for i in range(B):
        og, ow = float(c[i] @ got[0][i]), float(c[i] @ want[0][i])
        scale = max(1.0, float(np.abs(want[0][i]).max())) if pod_scale \
            else 1.0
        dx = float(np.abs(got[0][i] - want[0][i]).max())
        err["pdhg"] = max(err["pdhg"], dx)
        it_g, it_w = int(got[4][i]), int(want[4][i])
        line = (f"[pdhg] {name}[{i}]: n={n} me={case['ops'][1].shape[1]} "
                f"mi={case['ops'][3].shape[1]} kernel "
                f"{'converged' if got[3][i] else 'cap'} {it_g} it "
                f"{int(got[5][i])} restarts obj {og!r} (pres {got[6][i]:.3g}"
                f" dres {got[7][i]:.3g} gap {got[8][i]:.3g}); plain "
                f"{'converged' if want[3][i] else 'cap'} {it_w} it obj {ow!r};"
                f" |dx| {dx:.3g}")
        log(line)
        if bool(got[3][i]) != bool(want[3][i]):
            bad.append(f"{name}[{i}] status differs")
        if expect is not None and bool(got[3][i]) != expect:
            bad.append(f"{name}[{i}] status {bool(got[3][i])} != {expect}")
        if abs(og - ow) > LP_RTOL * max(1.0, abs(ow)):
            bad.append(f"{name}[{i}] objective {og} vs {ow}")
        if dx > LP_XTOL * scale:
            bad.append(f"{name}[{i}] x differs by {dx}")
        if it_g > LP_ITER_FACTOR * it_w or it_w > LP_ITER_FACTOR * it_g:
            bad.append(f"{name}[{i}] iterations {it_g} vs {it_w}")
    return bad


def compare_pdhg(torch, problem, err):
    """Phase 7.  Returns {master name: captured case} of the restricted
    masters (the headline's and the LP instances')."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.ops import lpguide, lpsolve
    from karpenter_tpu_torch.ops.health import lp_ladder
    torch.backends.cuda.matmul.allow_tf32 = False
    err["pdhg"] = 0.0
    bad = []
    masters = {}
    clear_lp_caches()
    ops = workloads.lp_operands(problem)
    h = lp_ladder(clock=lambda: 0.0)
    (_, z, info), seen = capture_masters(
        lambda: lpguide.exact_lp_mix(*ops, device=True, lp_health=h))
    check(len(seen) == 1 and not seen[0]["done"][0]
          and int(seen[0]["iters"][0]) == lpsolve.DEFAULT_ITERS_CAP,
          f"headline master: expected one capped PDHG solve, got "
          f"{[(bool(s['done'][0]), int(s['iters'][0])) for s in seen]}")
    check(info["method"] == "colgen-lp" and h.failures("device_lp") == 1,
          f"headline master: method {info['method']}, failures "
          f"{h.failures('device_lp')}")
    masters["headline"] = seen[0]
    log(f"[pdhg] headline master caps at {int(seen[0]['iters'][0])} "
        f"iterations and demotes one strike; HiGHS answers z {z!r}")
    for C, prob in workloads.lp_problems().items():
        clear_lp_caches()
        hh = lp_ladder(clock=lambda: 0.0)
        (_, zc, infoc), seen = capture_masters(lambda: lpguide.exact_lp_mix(
            *workloads.lp_operands(prob), device=True, lp_health=hh))
        check(infoc["method"] == "colgen-lp-device"
              and all(s["done"][0] for s in seen),
              f"lp-{C}: device masters did not converge "
              f"({infoc['method']}, {[bool(s['done'][0]) for s in seen]})")
        for k, s in enumerate(seen):
            masters[f"lp-{C} master {k + 1}"] = s
    for name, case in masters.items():
        bad += compare_pdhg_case(torch, name, case, err, pod_scale=True,
                                 expect=name != "headline")
    rng = np.random.default_rng(SEED)
    inst = lambda c, A, b, G, h_, u: lpsolve.LPInstance(  # noqa: E731
        c=np.asarray(c, np.float32), A_eq=A, b_eq=b, A_ub=G, b_ub=h_,
        upper=u)
    for n, me, mi in ((20, 5, 8), (80, 20, 30), (1500, 40, 60)):
        bad += compare_pdhg_case(torch, f"random ({n}, {me}, {mi})",
                                 lp_case(torch, [inst(*random_lp(
                                     rng, n, me, mi))]), err, expect=True)
    c, A, b, G, h_, u = random_lp(rng, 80, 20, 30)
    u[::3] = np.inf
    bad += compare_pdhg_case(torch, "u finite and +inf",
                             lp_case(torch, [inst(c, A, b, G, h_, u)]), err,
                             expect=True)
    batch = [inst(*random_lp(rng, n, me, mi))
             for n, me, mi in ((20, 5, 8), (28, 7, 12), (16, 4, 6),
                               (30, 8, 10))]
    bad += compare_pdhg_case(torch, "batch B=4",
                             lp_case(torch, batch, buckets=(32,)), err,
                             expect=True)
    together = lpsolve.solve_lp_batch(batch, buckets=(32,))
    for i, one in enumerate(batch):
        solo = lpsolve.solve_lp_batch([one], buckets=(32,))[0]
        dx = float(np.abs(solo.x - together[i].x).max())
        if solo.iterations != together[i].iterations or dx > 1e-4:
            bad.append(f"batch member {i}: {together[i].iterations} it vs "
                       f"solo {solo.iterations}, |dx| {dx}")
    log(f"[pdhg] B=4 batch: every member equals its solo launch "
        f"(iterations {[s.iterations for s in together]})")
    # a warm-started re-solve of the 100-class instance's last master
    key = "chip_smoke:warm"
    wc = masters[f"lp-{workloads.LP_SIZES[0]} master 2"]
    A0, b0, G0, h0, c0, u0 = (t[0].cpu().numpy() for t in wc["ops"][:6])
    lpsolve.reset_caches()
    cold = lpsolve.solve_lp(c0, A_eq=A0, b_eq=b0, A_ub=G0, b_ub=h0, upper=u0,
                            warm_key=key)
    warm, seen = capture_masters(lambda: lpsolve.solve_lp(
        c0, A_eq=A0, b_eq=b0, A_ub=G0, b_ub=h0, upper=u0, warm_key=key))
    check(cold.converged and warm.converged
          and warm.iterations < cold.iterations,
          f"warm start: cold {cold.iterations} it, warm {warm.iterations}")
    log(f"[pdhg] warm start: cold {cold.iterations} it, warm "
        f"{warm.iterations} it")
    bad += compare_pdhg_case(torch, "warm re-solve", seen[0], err,
                             pod_scale=True, expect=True)
    # over the shared-memory budget: a B = 2 batch of the headline master
    # (2 x 25.2 MB), capped at STREAM_ITERS iterations to bound the plain
    # version's time
    head = masters["headline"]
    two = dict(head, ops=[torch.cat([t, t]) for t in head["ops"]],
               iters_cap=STREAM_ITERS)
    bad += compare_pdhg_case(torch, f"headline x2 (B=2, cap {STREAM_ITERS})",
                             two, err, pod_scale=True, expect=False,
                             path="streaming")
    check(not bad, "PDHG kernel differs from its plain version: "
          + "; ".join(bad))
    log(f"[pdhg] the kernel agrees with its plain version on every input "
        f"(max |dx| {err['pdhg']:.3g})")
    return masters


# ---------------------------------------------------------------------------
# phase 8: the guided main path
# ---------------------------------------------------------------------------

def all_launches():
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    from karpenter_tpu_torch.ops import ffd_kernels as fk
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    return {**ck.LAUNCHES, **lk.LAUNCHES, **fk.LAUNCHES}


def reset_all_launches():
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    from karpenter_tpu_torch.ops import ffd_kernels as fk
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    ck.reset_launches()
    lk.reset_launches()
    fk.reset_launches()


def check_guided(prob, res, what):
    import scipy
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.ops import lpguide
    gold = workloads.GOLDEN_GUIDED
    digest, total = workloads.plan_digest(prob, res)
    z = [h[3] for h in lpguide._MIX_CACHE.values()]
    if digest != gold["digest"] or len(res.nodes) != gold["nodes"]:
        log(f"[guided] {what}: scipy {scipy.__version__} here, "
            f"{gold['scipy']} for the golden; z_lp {z} vs golden "
            f"{gold['z_lp']!r}; plan cost {total!r} ({len(res.nodes)} "
            f"nodes) vs golden {gold['total']!r} ({gold['nodes']} nodes)")
    check(digest == gold["digest"],
          f"guided headline {what}: digest {digest} != golden {gold['digest']}")
    check(abs(total - gold["total"]) <= REL_TOL * gold["total"]
          and len(res.nodes) == gold["nodes"] and not res.unschedulable,
          f"guided headline {what}: {total} / {len(res.nodes)} nodes")
    log(f"[guided] {what}: {len(res.nodes)} nodes, total {total!r}, z_lp "
        f"{z} — GOLDEN_GUIDED matches")


def check_lp_plan(prob, res, C):
    from karpenter_tpu_torch import workloads
    gold = workloads.GOLDEN_LP[C]
    n_pods = int(prob.class_counts.sum())
    placed = sorted(p for nd in res.nodes for p in nd.pod_indices)
    check(placed == list(range(n_pods)) and not res.unschedulable,
          f"lp-{C}: the plan does not bind every pod exactly once")
    cls = np.empty(n_pods, np.int64)
    for c, m in enumerate(prob.class_members):
        cls[np.asarray(m, np.int64)] = c
    oi = {id(o): j for j, o in enumerate(prob.options)}
    for nd in res.nodes:
        used = prob.class_requests[cls[np.asarray(nd.pod_indices)]].sum(0)
        check(bool((used <= prob.option_alloc[oi[id(nd.option)]]).all()),
              f"lp-{C}: a node exceeds its option's allocatable")
    rel = abs(res.total_price - gold["device_total"]) / gold["device_total"]
    check(rel <= 5e-3, f"lp-{C}: plan total {res.total_price} vs golden "
          f"{gold['device_total']} (rel {rel:.3g})")
    log(f"[guided] lp-{C} device_lp: {len(res.nodes)} nodes (golden "
        f"{gold['device_nodes']}), total {res.total_price!r} (golden "
        f"{gold['device_total']!r}, rel {rel:.3g}); every pod bound within "
        f"alloc")


def guided_path(torch, problem):
    """Phase 8's main-path runs; returns {path: launch counts}."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.ops import lpguide
    from karpenter_tpu_torch.ops.classpack import solve_classpack
    from karpenter_tpu_torch.ops.health import lp_ladder
    from karpenter_tpu_torch.ops.refinery import GuideRefinery
    sync = torch.cuda.synchronize
    by_path = {}
    clear_lp_caches()
    reset_all_launches()
    t0 = time.perf_counter()
    res = solve_classpack(problem)
    sync()
    wall = time.perf_counter() - t0
    by_path[GUIDED_PATH] = launches = all_launches()
    log(f"[guided] cold default solve {wall:.3f} s; launches {launches}")
    for k in ("classpack_precompute", "classpack_scan",
              "classpack_assign_decode"):
        check(launches[k] > 0, f"{k} never launched on the guided path")
    check_guided(problem, res, "cold")
    check_guided(problem, solve_classpack(problem), "warm")

    clear_lp_caches()
    h = lp_ladder(clock=lambda: 0.0)
    reset_all_launches()
    t0 = time.perf_counter()
    res = solve_classpack(problem, device_lp=True, lp_health=h)
    sync()
    wall = time.perf_counter() - t0
    by_path[DEVICE_LP_PATH] = launches = all_launches()
    log(f"[guided] cold device_lp solve {wall:.3f} s; launches {launches}; "
        f"ladder {h.active_rung('device_lp')}, failures "
        f"{h.failures('device_lp')}")
    check(launches["pdhg"] > 0 and launches["pdhg_resident"] > 0,
          "the resident pdhg kernel never launched on the device_lp path")
    check(h.failures("device_lp") == 1
          and h.active_rung("device_lp") == "device_lp",
          "the capped headline master must demote exactly one strike")
    check_guided(problem, res, "device_lp cold")
    check_guided(problem, solve_classpack(problem, device_lp=True,
                                          lp_health=h), "device_lp warm")

    # the off-tick refinery: a cold tick answers greedy (GOLDEN's plan) and
    # queues the column generation; the refined mix upgrades the next tick
    clear_lp_caches()
    ref = GuideRefinery(start=False)
    reset_all_launches()
    res = solve_classpack(problem, refinery=ref)
    digest, _ = workloads.plan_digest(problem, res)
    check(digest == workloads.GOLDEN[(0, True)][0] and ref.pending() == 1,
          "refinery: the cold tick must answer the greedy golden plan and "
          "queue one refine job")
    ref.start()
    check(ref.drain(timeout=300.0), "refinery: the refine job did not finish")
    res = solve_classpack(problem, refinery=ref)
    sync()
    by_path[REFINERY_PATH] = launches = all_launches()
    check(ref.take_upgrade(), "refinery: no upgrade hint after the refine")
    ref.stop()
    log(f"[guided] refinery: cold tick = the greedy golden plan, refine "
        f"job drained, upgrade hint raised; launches {launches}")
    check_guided(problem, res, "refinery, the next tick")

    for C, prob in workloads.lp_problems().items():
        clear_lp_caches()
        hh = lp_ladder(clock=lambda: 0.0)
        _, z, info = lpguide.exact_lp_mix(*workloads.lp_operands(prob),
                                          device=True, lp_health=hh)
        gz = workloads.GOLDEN_LP[C]["z"]
        check(info["method"] == "colgen-lp-device"
              and abs(z - gz) <= LP_RTOL * gz,
              f"lp-{C}: {info['method']} z {z} vs HiGHS golden {gz}")
        log(f"[guided] lp-{C}: device colgen z {z!r} vs HiGHS golden {gz!r} "
            f"(rel {abs(z - gz) / gz:.3g}), {info['rounds']} rounds")
        clear_lp_caches()
        hh = lp_ladder(clock=lambda: 0.0)
        reset_all_launches()
        res = solve_classpack(prob, device_lp=True, lp_health=hh)
        sync()
        by_path[f"lp-{C}"] = launches = all_launches()
        check(launches["pdhg_resident"] > 0
              and hh.failures("device_lp") == 0
              and hh.active_rung("device_lp") == "device_lp",
              f"lp-{C}: masters did not converge on the card "
              f"({launches['pdhg']} launches, {hh.failures('device_lp')} "
              f"failures)")
        check_lp_plan(prob, res, C)
    return by_path


def guided_breakdown(torch, card, problem, iters=5):
    """Host-clock split of the guided headline's layers: the column
    generation (exact_lp_mix, HiGHS masters, in a cold solve), and in warm
    solves the remainder solve (K1-K3 + decode), the flexible alternatives,
    and the rest (mix lookup, stripe, tuck, merge).  Each layer is timed by
    wrapping the function the guide calls; p50 over `iters` solves."""
    from karpenter_tpu_torch.ops import classpack as cp
    from karpenter_tpu_torch.ops import lpguide
    sync = torch.cuda.synchronize
    spent = {}

    def timed(mod, name, key):
        real = getattr(mod, name)

        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                sync()
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
        setattr(mod, name, wrapper)
        return real
    rows = {"colgen (exact_lp_mix, HiGHS)": [], "total, cold": [],
            "remainder solve (K1-K3 + decode)": [],
            "alternatives": [], "lookup + stripe + tuck + merge": [],
            "total, warm": []}
    reals = [(lpguide, "exact_lp_mix", timed(lpguide, "exact_lp_mix",
                                             "colgen")),
             (cp, "solve_classpack", timed(cp, "solve_classpack", "rem")),
             (cp, "resolve_alternatives", timed(cp, "resolve_alternatives",
                                                "alt"))]
    try:
        for cold in (True,) * 3 + (False,) * iters:
            if cold:
                clear_lp_caches()
            spent.clear()
            t0 = time.perf_counter()
            lpguide.solve_guided(problem)
            sync()
            total = (time.perf_counter() - t0) * 1e3
            if cold:
                rows["colgen (exact_lp_mix, HiGHS)"].append(
                    spent["colgen"] * 1e3)
                rows["total, cold"].append(total)
                continue
            rem, alt = spent.get("rem", 0.0) * 1e3, spent["alt"] * 1e3
            rows["remainder solve (K1-K3 + decode)"].append(rem)
            rows["alternatives"].append(alt)
            rows["lookup + stripe + tuck + merge"].append(total - rem - alt)
            rows["total, warm"].append(total)
    finally:
        for mod, name, real in reals:
            setattr(mod, name, real)
    for k, xs in rows.items():
        log(f"[time] guided layers: {k}: p50 {statistics.median(xs):.3f} ms "
            f"over {len(xs)} solves (min {min(xs):.3f}, max {max(xs):.3f}) "
            f"on {card}")


def pdhg_bound(case, iters):
    """(bound ms, "bytes" or "operations", binding term, {term: ms}) of one
    PDHG solve of `iters` steps, a function of the shapes and the card
    only, the largest of three terms:
      hbm bytes     A and G read once at setup and twice at each check (a
                    row and a column pass over the unscaled operator) over
                    the memory rate;
      on-chip bytes two passes over the scaled operator per step, at the
                    shared-memory rate (128 B per clock per SM x SMs x the
                    maximum SM clock) where the operator fits the SMs'
                    combined shared memory (SMs x the opt-in shared memory
                    per block), else at the memory rate;
      operations    4 x B x (me+mi) x n float32 operations per step over
                    the card's float32 peak."""
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    A, G = case["ops"][0], case["ops"][2]
    B, mt, n = A.shape[0], A.shape[1] + G.shape[1], A.shape[2]
    mat = B * mt * n * 4
    checks = -(-iters // case["check_every"])
    sms, optin, _ = lk.device_smem(A.device)
    fits = mat <= sms * optin
    rate = SMEM_BYTES_PER_CLOCK * sms * SM_CLOCK_HZ if fits else MEM_BW
    terms = {"hbm bytes": (1 + 2 * checks) * mat / MEM_BW * 1e3,
             "on-chip bytes" + (" (shared memory)" if fits else " (HBM)"):
             2 * iters * mat / rate * 1e3,
             "operations": 4 * B * mt * n * iters / F32_PEAK * 1e3}
    term = max(terms, key=terms.get)
    return (terms[term], "operations" if term == "operations" else "bytes",
            term, terms)


def guided_timings(torch, card, problem, masters):
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.ops import lpguide
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    from karpenter_tpu_torch.ops.classpack import solve_classpack
    from karpenter_tpu_torch.ops.health import lp_ladder
    sync = torch.cuda.synchronize
    out = {}

    def cold():
        clear_lp_caches()
        solve_classpack(problem)
    out["guided headline, cold (mix caches cleared)"] = p50_ms(cold, 3, sync)
    out["guided headline, warm"] = p50_ms(lambda: solve_classpack(problem),
                                          7, sync)

    def cold_dev():
        clear_lp_caches()
        solve_classpack(problem, device_lp=True,
                        lp_health=lp_ladder(clock=lambda: 0.0))
    out["guided headline device_lp, cold (caps, then HiGHS)"] = p50_ms(
        cold_dev, 1, sync)
    for C, prob in workloads.lp_problems().items():
        ops = workloads.lp_operands(prob)
        out[f"exact_lp_mix lp-{C}, HiGHS"] = p50_ms(
            lambda: lpguide.exact_lp_mix(*ops), 7)
        out[f"exact_lp_mix lp-{C}, device (PDHG, cold)"] = p50_ms(
            lambda: lpguide.exact_lp_mix(*ops, device=True,
                                         lp_health=lp_ladder()), 7, sync)
    for k, (p50, xs) in out.items():
        log(f"[time] {k}: p50 {p50:.3f} ms over {len(xs)} runs (min "
            f"{min(xs):.3f}, max {max(xs):.3f}) on {card}")
    guided_breakdown(torch, card, problem)
    busy = device_busy(torch, lambda: solve_classpack(problem))
    log(f"[trace] warm guided headline: device busy {busy['device_ms']:.3f} "
        f"of {busy['wall_ms']:.3f} ms wall, idle share "
        f"{busy['idle_share']:.4f}; by kernel {busy['by_kernel']} on {card}")
    ms = {}
    for name, case in masters.items():
        args = (*case["ops"], case["eps"], case["iters_cap"],
                case["check_every"])
        reps = 3 if name == "headline" else 7
        ms[name] = event_ms(torch, lambda: lk.pdhg(*args), reps)
        it = int(case["iters"][0])
        bound, _, term, _ = pdhg_bound(case, it)
        log(f"[time] pdhg kernel ({pdhg_path(torch, case)[0]}), {name}: "
            f"{ms[name]:.3f} ms for {it} iterations "
            f"({ms[name] / max(it, 1) * 1e3:.3f} us/it); bound "
            f"{bound:.3f} ms ({term}) at n={case['ops'][0].shape[2]} "
            f"me={case['ops'][0].shape[1]} mi={case['ops'][2].shape[1]} on "
            f"{card}")
    return ms


def pdhg_row(torch, card, masters, ms, launches_by_path, err):
    """The kernel-table row of the PDHG kernel (row 12) at the device-LP
    headline's master (20 000 iterations, the cap)."""
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    case = masters["headline"]
    it = int(case["iters"][0])
    args = (*case["ops"], case["eps"], case["iters_cap"],
            case["check_every"])
    plain_ms = event_ms(torch, lambda: lk.pdhg_plain(*args), 1)
    dev_ms = card_ms(torch, lambda: lk.pdhg(*args), 1)
    K = torch.cat([case["ops"][0], case["ops"][2]], dim=1)
    z = torch.ones(K.shape[0], K.shape[1], 1, device=K.device)
    x = torch.ones(K.shape[0], K.shape[2], 1, device=K.device)
    pair = card_ms(torch, lambda: (torch.bmm(K.transpose(1, 2), z),
                                   torch.bmm(K, x)), 50)
    library_ms = pair * it
    bound_ms, bound_by, term, terms = pdhg_bound(case, it)
    path = pdhg_path(torch, case)[0]
    log(f"[kernel] pdhg ({path}): {dev_ms:.3f} ms on the card (CUDA events "
        f"{ms['headline']:.3f} ms; plain {plain_ms:.3f} ms, "
        f"library {library_ms:.3f} ms = {pair:.4f} ms bmm pair x {it}, "
        f"bound {bound_ms:.3f} ms by {term}; terms "
        f"{ {k: round(v, 3) for k, v in terms.items()} }) on {card}")
    return dict(name="pdhg", route="cuda",
                source="karpenter_tpu_torch/csrc/lpsolve.cu",
                replaces="karpenter_tpu/ops/lpsolve.py:145",
                launches=launches_by_path[DEVICE_LP_PATH]["pdhg"],
                path=DEVICE_LP_PATH,
                launches_by_path={p: c.get("pdhg", 0)
                                  for p, c in launches_by_path.items()},
                max_abs_err=err["pdhg"], ms=dev_ms, host_ms=ms["headline"],
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bound_term=term, library_ms=library_ms, kernel_path=path,
                resident_launches=launches_by_path[DEVICE_LP_PATH][
                    "pdhg_resident"])


# ---------------------------------------------------------------------------
# phase 9: K6 and K7 against their plain versions
# ---------------------------------------------------------------------------

SLAB_GUARD = 2**31      # the reference's int32 guard on (K + 1) · n


def slab_cases(rng):
    """(name, assignment, K): K3-shaped slot vectors (−1 == unplaced)."""
    out = []
    for K in (256, 2048, 8192):
        n = 4 * K + 37
        out.append((f"random K={K} n={n}",
                    rng.integers(-1, K, size=n).astype(np.int16), K))
    out.append(("all placed K=2048 n=53248 (int32)",
                rng.integers(0, 2048, size=53248).astype(np.int32), 2048))
    out.append(("none placed K=2048 n=32768",
                np.full(32768, -1, np.int16), 2048))
    out.append(("above the guard K=8192 n=300000",
                rng.integers(-1, 8192, size=300_000).astype(np.int16), 8192))
    return out


def compare_slab(torch, err):
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    rng = np.random.default_rng(SEED + 9)
    sides = set()
    for name, a, K in slab_cases(rng):
        t = torch.tensor(a, device="cuda")
        order, counts = ck.classpack_slab(t, K)
        order0, counts0 = ck.classpack_slab_plain(t, K)
        torch.cuda.synchronize()
        check(torch.equal(order, order0) and torch.equal(counts, counts0),
              f"K6 slab differs from plain ({name})")
        side = "above" if (K + 1) * len(a) >= SLAB_GUARD else "below"
        sides.add(side)
        log(f"[slab] {name}: {side} the (K+1)·n guard, "
            f"{int(counts.sum())} placed -> order and slot_counts equal")
    check(sides == {"above", "below"}, "K6 not held on both sides of the guard")
    err["classpack_slab"] = 0.0


def _port_type(name, cpu, mem_gib, price, zones=("zone-a", "zone-b")):
    from karpenter_tpu_torch.catalog.instancetype import (
        GiB, InstanceTypeInfo, Offering, new_instance_type)
    info = InstanceTypeInfo(name=name, cpu_m=cpu * 1000,
                            memory_bytes=mem_gib * GiB, arch="amd64")
    return new_instance_type(info, [Offering(z, "on-demand", price)
                                    for z in zones])


def ffd_edge_cases():
    """tests/test_native.py's edge cases on the port's objects: (name,
    problem, existing kwargs)."""
    from karpenter_tpu_torch.api.objects import NodePool, Pod, PodAffinityTerm
    from karpenter_tpu_torch.api.resources import CPU, MEMORY, ResourceList
    from karpenter_tpu_torch.catalog.generate import generate_catalog
    from karpenter_tpu_torch.ops.tensorize import tensorize

    def pod(cpu_m, mem_mib=512, **kw):
        return Pod(requests=ResourceList({CPU: cpu_m, MEMORY: mem_mib * 2**20}),
                   **kw)

    small = [_port_type("a.small", 2, 4, 0.10), _port_type("a.medium", 4, 8, 0.20),
             _port_type("a.large", 8, 16, 0.40)]
    anti = [PodAffinityTerm(topology_key="kubernetes.io/hostname",
                            label_selector={"app": "db"}, anti=True,
                            required=True)]
    rng = np.random.default_rng(13)
    rand = [pod(int(rng.integers(100, 4000)), int(rng.integers(128, 8192)))
            for _ in range(20)]
    cases = [
        ("inf-priced only fit", [_port_type("a.small", 2, 4, 0.10),
                                 _port_type("huge", 64, 256, float("inf"))],
         [pod(32000), pod(500)]),
        ("score overflow", [_port_type("tiny", 1, 1, 0.05),
                            _port_type("big", 64, 256, 3e38)],
         [pod(33000), pod(33000)]),
        ("NaN price", [_port_type("a.small", 2, 4, 0.10),
                       _port_type("huge", 64, 256, float("nan"))],
         [pod(32000), pod(500)]),
        ("node cap", small, [pod(500, labels={"app": "db"},
                                 pod_affinities=list(anti))
                             for _ in range(4)]),
        ("existing nodes", generate_catalog(12), rand),
    ]
    out = []
    for name, catalog, pods in cases:
        prob = tensorize(pods, catalog, [NodePool()])
        kw = {}
        if name == "existing nodes":
            R = prob.option_alloc.shape[1]
            kw = dict(existing_alloc=np.tile(prob.option_alloc[-1], (2, 1)),
                      existing_used=np.zeros((2, R), np.float32))
        out.append((name, prob, kw))
    return out


def compare_ffd_args(torch, name, args, K):
    """K7 against its plain version on one input (tensors on the card):
    every output equal, bit for bit, and a second launch equal to the
    first."""
    from karpenter_tpu_torch.ops import ffd_kernels as fk
    got = fk.ffd_scan(*args, K)
    again = fk.ffd_scan(*args, K)
    want = fk.ffd_scan_plain(*args, K)
    torch.cuda.synchronize()
    for a, a2, b, what in zip(got, again, want, ("assignment", "slot_option",
                                                 "slot_used", "n_open")):
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"K7 ffd_scan {what} differs from plain ({name})")
        check(torch.equal(a.view(torch.int32) if a.is_floating_point()
                          else a,
                          a2.view(torch.int32) if a2.is_floating_point()
                          else a2),
              f"K7 ffd_scan {what}: two launches differ ({name})")
    return got


def compare_ffd(torch, err):
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.ops.ffd import (ffd_device_args, lower_ffd,
                                             solve_ffd)
    dev = torch.device("cuda")
    for name, prob, kw in ffd_edge_cases():
        low = lower_ffd(prob, **kw)
        got = compare_ffd_args(torch, name, ffd_device_args(low, dev), low.K)
        plan = solve_ffd(prob, device="cuda", **kw)
        host = solve_ffd(prob, backend="numpy", **kw)
        check([(n.option.instance_type, n.pod_indices) for n in plan.nodes]
              == [(n.option.instance_type, n.pod_indices) for n in host.nodes]
              and plan.unschedulable == host.unschedulable
              and plan.existing_assignments == host.existing_assignments,
              f"solve_ffd on the card differs from the host rung ({name})")
        log(f"[ffd] {name}: P={low.P} K={low.K} n_open={int(got[3])} "
            f"nodes {[n.option.instance_type for n in plan.nodes][:4]} "
            f"unschedulable {plan.unschedulable} -> equal to plain")
    rng = np.random.default_rng(SEED + 11)
    for name, kw in (("random P=4096", {}),
                     ("random P=4096, 64 existing", dict(E=64)),
                     ("random P=4096, K=256 exhausts", dict(K=256))):
        arrays, K = workloads.ffd_scan_inputs(rng, **kw)
        args = tuple(torch.tensor(a, device=dev) for a in arrays)
        got = compare_ffd_args(torch, name, args, K)
        placed = int((got[0] >= 0).sum())
        log(f"[ffd] {name}: K={K} n_open={int(got[3])} placed {placed} "
            f"-> equal to plain")
    # rows of one class that are not all identical: the cursor resets
    for name in workloads.FFD_CURSOR_CASES:
        arrays, K = workloads.ffd_cursor_case(name, rng, P=4096)
        args = tuple(torch.tensor(a, device=dev) for a in arrays)
        got = compare_ffd_args(torch, name, args, K)
        log(f"[ffd] cursor case {name!r}: P=4096 K={K} n_open="
            f"{int(got[3])} placed {int((got[0] >= 0).sum())} -> equal to "
            f"plain, two launches bit-equal")
    err["ffd_scan"] = 0.0


# ---------------------------------------------------------------------------
# phase 10: the provisioning cells through Provisioner.provision
# ---------------------------------------------------------------------------

LIVE_PATH = "provision-live-50k-20k"
NOGUIDE_PATH = "provision-noguide-50k"
SMALL_PATH = "provision-small-3x64"
FFD_PATH = "provision-ffd-50k"


class captured:
    """Record the positional arguments of every call of `module.name`
    (the call itself runs unchanged) while the context is open."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapped(*a, **k):
            self.calls.append(a)
            return self.orig(*a, **k)
        setattr(self.module, self.name, wrapped)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def fresh_env(env, cell, catalog, device, **extra):
    """An independent copy of a cell's live state: the cluster copied
    object by object, a new fake cloud, provider and Provisioner (with
    `extra` options, e.g. the sharded cell's mesh)."""
    from karpenter_tpu_torch import convert, workloads
    from karpenter_tpu_torch.api.objects import NodePool
    from karpenter_tpu_torch.cloud import CloudProvider, FakeCloud
    from karpenter_tpu_torch.controllers.provisioning import Provisioner
    cloud = FakeCloud()
    provider = CloudProvider(cloud, catalog)
    cluster = convert.cluster_from_objects(env.cluster)
    prov = Provisioner(provider, cluster, [NodePool()], device=device,
                       **workloads.PROVISION_CELLS[cell][0], **extra)
    return workloads.ProvisionEnv(cloud, provider, cluster, prov)


def provision_layers(torch, env):
    """One provision() with its split: tensorize (constraint lowering,
    tensorize, the live-node gather), pack (the solve on the card with its
    decode) and launch (claims, fake cloud, registration, binds), ms."""
    prov = env.provisioner
    acc = {"solve": 0.0, "pack": 0.0}

    def timed(key, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                acc[key] += (time.perf_counter() - t0) * 1e3
        return run
    prov.solve = timed("solve", prov.solve)
    prov._pack_supervised = timed("pack", prov._pack_supervised)
    t0 = time.perf_counter()
    prov.provision()
    torch.cuda.synchronize()
    total = (time.perf_counter() - t0) * 1e3
    return dict(total=total, tensorize=acc["solve"] - acc["pack"],
                pack=acc["pack"], launch=total - acc["solve"])


def provision_cells(torch, card, device="cuda"):
    """The four cells against GOLDEN_PROVISION, each round with the launch
    counts zeroed just before it; the ladder and the decode breaker must
    book no failure.  Returns (launches by path, the recorded K6 and K7
    inputs, the slab programs' inputs)."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.api.objects import NodePool
    from karpenter_tpu_torch.catalog.generate import generate_catalog
    from karpenter_tpu_torch.cloud import CloudProvider, FakeCloud
    from karpenter_tpu_torch.controllers.provisioning import Provisioner
    from karpenter_tpu_torch.ops import classpack as cp
    from karpenter_tpu_torch.ops import ffd_kernels as fk
    from karpenter_tpu_torch.ops.decode import DecodeHealth
    from karpenter_tpu_torch.ops.health import SolverHealth
    from karpenter_tpu_torch.state import Cluster
    catalog = generate_catalog(workloads.PROVISION_TYPES)
    # the goldens were made in a fresh process: a guide cache warmed by
    # phase 8 (the column generation's support, stale mixes) may lead the
    # live cell's guided round 1 to another plan of the same LP
    clear_lp_caches()
    by_path, slabs, programs, scans = {}, {}, {}, {}
    for cell in workloads.GOLDEN_PROVISION:     # the sharded cell: phase 12
        rounds = workloads.PROVISION_CELLS[cell][1]
        health, dh = SolverHealth(), DecodeHealth()
        env = workloads.provision_env(cell, FakeCloud, CloudProvider, Cluster,
                                      Provisioner, NodePool, catalog,
                                      health=health, decode_health=dh,
                                      device=device)
        gold = workloads.GOLDEN_PROVISION[cell]
        total = {}
        t_cell = time.perf_counter()
        for r, (kw, seed) in enumerate(rounds):
            env.cluster.add_pods(workloads.build_pods(
                rng=np.random.default_rng(seed), **kw))
            if cell == LIVE_PATH and r == 1:
                provision_timings(torch, card, env, cell, catalog, device)
            reset_all_launches()
            with captured(cp, "classpack_slab") as k6, \
                    captured(cp, "class_pack_assign_slab_kernel") as prog, \
                    captured(fk, "ffd_scan") as k7, \
                    captured(cp, "classpack_assign_decode") as k3:
                t0 = time.perf_counter()
                sig, res = workloads.provision_pending(env)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            for k, v in all_launches().items():
                total[k] = total.get(k, 0) + v
            check(sig == gold[r], f"{cell} round {r + 1}: {sig} != golden "
                                  f"{gold[r]}")
            log(f"[provision] {cell} round {r + 1}: {sig['launched']} "
                f"launched, {sig['bound_new']} bound new / "
                f"{sig['bound_existing']} existing, {sig['unschedulable']} "
                f"unschedulable, total {sig['total_price']!r} in {wall:.3f} s "
                f"(first run) — golden matches; launches {all_launches()}")
            if k6:
                slabs[f"{cell} round {r + 1}"] = k6[-1]
                programs[f"{cell} round {r + 1}"] = prog[-1]
            for i, a in enumerate(k7):
                scans[f"{cell} round {r + 1} solve {i + 1}"] = a
            if k3:
                K3_RECORDED[f"{cell} round {r + 1}"] = k3[-1]
        snap = health.snapshot()
        check(not health.transitions and all(
            v["total_failures"] == 0 for v in snap["rungs"].values()),
            f"{cell}: the solver ladder booked a failure {snap}")
        check(dh.total_failures == 0 and not dh.transitions,
              f"{cell}: the decode breaker booked a failure "
              f"{dh.snapshot_state()}")
        by_path[cell] = total
        log(f"[provision] {cell}: {time.perf_counter() - t_cell:.1f} s, "
            f"launches {total}; ladder and decode breaker clean")
    for cell in (LIVE_PATH, NOGUIDE_PATH):
        check(by_path[cell]["classpack_slab"] >= 1,
              f"K6 classpack_slab never launched in {cell}")
    for cell in (SMALL_PATH, FFD_PATH):
        check(by_path[cell]["ffd_scan"] >= 1,
              f"K7 ffd_scan never launched in {cell}")
    return by_path, slabs, programs, scans


def provision_timings(torch, card, env, cell, catalog, device, iters=5):
    """Warm p50s on the frozen round-2 state of the live cell:
    Provisioner.solve (which changes nothing), then whole provision()
    rounds, each on a fresh copy, with their layer split."""
    batch = env.cluster.pending_pods()
    prov = env.provisioner
    prov.solve(batch)
    torch.cuda.synchronize()
    p50, xs = p50_ms(lambda: prov.solve(batch), iters, torch.cuda.synchronize)
    log(f"[time] {cell} round 2: Provisioner.solve warm p50 {p50:.3f} ms "
        f"over {iters} ({', '.join(f'{x:.1f}' for x in xs)}) on {card}")
    splits = []
    for _ in range(3):
        splits.append(provision_layers(torch, fresh_env(env, cell, catalog,
                                                        device)))
    med = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
    log(f"[time] {cell} round 2: provision() p50 {med['total']:.3f} ms "
        f"over 3 fresh copies (tensorize {med['tensorize']:.3f}, pack "
        f"{med['pack']:.3f}, launch {med['launch']:.3f}) on {card}")


def slab_program_plain(args):
    """class_pack_assign_slab_kernel composed of the plain versions."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    (req, cnt, packed, cap, alloc, price, rank, iopt, iused, K, n) = args
    m, ok = ck.classpack_precompute_plain(req, cap, packed, alloc, price,
                                          rank)
    slot_option, _, _, n_unsched, takes = ck.classpack_scan_plain(
        req, cnt, packed, cap, alloc, price, m, ok, iopt, iused, K, True)
    a = ck.classpack_assign_decode_plain(takes, cnt, n)
    order, counts = ck.classpack_slab_plain(a, K)
    return order, counts, slot_option, n_unsched


def once_ms(torch, fn):
    """CUDA-event time of one call with no warm-up (for the plain versions
    that run for tens of seconds)."""
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), out


def ffd_counts(args, out):
    """Row counts of one K7 scan from its inputs and outputs (open slots a
    prefix, as every main path lays them), the work the function needs.  A
    run is a sequence of valid rows of one class, each identical to the
    valid row before it (compat row, node cap, request bit for bit); a step
    is a run's rows in a row that went to one slot, or to none.  Counted:
    the open slots a first fit tests from the previous identical row's slot
    (the cursor) and, for comparison, from slot 0; the float32 adds that
    fill a slot inside a step; the runs that list new-node candidates (the
    options of the best pool rank that may open a node) and the candidates
    each new-node choice scores."""
    (req, packed, crow, cid, valid, cap, _, alloc, price, rank, iopt, _) = (
        None if t is None else t.cpu().numpy() for t in args)
    a = out[0].cpu().numpy()
    K = out[1].shape[0]
    O = alloc.shape[0]
    comp = np.unpackbits(packed, axis=1, count=O).astype(bool)
    finite = np.isfinite(price)
    n_open = 0 if iopt is None else int((iopt >= 0).sum())
    c = dict(K=K, rows=len(a), valid_rows=int(valid.sum()), runs=0, steps=0,
             fill_adds=0, looked=0, opened=0, candidate_runs=0, scored=0,
             tests_from_0=0, tests_from_cursor=0)
    prev_cid, key, cursor, last, ncand = None, None, 0, None, None
    for i in range(len(a)):
        if cid[i] != prev_cid:
            key = None
        prev_cid = cid[i]
        if not valid[i]:
            continue
        k = int(a[i])
        row_key = (int(crow[i]), int(cap[i]), req[i].tobytes())
        if row_key != key:
            c["runs"] += 1
            key, cursor, last, ncand = row_key, 0, None, None
        if k != last:
            c["steps"] += 1
        elif k >= 0:
            c["fill_adds"] += 1
        last = k
        if 0 <= k < n_open:
            c["tests_from_0"] += k + 1
            c["tests_from_cursor"] += k - cursor + 1
            cursor = k
            continue
        c["tests_from_0"] += n_open
        c["tests_from_cursor"] += n_open - cursor
        if n_open < K:
            c["looked"] += 1
            if ncand is None:
                c["candidate_runs"] += 1
                ok = (comp[crow[i]] & finite
                      & (req[i][None, :] <= alloc).all(1))
                ncand = int((rank[ok] == rank[ok].min()).sum()) if ok.any() \
                    else 0
            c["scored"] += ncand
        if k == n_open:
            c["opened"] += 1
            n_open += 1
        cursor = k if k >= 0 else n_open
    return c


def ffd_bound(args, counts, cycles):
    """(bound ms, "bytes" or "operations", binding term, {term: ms}) of one
    K7 scan, from its row counts (`ffd_counts`) and `cycles`, the card's
    (least row step, dependent float32 add) in SM cycles
    (`ffd_kernels.step_cycles`), the largest of three terms:
      bytes       its inputs and outputs, each once, over the memory rate;
      operations  the fit tests from the cursor (2R each), the candidate
                  list of each run that needs one (4R + 3 per option) and
                  the scores of each new-node choice (5 per candidate),
                  over the card's float32 peak;
      dependency  the chain from row to row: each row reads the state the
                  row before it wrote, so each step takes at least one
                  least row step, and each further row of a step one
                  dependent add (the reference's float32 adds, in order),
                  at the card's maximum SM clock.  Operations in sequence:
                  its bound_by is "operations"."""
    req, alloc = args[0], args[7]
    K = counts["K"]
    P, R = req.shape
    O = alloc.shape[0]
    nbytes = sum(t.numel() * t.element_size() for t in args
                 if t is not None)
    nbytes += P * 4 + K * 4 + K * R * 4 + 4
    nops = (counts["tests_from_cursor"] * 2 * R
            + counts["candidate_runs"] * O * (4 * R + 3)
            + counts["scored"] * 5)
    step, add = cycles
    terms = {"bytes": nbytes / MEM_BW * 1e3,
             "operations": nops / F32_PEAK * 1e3,
             "dependency": (counts["steps"] * step + counts["fill_adds"] * add)
             / SM_CLOCK_HZ * 1e3}
    term = max(terms, key=terms.get)
    return (terms[term], "bytes" if term == "bytes" else "operations", term,
            terms)


SLAB_KERNELS = ("slab_count_kernel", "slab_scan_kernel", "slab_scatter_kernel")


def slab_trace(torch, card, what, fn, iters=3):
    """`device_busy` of `fn`, a call that launches K6 or K6s once, with
    K6's launch counters read around the same calls: one K6 launch a call,
    and a trace that names no kernel of K6's earlier design (the per-chunk
    rank kernel) and names K6's kernels of this design; each one's device
    time per launch (its device time over the launches the trace recorded)
    is logged with that count: K6's split by launch.  A profiler trace of
    these ctypes launches has missed some kernels in some runs, so the
    names it misses are logged, not failed: the counters say that the
    wrapper launched (each launch's error is checked there)."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    keys = ("classpack_slab", "classpack_slab_sharded")
    before = sum(ck.LAUNCHES[k] for k in keys)
    busy = device_busy(torch, fn, iters)
    calls = sum(ck.LAUNCHES[k] for k in keys) - before
    slab = {k: v for k, v in busy["per_kernel"].items() if "slab_" in k}
    split = {}
    for n in SLAB_KERNELS:
        ks = [k for k in slab if n in k]
        if ks:
            count = sum(busy["events"][k] for k in ks)
            split[n] = (sum(slab[k] for k in ks) * iters / count, count)
    check(calls == iters + 1 and split
          and not any("slab_rank_kernel" in k for k in slab),
          f"{what}: {calls} K6 launches in {iters + 1} calls; the trace "
          f"names {sorted(slab)}")
    missed = [n for n in SLAB_KERNELS if n not in split]
    log(f"[trace] {what}: K6 launched once a call ({calls} calls, {iters} "
        f"traced); its kernels' device ms per launch (launches in the "
        f"trace) { {n: (round(v, 5), c) for n, (v, c) in split.items()} }"
        + (f", missed by the trace: {missed}" if missed else "")
        + f" on {card}")
    return busy


def provision_kernel_rows(torch, card, by_path, slabs, programs, scans, err):
    """Phase 10's kernel checks and times: K7 against its plain version on
    every provision-small batch and on the provision-ffd-50k scan; then
    the JSON rows of K6, K7, rows 7-8 (the slab programs) and row 11."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    from karpenter_tpu_torch.ops import ffd_kernels as fk
    from karpenter_tpu_torch.ops.classpack import \
        class_pack_assign_slab_kernel
    cycles = min(fk.step_cycles() for _ in range(3))
    log(f"[probe] K7's dependent steps on this card (clock64, one warp): "
        f"{cycles[0]:.2f} SM cycles a least row step (shared-memory load, "
        f"float32 add and compare, warp vote), {cycles[1]:.2f} a dependent "
        f"float32 add; at the maximum SM clock {SM_CLOCK_HZ / 1e6:.0f} MHz")
    small, small_bound = {}, {}
    for name, a in scans.items():
        if name.startswith(SMALL_PATH):
            got = compare_ffd_args(torch, name, a[:-1], a[-1])
            small[name] = card_ms(torch, lambda: fk.ffd_scan(*a[:-1], a[-1]),
                                  20)
            ms = event_ms(torch, lambda: fk.ffd_scan(*a[:-1], a[-1]), 10)
            counts = ffd_counts(a[:-1], got)
            b, _, term, _ = ffd_bound(a[:-1], counts, cycles)
            small_bound[name] = b
            log(f"[ffd] {name}: P={a[0].shape[0]} K={a[-1]} "
                f"n_open={int(got[3])} -> equal to plain; K7 "
                f"{small[name]:.4f} ms on the card ({ms:.4f} ms CUDA events "
                f"back to back), bound {b * 1e3:.3f} us by {term}; rows "
                f"{counts} on {card}")

    def paths(name):
        return {p: c.get(name, 0) for p, c in by_path.items()}

    rows = []
    # K6 and rows 7-8 at the live cell's round 2 (E = 1463), then row 8
    for key, path, row_name, replaces in (
            (f"{LIVE_PATH} round 2", LIVE_PATH,
             "class_pack_assign_slab_kernel",
             "karpenter_tpu/ops/classpack.py:263"),
            (f"{NOGUIDE_PATH} round 1", NOGUIDE_PATH,
             "class_pack_assign_slab_kernel_fresh",
             "karpenter_tpu/ops/classpack.py:301")):
        assignment, K = slabs[key]
        n = assignment.shape[0]
        ms = card_ms(torch, lambda: ck.classpack_slab(assignment, K), 20)
        host_ms = event_ms(torch, lambda: ck.classpack_slab(assignment, K),
                           20)
        plain_ms = event_ms(torch, lambda: ck.classpack_slab_plain(
            assignment, K), 3)

        def lib():
            key_ = torch.where(assignment >= 0, assignment.to(torch.int32), K)
            torch.argsort(key_, stable=True)
            k64 = key_.long()
            torch.zeros(K + 1, dtype=torch.int64,
                        device=k64.device).scatter_add_(
                0, k64, torch.ones_like(k64))
        lib_ms = card_ms(torch, lib, 20)
        nbytes = n * assignment.element_size() + n * 4 + K * 4
        bound = nbytes / MEM_BW * 1e3
        if path == LIVE_PATH:
            rows.append(dict(
                name="classpack_slab", route="cuda",
                source="karpenter_tpu_torch/csrc/classpack.cu",
                replaces="karpenter_tpu/ops/classpack.py:280",
                launches=by_path[LIVE_PATH]["classpack_slab"], path=LIVE_PATH,
                launches_by_path=paths("classpack_slab"),
                max_abs_err=err["classpack_slab"], ms=ms, host_ms=host_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                library_ms=lib_ms))
        log(f"[kernel] classpack_slab ({key}, n={n}, K={K}): {ms:.4f} ms "
            f"on the card (back-to-back host rate {host_ms:.4f} ms; plain "
            f"{plain_ms:.4f} ms, library argsort+scatter_add_ "
            f"{lib_ms:.4f} ms, bound {bound * 1e3:.3f} us by bytes) on {card}")
        # the whole slab program at the same inputs
        args = programs[key]
        got = class_pack_assign_slab_kernel(*args)
        p_ms, want = once_ms(torch, lambda: slab_program_plain(args))
        for g, w, what in zip(got, want, ("order", "slot_counts",
                                          "slot_option", "n_unsched")):
            check(torch.equal(g, w), f"{row_name} {what} differs from the "
                                     f"plain programs ({key})")
        slab_trace(torch, card, f"{row_name} ({key})",
                   lambda: class_pack_assign_slab_kernel(*args))
        prog_ms = event_ms(torch, lambda: class_pack_assign_slab_kernel(*args),
                           5)
        (req, cnt, packed, cap, alloc, price, rank, iopt, iused, Kp,
         Ppad) = args
        # the program's kernels one by one at the same inputs
        m, ok = ck.classpack_precompute(req, cap, packed, alloc, price, rank)
        takes = ck.classpack_scan(req, cnt, packed, cap, alloc, price, m, ok,
                                  iopt, iused, Kp, True)[4]
        split = dict(
            K1=event_ms(torch, lambda: ck.classpack_precompute(
                req, cap, packed, alloc, price, rank), 10),
            K2=event_ms(torch, lambda: ck.classpack_scan(
                req, cnt, packed, cap, alloc, price, m, ok, iopt, iused, Kp,
                True), 5),
            K3=event_ms(torch, lambda: ck.classpack_assign_decode(
                takes, cnt, Ppad), 10))
        log(f"[kernel] {row_name} ({key}) by kernel: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in split.items()) + f" (CUDA events), "
            f"K6 {ms:.4f} ms on the card on {card}")
        R2, O2 = req.shape[1], price.shape[0]
        k2_args = (req, cnt, packed, cap, alloc, price, m, ok, iopt, iused,
                   Kp, True)
        k2_ms = card_ms(torch, lambda: ck.classpack_scan(*k2_args), 5)
        counts = scan_counts(cnt.cpu().numpy(), takes.cpu().numpy(),
                             0 if iopt is None else int((iopt >= 0).sum()),
                             Kp)
        k2_bytes = sum(t.numel() * t.element_size()
                       for t in k2_args[:10] if t is not None)
        k2_bytes += Kp * 4 + Kp * R2 * 4 + takes.numel() * 4 + 8
        b, _, term, terms = scan_bound(k2_bytes, [counts], R2, O2,
                                       least_step())
        scan_step_line(card, key, R2, O2, Kp, 1, k2_ms, [counts])
        log(f"[kernel] classpack_scan at {key}: {k2_ms:.4f} ms on the card, "
            f"bound {b:.5f} ms by {term} (terms {terms}; {k2_ms / b:.2f}x) "
            f"from {counts} on {card}")
        pbytes = sum(t.numel() * t.element_size()
                     for t in args[:9] if t is not None)
        pbytes += Ppad * 4 + Kp * 8 + 4
        # the program's own bytes, or its K2's operations or class-to-class
        # dependency, whichever is larger
        pbound, pby, pterm, pterms = scan_bound(pbytes, [counts], R2, O2,
                                                least_step())
        rows.append(dict(
            name=row_name, route="cuda",
            source="karpenter_tpu_torch/ops/classpack.py",
            replaces=replaces, launches=by_path[path]["classpack_slab"],
            path=path, launches_by_path=paths("classpack_slab"),
            max_abs_err=0.0, ms=prog_ms, plain_ms=p_ms, bound_ms=pbound,
            bound_by=pby, bound_term=pterm, bound_terms=pterms,
            library_ms=None))
        log(f"[kernel] {row_name} ({key}: K1+K2+K3+K6, Cpad="
            f"{req.shape[0]}, Opad={price.shape[0]}, K={Kp}, Ppad={Ppad}, "
            f"E={0 if iopt is None else int((iopt >= 0).sum())}): "
            f"{prog_ms:.4f} ms (plain {p_ms:.3f} ms, bound "
            f"{pbound * 1e3:.3f} us by {pterm}, terms {pterms}) — equal to "
            f"the plain programs on {card}")
    # K7 and row 11 at provision-ffd-50k
    name = f"{FFD_PATH} round 1 solve 1"
    a = scans[name]
    args, K = a[:-1], a[-1]
    ms = card_ms(torch, lambda: fk.ffd_scan(*args, K), 3)
    host_ms = event_ms(torch, lambda: fk.ffd_scan(*args, K), 3)
    got = fk.ffd_scan(*args, K)
    plain_ms, want = once_ms(torch, lambda: fk.ffd_scan_plain(*args, K))
    for g, w, what in zip(got, want, ("assignment", "slot_option",
                                      "slot_used", "n_open")):
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"K7 ffd_scan {what} differs from plain ({name})")
    counts = ffd_counts(args, got)
    bound, by, term, terms = ffd_bound(args, counts, cycles)
    log(f"[kernel] ffd_scan ({name}: Ppad={args[0].shape[0]}, "
        f"Opad={args[7].shape[0]}, K={K}, n_open={int(got[3])}): "
        f"{ms:.3f} ms on the card (CUDA events {host_ms:.3f} ms; plain "
        f"{plain_ms:.1f} ms, library None, bound {bound:.4f} ms by {term}, "
        f"terms {terms}; {ms / bound:.2f}x the bound) — equal to plain; "
        f"rows {counts}; provision-small-3x64 batches "
        f"{[round(v, 4) for v in small.values()]} ms (bounds "
        f"{[round(v, 5) for v in small_bound.values()]} ms) on {card}")
    # row 11: solve_ffd's scan is K7, one row for both
    rows.append(dict(
        name="ffd_scan", route="cuda", source="karpenter_tpu_torch/csrc/ffd.cu",
        replaces="karpenter_tpu/ops/ffd.py:43",
        launches=by_path[FFD_PATH]["ffd_scan"], path=FFD_PATH,
        launches_by_path=paths("ffd_scan"), max_abs_err=err["ffd_scan"],
        ms=ms, host_ms=host_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        bound_term=term, bound_terms=terms, step_cycles=list(cycles),
        rows=counts, small_ms=list(small.values()),
        small_bound_ms=list(small_bound.values()), library_ms=None))
    return rows


# ---------------------------------------------------------------------------
# phase 11: the shard-batched kernels against their plain versions
# ---------------------------------------------------------------------------

SHARDS = 8
MEGA_PATH = "megafleet-8x125k"
HEAD_SHARDED_PATH = "headline-sharded"
CELL_PATH = "provision-sharded-50k-20k"
# the kernels of the sharded main paths: every one must launch there
SHARDED_STEPS = ("classpack_precompute_sharded", "classpack_scan_sharded")


def shard_mesh(hosts=None):
    from karpenter_tpu_torch.parallel import make_host_mesh, make_pod_mesh
    if hosts:
        return make_host_mesh(hosts, SHARDS // hosts,
                              shards_per_device=SHARDS)
    return make_pod_mesh(SHARDS, shards_per_device=SHARDS)


def stacked(args, kind):
    """A row 13-17 program's captured arguments in the shard-batched
    kernels' form: dict(req, cnt, packed, cap — n × …, shared operands as
    stride-0 views —, alloc, price, rank, iopt, iused, K, Ppad, hosts)."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    n = args[1].shape[0]
    if kind in ("sharded_pack", "partitioned_pack"):
        req, cnt, compat, cap, alloc, price, rank, K, mesh = args
        if compat.dim() == 2:
            packed = ck.pack_bits(compat)
        else:
            packed = ck.pack_bits(compat.reshape(-1, compat.shape[-1])
                                  ).reshape(*compat.shape[:2], -1)
        iopt = iused = Ppad = None
    else:
        (req, cnt, packed, cap, alloc, price, rank, iopt, iused, K, Ppad,
         mesh) = args
    if req.dim() == 2:
        req = req.unsqueeze(0).expand(n, *req.shape)
    if cap.dim() == 1:
        cap = cap.unsqueeze(0).expand(n, *cap.shape)
    if packed.dim() == 2:
        packed = packed.unsqueeze(0).expand(n, *packed.shape)
    return dict(req=req, cnt=cnt, packed=packed, cap=cap, alloc=alloc,
                price=price, rank=rank, iopt=iopt, iused=iused, K=K,
                Ppad=Ppad, hosts=mesh.hosts)


def sharded_run(s, plain=False, emit=True):
    """K1, K2, K3 (with emit), K4, K6 (with emit) and K8 on stacked shards,
    through the wrappers or their plain versions.  Returns a dict."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    sfx = "_plain" if plain else ""

    def f(name):
        return getattr(ck, name + sfx)
    out = {}
    out["m"], out["ok"] = f("classpack_precompute_sharded")(
        s["req"], s["cap"], s["packed"], s["alloc"], s["price"], s["rank"])
    scan = f("classpack_scan_sharded")(
        s["req"], s["cnt"], s["packed"], s["cap"], s["alloc"], s["price"],
        out["m"], out["ok"], s["iopt"], s["iused"], s["K"], emit)
    for k, v in zip(("slot_option", "slot_used", "n_open", "n_unsched",
                     "takes"), scan):
        out[k] = v
    if emit:
        out["assignment"] = f("classpack_assign_decode_sharded")(
            out["takes"], s["cnt"], s["Ppad"])
        out["order"], out["slot_counts"] = f("classpack_slab_sharded")(
            out["assignment"], s["K"])
    out["flat"] = f("classpack_aggregate_sharded")(
        out["slot_option"], s["price"], out["n_open"], out["n_unsched"])
    out["psum"] = f("shard_psum")(out["flat"], s["hosts"])
    return out


def serial_run(s, emit=True):
    """The same shards as n serial launches of the single-device kernels
    (the yardstick of the grid axis, never a path)."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    outs = []
    for i in range(s["cnt"].shape[0]):
        o = {}
        cnt = s["cnt"][i].contiguous()
        o["m"], o["ok"] = ck.classpack_precompute(
            s["req"][i], s["cap"][i], s["packed"][i], s["alloc"], s["price"],
            s["rank"])
        scan = ck.classpack_scan(
            s["req"][i], cnt, s["packed"][i], s["cap"][i], s["alloc"],
            s["price"], o["m"], o["ok"],
            None if s["iopt"] is None else s["iopt"][i],
            None if s["iused"] is None else s["iused"][i], s["K"], emit)
        for k, v in zip(("slot_option", "slot_used", "n_open", "n_unsched",
                         "takes"), scan):
            o[k] = v
        if emit:
            o["assignment"] = ck.classpack_assign_decode(o["takes"], cnt,
                                                         s["Ppad"])
            o["order"], o["slot_counts"] = ck.classpack_slab(
                o["assignment"], s["K"])
        o["flat"] = ck.classpack_aggregate(o["slot_option"], s["price"],
                                           o["n_open"], o["n_unsched"])
        outs.append(o)
    return outs


def compare_sharded(torch, name, s, err, emit=True):
    """Every shard-batched kernel against its plain version (integers
    equal, K4's float32 cost within REL_TOL, K8 bit for bit) and, shard for
    shard, against n serial single-device launches (all bit for bit: the
    same kernels at n = 1); K8 on the flat mesh and on 2 x 4 hosts."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    got = sharded_run(s, emit=emit)
    again = sharded_run(s, emit=emit)
    want = sharded_run(s, plain=True, emit=emit)
    ser = serial_run(s, emit=emit)
    torch.cuda.synchronize()
    for k in got:
        check(torch.equal(got[k], again[k]),
              f"sharded {k}: two launches differ ({name})")
    for k in got:
        g, w = got[k], want[k]
        if k == "flat":
            check(torch.equal(g[:, 1:], w[:, 1:]),
                  f"K4 sharded counts differ from plain ({name})")
            d = (g[:, 0].double() - w[:, 0].double()).abs()
            ok = bool((d <= REL_TOL * w[:, 0].double().abs().clamp(
                min=1e-30)).all())
            check(ok, f"K4 sharded cost differs from plain ({name})")
            err["classpack_aggregate_sharded"] = max(
                err["classpack_aggregate_sharded"], float(d.max()))
            continue
        if k == "psum":
            # K8 on the kernels' flat against its plain version, bit for bit
            check(torch.equal(g, ck.shard_psum_plain(got["flat"],
                                                     s["hosts"])),
                  f"K8 differs from plain ({name})")
            continue
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"sharded {k} differs from plain ({name})")
    for i, o in enumerate(ser):
        for k, v in o.items():
            check(torch.equal(got[k][i], v),
                  f"sharded {k} of shard {i} differs from the single-device "
                  f"kernel ({name})")
    flat = got["flat"]
    n = s["cnt"].shape[0]
    hosts = 2 if n % 2 == 0 else 1
    flat8, flat24 = ck.shard_psum(flat, 1), ck.shard_psum(flat, hosts)
    check(torch.equal(flat8, ck.shard_psum_plain(flat, 1))
          and torch.equal(flat24, ck.shard_psum_plain(flat, hosts)),
          f"K8 flat / {hosts} hosts differs from plain ({name})")
    check(torch.equal(flat8[1:], flat24[1:]),
          f"K8 integer fields differ between the flat and {hosts}-host "
          f"meshes ({name})")
    un = got["n_unsched"].tolist()
    empty = int((s["cnt"].sum(1) == 0).sum())
    log(f"[sharded] {name}: n={n} Cpad={s['req'].shape[1]} "
        f"Opad={s['price'].shape[0]} K={s['K']} Ppad={s['Ppad']} empty "
        f"shards {empty}, n_open {got['n_open'].tolist()}, n_unsched {un} "
        f"-> K1-K4, K6, K8 equal to plain and to {n} single-device launches, "
        f"two launches bit-equal; "
        f"K8 cost flat {float(flat8[0])!r} vs {hosts} hosts "
        f"{float(flat24[0])!r} "
        f"(bit-equal: {bool(flat8[0] == flat24[0])})")
    return got


def compare_slab_layouts(torch, name, a, K):
    """K6s on one row-17 input's slots in both layouts, int16 (K3's at
    fewer than 2^15 slots) and int32: equal to plain, each launched twice
    with the same bits."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    for x in (a.to(torch.int16), a.to(torch.int32)):
        got = ck.classpack_slab_sharded(x, K)
        again = ck.classpack_slab_sharded(x, K)
        want = ck.classpack_slab_sharded_plain(x, K)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) and torch.equal(g, h)
                  for g, h, w in zip(got, again, want)),
              f"K6s differs from plain or between launches ({name}, "
              f"{x.dtype})")
    log(f"[sharded] {name}: K6s on {tuple(a.shape)} slots, K={K}, int16 and "
        f"int32 -> equal to plain, two launches bit-equal")


def owned_by_one(head, ex, K):
    """Row 14's inputs with every existing column owned by shard 0 (the
    other shards see none), overcommitted ones among them."""
    from karpenter_tpu_torch.ops.classpack import _upload
    from karpenter_tpu_torch.ops.tensorize import pad_to
    from karpenter_tpu_torch.parallel import sharded
    mesh = shard_mesh()
    n = SHARDS
    (order, C, Cpad, R, O, E, Opad, requests, compat, alloc, price, rank,
     node_cap, counts) = sharded._lower(head, mesh, ex["existing_alloc"],
                                        ex["existing_compat"])
    compat_sh = np.repeat(compat[None], n, axis=0)
    compat_sh[1:, :, O:O + E] = False
    init_opt = np.full((n, K), -1, np.int32)
    init_used = np.zeros((n, K, R), np.int32)
    init_opt[0, :E] = np.arange(O, O + E, dtype=np.int32)
    init_used[0, :E] = np.ceil(ex["existing_used"]).astype(np.int32)
    free0 = alloc[O:O + E] - init_used[0, :E]
    dev = mesh.device
    s = dict(req=_upload(requests, dev).unsqueeze(0).expand(n, Cpad, R),
             cnt=_upload(counts, dev),
             packed=_upload(np.packbits(compat_sh, axis=2), dev),
             cap=_upload(node_cap, dev).unsqueeze(0).expand(n, Cpad),
             alloc=_upload(alloc, dev), price=_upload(price, dev),
             rank=_upload(rank, dev), iopt=_upload(init_opt, dev),
             iused=_upload(init_used, dev), K=K,
             Ppad=pad_to(int(counts.sum(1).max())), hosts=1)
    return s, int((free0 < 0).any(axis=1).sum())


def phase11(torch, caps, head, ex, err):
    """Phase 11 on each path's real inputs (`caps`, recorded in phase 12's
    counted runs: rows 13-17 and the cell's row 17 in both rounds) and on
    seeded perturbations."""
    from karpenter_tpu_torch.ops.tensorize import pad_to
    cases = {}
    for row, (kind, args) in caps.items():
        cases[row] = stacked(args, kind)
        got = compare_sharded(torch, f"{row} ({kind}, real)", cases[row], err,
                              emit=not kind.endswith("pack"))
        if kind == "partitioned_assign_slab":
            compare_slab_layouts(torch, row, got["assignment"],
                                 cases[row]["K"])
    base = cases["row 17"]
    # empty shards: two of the megafleet's shards given no pods
    s = dict(base, cnt=base["cnt"].clone())
    s["cnt"][[2, 5]] = 0
    compare_sharded(torch, "row 17, shards 2 and 5 empty", s, err)
    # slot exhaustion in one shard: shard 0's pods x4 at K = 2048
    s = dict(base, cnt=base["cnt"].clone(), K=2048,
             iopt=base["iopt"][:, :2048].contiguous(),
             iused=base["iused"][:, :2048].contiguous())
    s["cnt"][0] *= 4
    s["Ppad"] = pad_to(int(s["cnt"].sum(1).max()))
    got = compare_sharded(torch, "row 17, shard 0 x4 pods at K=2048", s,
                          err)
    un = got["n_unsched"].tolist()
    check(un[0] > 0 and not any(un[1:]),
          f"exhaustion case: expected shard 0 alone to run out, {un}")
    # every existing column owned by shard 0, overcommitted ones included
    s, neg = owned_by_one(head, ex, base["K"])
    got = compare_sharded(torch, f"row 14, 512 existing owned by shard 0 "
                                 f"({neg} with negative free space)", s, err)
    check(neg > 0, "no existing node with negative free space")
    # n = 1: the shard-batched kernels against the single-device ones
    one = {k: (v[:1].contiguous() if k in ("req", "cnt", "packed", "cap",
                                           "iopt", "iused") else v)
           for k, v in base.items()}
    compare_sharded(torch, "row 17, n = 1", one, err)
    return cases


# ---------------------------------------------------------------------------
# phase 12: the sharded paths, goldens, timings
# ---------------------------------------------------------------------------

def sharded_paths(torch, card, mega, head, ex, catalog):
    """The three paths against GOLDEN_SHARDED, each solve with the launch
    counts zeroed just before it and read just after, the arguments of the
    programs recorded as they run.  Returns (launches by path, {case:
    (program kind, arguments)}: rows 13-17 from the headline's 8-shard
    mesh and the megafleet, and the cell's row 17 in each round)."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.api.objects import NodePool
    from karpenter_tpu_torch.cloud import CloudProvider, FakeCloud
    from karpenter_tpu_torch.controllers.provisioning import Provisioner
    from karpenter_tpu_torch.ops.decode import DecodeHealth
    from karpenter_tpu_torch.ops.health import SolverHealth
    from karpenter_tpu_torch.parallel import driver, sharded
    from karpenter_tpu_torch.parallel import solve_partitioned, solve_sharded
    from karpenter_tpu_torch.state import Cluster
    gold = workloads.GOLDEN_SHARDED
    by_path, caps = {}, {}

    def counted(path, fn, single_scans):
        reset_all_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = all_launches()
        by_path[path] = got
        for k in SHARDED_STEPS:
            check(got[k] >= 1, f"{k} never launched in {path}")
        check(got["classpack_scan"] == single_scans,
              f"{path}: the single-device scan launched "
              f"{got['classpack_scan']} times, expected {single_scans}")
        return res, wall, got

    def same(path, got, want, psum):
        check(got[0] == want[0], f"{path}: digest {got[0]} != golden "
                                 f"{want[0]}")
        if psum:
            check(abs(got[1] - want[1]) <= workloads.PSUM_RTOL * want[1],
                  f"{path}: cost {got[1]!r} vs golden {want[1]!r}")
        else:
            check(got[1] == want[1], f"{path}: total {got[1]!r} vs golden "
                                     f"{want[1]!r}")
        return "bit-equal" if got[1] == want[1] else \
            f"rel {abs(got[1] - want[1]) / want[1]:.3g}"

    mesh = shard_mesh()
    with captured(driver, "_partitioned_pack") as p15, \
            captured(driver, "_partitioned_assign_donate") as p16, \
            captured(driver, "_partitioned_assign_slab_donate") as p17:
        for mode, kw in workloads.MEGAFLEET_MODES.items():
            path = f"{MEGA_PATH}-{mode}"
            res, wall, got = counted(path, lambda: solve_partitioned(
                mega, mesh=mesh, max_nodes_per_shard=workloads.MEGAFLEET_K,
                **kw), 1)
            ans = workloads.sharded_answer(mega, res)
            how = same(path, ans, gold[MEGA_PATH][mode], mode == "aggregate")
            log(f"[sharded] {path}: total {ans[1]!r} ({how} to the golden) "
                f"in {wall:.3f} s (first run); launches "
                f"{ {k: v for k, v in got.items() if v} }")
    K = workloads.HEADLINE_SHARDED_K
    with captured(sharded, "_sharded_pack") as p13, \
            captured(sharded, "_sharded_assign") as p14:
        for name, m in (("pods", mesh), ("hosts", shard_mesh(hosts=2))):
            for decode in (False, True):
                path = (f"{HEAD_SHARDED_PATH}-{name}-"
                        f"{'decode' if decode else 'aggregate'}")
                res, wall, got = counted(path, lambda: solve_sharded(
                    head, m, max_nodes_per_shard=K, decode=decode,
                    **(ex if decode else {})), 0)
                ans = workloads.sharded_answer(head, res)
                how = same(path, ans,
                           gold[HEAD_SHARDED_PATH][(name, decode)],
                           not decode)
                log(f"[sharded] {path}: total {ans[1]!r} ({how} to the "
                    f"golden) in {wall:.3f} s (first run); launches "
                    f"{ {k: v for k, v in got.items() if v} }")
    # the 8-shard mesh's calls come first
    caps["row 13"] = ("sharded_pack", p13[0])
    caps["row 14"] = ("sharded_assign", p14[0])
    caps["row 15"] = ("partitioned_pack", p15[0])
    caps["row 16"] = ("partitioned_assign", p16[0])
    caps["row 17"] = ("partitioned_assign_slab", p17[0])
    # the provisioning cell through the sharded rung
    health, dh = SolverHealth(), DecodeHealth()
    env = workloads.provision_env(CELL_PATH, FakeCloud, CloudProvider,
                                  Cluster, Provisioner, NodePool, catalog,
                                  health=health, decode_health=dh,
                                  mesh=mesh)
    for r, (kw, seed) in enumerate(workloads.PROVISION_CELLS[CELL_PATH][1]):
        env.cluster.add_pods(workloads.build_pods(
            rng=np.random.default_rng(seed), **kw))
        if r == 1:
            cell_timings(torch, card, env, catalog, mesh)
        path = f"{CELL_PATH} round {r + 1}"
        with captured(driver, "_partitioned_assign_slab_donate") as p17:
            (sig, _), wall, got = counted(
                path, lambda: workloads.provision_pending(env), 0)
        check(sig == gold[CELL_PATH][r], f"{path}: {sig} != golden "
                                         f"{gold[CELL_PATH][r]}")
        check(got["classpack_slab_sharded"] == 1,
              f"{path}: row 17 did not answer the round")
        caps[path] = ("partitioned_assign_slab", p17[-1])
        log(f"[sharded] {path}: {sig['launched']} launched, "
            f"{sig['bound_new']} bound new / {sig['bound_existing']} "
            f"existing, {sig['unschedulable']} unschedulable, total "
            f"{sig['total_price']!r} in {wall:.3f} s (first run) — golden "
            f"matches; launches { {k: v for k, v in got.items() if v} }")
    check(not health.transitions and dh.total_failures == 0,
          f"{CELL_PATH}: the ladder or the decode breaker booked a failure")
    return by_path, caps


def cell_timings(torch, card, env, catalog, mesh, iters=3):
    """The cell's round 2, warm: Provisioner.solve p50 on the frozen state,
    then whole provision() rounds on fresh copies with their split."""
    batch = env.cluster.pending_pods()
    prov = env.provisioner
    prov.solve(batch)
    torch.cuda.synchronize()
    p50, xs = p50_ms(lambda: prov.solve(batch), iters,
                     torch.cuda.synchronize)
    log(f"[time] {CELL_PATH} round 2: Provisioner.solve warm p50 "
        f"{p50:.3f} ms over {iters} ({', '.join(f'{x:.1f}' for x in xs)}) "
        f"on {card}")
    splits = [provision_layers(torch, fresh_env(env, CELL_PATH, catalog,
                                                "cuda", mesh=mesh))
              for _ in range(3)]
    med = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
    log(f"[time] {CELL_PATH} round 2: provision() p50 {med['total']:.3f} ms "
        f"over 3 fresh copies (tensorize {med['tensorize']:.3f}, pack "
        f"{med['pack']:.3f}, launch {med['launch']:.3f}) on {card}")


def sharded_solve_timings(torch, card, mega, head, ex):
    """Warm p50 of each solve_partitioned mode on the megafleet and of
    solve_sharded on the headline, and the device idle share of the
    megafleet slab solve."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.parallel import solve_partitioned, solve_sharded
    sync = torch.cuda.synchronize
    mesh = shard_mesh()
    out = {}
    for mode, kw in workloads.MEGAFLEET_MODES.items():
        out[f"{MEGA_PATH} {mode}"] = p50_ms(lambda: solve_partitioned(
            mega, mesh=mesh, max_nodes_per_shard=workloads.MEGAFLEET_K,
            **kw), 3, sync)
    K = workloads.HEADLINE_SHARDED_K
    for name, m in (("pods", mesh), ("hosts", shard_mesh(hosts=2))):
        for decode in (False, True):
            out[f"{HEAD_SHARDED_PATH} {name} decode={decode}"] = p50_ms(
                lambda: solve_sharded(head, m, max_nodes_per_shard=K,
                                      decode=decode,
                                      **(ex if decode else {})), 3, sync)
    for k, (p50, xs) in out.items():
        log(f"[time] {k}: warm p50 {p50:.3f} ms over {len(xs)} "
            f"({', '.join(f'{x:.1f}' for x in xs)}) on {card}")
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    before = ck.LAUNCHES["classpack_scan_sharded"]
    busy = slab_trace(torch, card, f"{MEGA_PATH} slab solve",
                      lambda: solve_partitioned(
                          mega, mesh=mesh,
                          max_nodes_per_shard=workloads.MEGAFLEET_K,
                          device_decode=True), iters=2)
    k2s = ck.LAUNCHES["classpack_scan_sharded"] - before
    hit = [k for k in busy["names"] if "cluster_scan_kernel" in k]
    stale = [k for k in busy["names"] if "::scan_kernel<" in k]
    check(k2s == 3 and hit and not stale,
          f"{MEGA_PATH} slab solve: K2s launched {k2s} times in 3 calls; "
          f"the trace names {hit} of this design and {stale} of the earlier")
    log(f"[trace] {MEGA_PATH} slab solve: classpack_scan_sharded launched "
        f"{k2s} times in 3 calls; the trace names {[k[:60] for k in hit]} "
        f"({sum(busy['events'][k] for k in hit)} launches recorded) and no "
        f"kernel of the earlier design on {card}")
    log(f"[trace] {MEGA_PATH} slab solve: device busy "
        f"{busy['device_ms']:.3f} of {busy['wall_ms']:.3f} ms wall per "
        f"solve, idle share {busy['idle_share']:.4f}; by kernel "
        f"{busy['by_kernel']} on {card}")
    return out


def sharded_bounds(s, got):
    """(bytes, operations) of each shard-batched kernel at stacked inputs
    `s` with its outputs `got`: inputs read once (a shared operand once),
    outputs written once; K2's operations are the fit over each shard's
    slots open at the end and the score over every option, per class."""
    n, C, R = s["req"].shape
    O, K = s["price"].shape[0], s["K"]
    OB = s["packed"].shape[2]
    Ppad = s["Ppad"] or 0

    def nb(t, per_shard=True):
        if t is None:
            return 0
        shared = t.dim() > 0 and t.stride(0) == 0
        one = t[0] if (per_shard and t.dim() > 1) else t
        return one.numel() * one.element_size() * (
            1 if shared or not per_shard else n)
    cat = O * R * 4 + O * 8
    n_open = got["n_open"].cpu().numpy()
    b = {}
    b["classpack_precompute_sharded"] = (
        nb(s["req"]) + nb(s["cap"]) + nb(s["packed"]) + cat + n * C * O * 5,
        n * C * O * (2 * R + 4))
    b["classpack_scan_sharded"] = (
        nb(s["req"]) + nb(s["cnt"]) + nb(s["packed"]) + nb(s["cap"])
        + n * C * O * 5 + O * (R * 4 + 4) + nb(s["iopt"]) + nb(s["iused"])
        + n * (K * 4 + K * R * 4 + C * K * 4 + 8),
        int(sum(C * (int(no) * (2 * R + 6) + O * 5) for no in n_open)))
    b["classpack_assign_decode_sharded"] = (
        n * (C * K * 4 + C * 4 + Ppad * (2 if K < 2**15 else 4)),
        n * (C * K + Ppad * (int(math.log2(C)) + int(math.log2(K)) + 6)))
    b["classpack_aggregate_sharded"] = (
        n * (K * 4 + 8 + (3 + O) * 4) + O * 4, n * K * 3)
    b["classpack_slab_sharded"] = (n * (Ppad * 2 + Ppad * 4 + K * 4),
                                   n * Ppad * 4)
    L = 3 + O
    b["shard_psum"] = (n * L * 4 + L * 4, n * L)
    return b


def program_plain(torch, kind, s):
    """A row 13-17 program composed of the plain versions of its kernels
    on stacked inputs `s`, its outputs in the program's order."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    pack = kind.endswith("pack")
    m, ok = ck.classpack_precompute_sharded_plain(
        s["req"], s["cap"], s["packed"], s["alloc"], s["price"], s["rank"])
    slot_option, _, n_open, n_unsched, takes = ck.classpack_scan_sharded_plain(
        s["req"], s["cnt"], s["packed"], s["cap"], s["alloc"], s["price"], m,
        ok, s["iopt"], s["iused"], s["K"], not pack)
    if pack:
        flat = ck.shard_psum_plain(ck.classpack_aggregate_sharded_plain(
            slot_option, s["price"], n_open, n_unsched), s["hosts"])
        return flat[0], flat[3:].to(torch.int32), flat[2].to(torch.int32)
    a = ck.classpack_assign_decode_sharded_plain(takes, s["cnt"], s["Ppad"])
    if kind == "partitioned_assign_slab":
        return (*ck.classpack_slab_sharded_plain(a, s["K"]), slot_option,
                n_unsched)
    return a, slot_option, n_unsched


def sharded_kernel_rows(torch, card, caps, cases, by_path, err):
    """Device times of the shard-batched kernels at the megafleet's row-17
    inputs (K4 and K8 at row 15's), beside their back-to-back CUDA-event
    rates, bounds, plain versions, library calls and the same shards as n
    serial single-device launches; then the five programs at their paths'
    inputs, each held against its plain composition."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    from karpenter_tpu_torch.parallel import driver, sharded
    s, s15 = cases["row 17"], cases["row 15"]
    got = sharded_run(s)
    got15 = sharded_run(s15, emit=False)
    bounds = sharded_bounds(s, got)
    b15 = sharded_bounds(s15, got15)
    n = s["cnt"].shape[0]
    src = "karpenter_tpu_torch/csrc/classpack.cu"
    rows = []

    def paths(name):
        return {p: c.get(name, 0) for p, c in by_path.items()}

    def serial(fn):
        return lambda: [fn(i) for i in range(n)]

    cnt_i = [s["cnt"][i].contiguous() for i in range(n)]
    m, ok = got["m"], got["ok"]
    takes, a = got["takes"], got["assignment"]
    keyed = torch.where(a >= 0, a.to(torch.int32), s["K"])
    flat_c = torch.cumsum(takes.reshape(n, -1), 1, dtype=torch.int32)
    q = torch.arange(s["Ppad"], dtype=torch.int32,
                     device=a.device).expand(n, -1).contiguous()
    opt15 = got15["slot_option"].clamp(min=0).long()
    w15 = (got15["slot_option"] >= 0).float()
    O15 = s15["price"].shape[0]
    spec = [
        ("classpack_precompute_sharded", "karpenter_tpu/ops/classpack.py:75",
         s, bounds,
         lambda: ck.classpack_precompute_sharded(
             s["req"], s["cap"], s["packed"], s["alloc"], s["price"],
             s["rank"]),
         lambda: ck.classpack_precompute_sharded_plain(
             s["req"], s["cap"], s["packed"], s["alloc"], s["price"],
             s["rank"]),
         serial(lambda i: ck.classpack_precompute(
             s["req"][i], s["cap"][i], s["packed"][i], s["alloc"],
             s["price"], s["rank"])), None, 20, f"{MEGA_PATH}-slab"),
        ("classpack_scan_sharded", "karpenter_tpu/ops/classpack.py:87", s,
         bounds,
         lambda: ck.classpack_scan_sharded(
             s["req"], s["cnt"], s["packed"], s["cap"], s["alloc"],
             s["price"], m, ok, None, None, s["K"], True),
         lambda: ck.classpack_scan_sharded_plain(
             s["req"], s["cnt"], s["packed"], s["cap"], s["alloc"],
             s["price"], m, ok, None, None, s["K"], True),
         serial(lambda i: ck.classpack_scan(
             s["req"][i], cnt_i[i], s["packed"][i], s["cap"][i], s["alloc"],
             s["price"], m[i], ok[i], None, None, s["K"], True)), None, 5,
         f"{MEGA_PATH}-slab"),
        ("classpack_assign_decode_sharded",
         "karpenter_tpu/ops/classpack.py:228", s, bounds,
         lambda: ck.classpack_assign_decode_sharded(takes, s["cnt"],
                                                    s["Ppad"]),
         lambda: ck.classpack_assign_decode_sharded_plain(takes, s["cnt"],
                                                          s["Ppad"]),
         serial(lambda i: ck.classpack_assign_decode(takes[i], cnt_i[i],
                                                     s["Ppad"])),
         lambda: torch.searchsorted(flat_c, q, right=True), 20,
         f"{MEGA_PATH}-slab"),
        ("classpack_aggregate_sharded", "karpenter_tpu/ops/classpack.py:169",
         s15, b15,
         lambda: ck.classpack_aggregate_sharded(
             got15["slot_option"], s15["price"], got15["n_open"],
             got15["n_unsched"]),
         lambda: ck.classpack_aggregate_sharded_plain(
             got15["slot_option"], s15["price"], got15["n_open"],
             got15["n_unsched"]),
         serial(lambda i: ck.classpack_aggregate(
             got15["slot_option"][i], s15["price"], got15["n_open"][i],
             got15["n_unsched"][i])),
         lambda: torch.zeros((n, O15), device=w15.device).scatter_add_(
             1, opt15, w15), 50, f"{MEGA_PATH}-aggregate"),
        ("classpack_slab_sharded", "karpenter_tpu/ops/classpack.py:280", s,
         bounds,
         lambda: ck.classpack_slab_sharded(a, s["K"]),
         lambda: ck.classpack_slab_sharded_plain(a, s["K"]),
         serial(lambda i: ck.classpack_slab(a[i], s["K"])),
         lambda: (torch.sort(keyed, dim=1, stable=True),
                  torch.zeros((n, s["K"] + 1), dtype=torch.int64,
                              device=a.device).scatter_add_(
                      1, keyed.long(), torch.ones_like(keyed.long()))),
         20, f"{MEGA_PATH}-slab"),
        ("shard_psum", "karpenter_tpu/parallel/sharded.py:145", s15, b15,
         lambda: ck.shard_psum(got15["flat"], 1),
         lambda: ck.shard_psum_plain(got15["flat"], 1), None,
         lambda: torch.sum(got15["flat"], dim=0), 50,
         f"{MEGA_PATH}-aggregate"),
    ]
    for (name, replaces, sc, bnd, fn, plain, ser, lib, iters,
         path) in spec:
        ms = card_ms(torch, fn, iters)
        host_ms = event_ms(torch, fn, iters)
        plain_ms = event_ms(torch, plain, 1)
        ser_ms = card_ms(torch, ser, iters) if ser else None
        lib_ms = card_ms(torch, lib, iters) if lib else None
        nbytes, nops = bnd[name]
        t_b, t_o = nbytes / MEM_BW * 1e3, nops / F32_PEAK * 1e3
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=by_path[path][name], path=path,
            launches_by_path=paths(name), max_abs_err=err[name], ms=ms,
            host_ms=host_ms, plain_ms=plain_ms, bound_ms=max(t_b, t_o),
            bound_by="bytes" if t_b >= t_o else "operations",
            library_ms=lib_ms, serial_ms=ser_ms, floor_ms=FLOOR_MS))
        if name == "classpack_scan_sharded":
            # the restated bound: the shards' class steps, each at least
            # the card's least step (`scan_bound`)
            R, O = sc["req"].shape[2], sc["price"].shape[0]
            ta = takes.cpu().numpy()
            ca = sc["cnt"].cpu().numpy()
            counts = [scan_counts(ca[i], ta[i], 0, sc["K"]) for i in range(n)]
            b, by, term, terms = scan_bound(nbytes, counts, R, O,
                                            least_step())
            rows[-1].update(bound_ms=b, bound_by=by, bound_term=term,
                            bound_terms=terms, steps=counts)
            scan_step_line(card, "megafleet row 17 (K2s)", R, O, sc["K"], n,
                           ms, counts)
            log(f"[kernel] classpack_scan_sharded bound restated: {b:.5f} ms "
                f"by {term} (terms {terms}; {ms / b:.2f}x) on {card}")
        log(f"[kernel] {name}: {ms:.4f} ms on the card for n={n} shards "
            f"(back-to-back host rate {host_ms:.4f} ms; "
            f"{'' if ser_ms is None else f'{n} serial single-device launches {ser_ms:.4f} ms, '}"
            f"plain {plain_ms:.3f} ms, library "
            f"{'None' if lib_ms is None else f'{lib_ms:.4f}'} ms, bound "
            f"{max(t_b, t_o) * 1e3:.3f} us by "
            f"{'bytes' if t_b >= t_o else 'operations'}: "
            f"{ms / max(t_b, t_o):.2f}x the bound, {ms / FLOOR_MS:.2f}x the "
            f"empty launch) at Cpad="
            f"{sc['req'].shape[1]} Opad={sc['price'].shape[0]} K={sc['K']} "
            f"Ppad={sc['Ppad']} on {card}")
    # the five programs (rows 13-17), whole, at their paths' inputs
    progs = [
        ("_sharded_pack", "karpenter_tpu/parallel/sharded.py:117",
         sharded._sharded_pack, cases["row 13"], f"{HEAD_SHARDED_PATH}"
         "-pods-aggregate", "classpack_aggregate_sharded"),
        ("_sharded_assign", "karpenter_tpu/parallel/sharded.py:158",
         sharded._sharded_assign, cases["row 14"],
         f"{HEAD_SHARDED_PATH}-pods-decode",
         "classpack_assign_decode_sharded"),
        ("_partitioned_pack", "karpenter_tpu/parallel/driver.py:68",
         driver._partitioned_pack, cases["row 15"],
         f"{MEGA_PATH}-aggregate", "classpack_aggregate_sharded"),
        ("_partitioned_assign", "karpenter_tpu/parallel/driver.py:100",
         driver._partitioned_assign, cases["row 16"],
         f"{MEGA_PATH}-decode", "classpack_assign_decode_sharded"),
        ("_partitioned_assign_slab", "karpenter_tpu/parallel/driver.py:137",
         driver._partitioned_assign_slab, cases["row 17"],
         f"{MEGA_PATH}-slab", "classpack_slab_sharded"),
    ]
    rows_of = dict(_sharded_pack="row 13", _sharded_assign="row 14",
                   _partitioned_pack="row 15", _partitioned_assign="row 16",
                   _partitioned_assign_slab="row 17")
    for name, replaces, fn, sc, path, marker in progs:
        kind, args = caps[rows_of[name]]
        ms = event_ms(torch, lambda: fn(*args), 5)
        out = fn(*args)
        plain_ms, want = once_ms(torch, lambda: program_plain(torch, kind,
                                                              sc))
        # integers equal; the float32 cost (K4's tree sum, then K8) within
        # REL_TOL of the plain composition's
        diff = 0.0
        for g, w in zip(out, want):
            d = float((g.double() - w.double()).abs().max())
            if g.dtype.is_floating_point:
                check(d <= REL_TOL * max(abs(float(w)), 1e-30),
                      f"{name}: cost {float(g)!r} vs plain {float(w)!r}")
            else:
                check(g.dtype == w.dtype and torch.equal(g, w),
                      f"{name}: an output differs from the plain programs")
            diff = max(diff, d)
        nbytes = sum(t.numel() * t.element_size() for t in args
                     if isinstance(t, torch.Tensor)
                     and not (t.dim() and t.stride(0) == 0))
        nbytes += sum(t.numel() * t.element_size() for t in out)
        # the program's own bytes, or its K2s's operations or class-to-class
        # dependency at this input, whichever is larger
        counts = shard_scan_counts(sc)
        bound, by, term, terms = scan_bound(
            nbytes, counts, sc["req"].shape[2], sc["price"].shape[0],
            least_step())
        rows.append(dict(
            name=name, route="cuda",
            source=("karpenter_tpu_torch/parallel/sharded.py"
                    if "sharded" in replaces else
                    "karpenter_tpu_torch/parallel/driver.py"),
            replaces=replaces, launches=by_path[path][marker], path=path,
            launches_by_path=paths(marker), max_abs_err=diff, ms=ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=by, bound_term=term,
            bound_terms=terms, steps=counts, library_ms=None))
        log(f"[kernel] {name} ({rows_of[name]}, {path}): {ms:.4f} ms (CUDA "
            f"events; plain {plain_ms:.3f} ms, bound {bound * 1e3:.3f} us by "
            f"{term}, terms {terms}; {ms / bound:.2f}x), max abs err "
            f"{diff!r} against the plain programs on {card}")
    cell_args = caps[f"{CELL_PATH} round 2"][1]
    ms = event_ms(torch, lambda: driver._partitioned_assign_slab(*cell_args),
                  5)
    log(f"[kernel] _partitioned_assign_slab at {CELL_PATH} round 2 "
        f"(Cpad={cell_args[0].shape[1]}, Opad={cell_args[4].shape[0]}, "
        f"K={cell_args[9]}, Ppad={cell_args[10]}): {ms:.4f} ms on {card}")
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
    k1_inputs = compare_precompute_shapes(torch)
    compare_scan_edges(torch, problem)
    compare_assign_decode(torch)
    firsts = compare_sweeps(torch, err)
    log(f"[kernels] all kernels equal to their plain versions "
        f"({time.perf_counter() - t_start:.1f} s so far)")
    launches, prob = main_path(torch, pods, catalog, pools, problem, ex)
    timings(torch, card, pods, catalog, pools, prob, ex)
    by_path = {HEADLINE_PATH: launches, **consolidation_path(torch, card)}
    masters = compare_pdhg(torch, problem, err)
    log(f"[pdhg] phase 7 done ({time.perf_counter() - t_start:.1f} s so far)")
    by_path.update(guided_path(torch, problem))
    pdhg_ms = guided_timings(torch, card, problem, masters)
    compare_slab(torch, err)
    compare_ffd(torch, err)
    log(f"[kernels] phase 9 done ({time.perf_counter() - t_start:.1f} s so far)")
    prov_paths, slabs, programs, scans = provision_cells(torch, card)
    by_path.update(prov_paths)
    compare_recorded_k3(torch)
    log(f"[provision] phase 10 cells done "
        f"({time.perf_counter() - t_start:.1f} s so far)")
    log(f"[main] launches of each main path's run: {by_path}")
    k5_ms = sweep_call_times(torch, card, firsts)
    rows = kernel_table(torch, card, shapes, by_path, err, k1_inputs)
    frontier = "delete face, first frontier"
    rows.append(sweep_row(torch, card, firsts[frontier], k5_ms[frontier],
                          by_path, err))
    rows.append(pdhg_row(torch, card, masters, pdhg_ms, by_path, err))
    rows.extend(provision_kernel_rows(torch, card, by_path, slabs,
                                      programs, scans, err))
    # phases 11-12: the sharded paths (phase 12's counted runs first: they
    # record the programs' arguments that phase 11 holds the kernels on)
    from karpenter_tpu_torch import workloads
    mega = workloads.megafleet_problem(workloads.MEGAFLEET_UNITS)
    shard_paths, caps = sharded_paths(torch, card, mega, prob, ex, catalog)
    by_path.update(shard_paths)
    log(f"[sharded] phase 12 paths done "
        f"({time.perf_counter() - t_start:.1f} s so far)")
    cases = phase11(torch, caps, prob, ex, err)
    log(f"[sharded] phase 11 done ({time.perf_counter() - t_start:.1f} s "
        f"so far)")
    sharded_solve_timings(torch, card, mega, prob, ex)
    rows.extend(sharded_kernel_rows(torch, card, caps, cases, shard_paths,
                                    err))
    log(f"[sharded] phase 12 done ({time.perf_counter() - t_start:.1f} s "
        f"so far); launches {shard_paths}")
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
