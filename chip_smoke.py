#!/usr/bin/env python3
"""Smoke run of karpenter_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; the last line is printed only when all
pass):

  1. probe   — the card's name and power limit (nvidia-smi), torch, CUDA
               and nvcc versions;
  2. build   — compile csrc/*.cu with nvcc for sm_90a at first use and
               print the ptxas register / shared-memory lines; compile the
               native C++ packer (native/csrc/ffd.cc) with g++ — no
               compiler there fails the run;
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
               Then K7 against its plain version on every provision-small batch
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
               11) warm p50s of each mode, the
               device time of each shard-batched kernel beside n serial
               single-device launches of the same shards, the five
               programs (rows 13-17) held against their plain compositions
               and timed, and the device idle share (the slab solve's
               trace read as phase 10's, with K6s's split by launch at
               row 17's input).
 13. disruption — the cell `disruption-replay-500` (BASELINE config 4:
               2590 pods provisioned onto 504 nodes, scaled down to 28%)
               carried out through DisruptionController.reconcile with a
               TerminationController: consolidation and emptiness ticks,
               drift (the middle tick ICE'd: its replacement launch must
               fail and roll the fleet back), expiration, 8 spot
               interruptions drained by the InterruptionController and
               re-provisioned, a leaked instance collected by GC.  Run
               after phase 10 (so the kernel rows carry its launches),
               three times on fleets built anew: counted (the launch
               counts set to 0 just before the replay and read just
               after, each tick's read around it; every tick must
               reproduce GOLDEN_DISRUPTION, the JAX package's, and K1, K5,
               K2 and K3 must have launched; each kernel wrapper's inputs
               of its last call in each tick are kept and, after the
               counts are read, the wrapper is held against its plain
               version on them: K1 and K5 of the consolidation ticks'
               sweeps and accepts, K1, K2 and K3 of the drift and
               expiration replacement solves and of the re-provision),
               timed (`[time]` p50 of a consolidation tick with a decision
               and of an executed drift tick, split into candidates,
               decision and execute = launch + rebind + drain, the
               rolled-back drift tick on its own line; every kernel
               wrapper's call spanned by CUDA events, whose sum over the
               ticks' wall gives the idle share) and traced (each
               reconcile under the profiler, a second witness that sees
               the torch operations and not the ctypes launches); both
               must reproduce the golden too.
 14. the arena and the operator — run after every profiler trace,
               with every kernel wrapper's call spanned by CUDA events and
               the inputs of its last call on each path kept: (a) the
               provisioning cells of more than one round (live, small) with
               the cluster's ClusterArena attached before round 1, and the
               live cell once more behind an IngestBatcher flushed before
               each provision(), every round
               against GOLDEN_PROVISION, each round on a live cluster
               gathered warm from the arena; (b) disruption-replay-500 with
               the arena against GOLDEN_DISRUPTION, its consolidation faces
               gathered warm; (c) the operator cell at a tenth of its
               depth (`workloads.OPERATOR_SMALL_ROUNDS`) —
               Operator(Options()) on the card at full width with
               build_controllers, the live cell's two bursts cut to 5000
               and 2000 pods and one disruption tick — against
               GOLDEN_OPERATOR_SMALL, its Options carrying the WarmRestart
               gate and a snapshot written after round 1 (phase 18
               restores it); (d) every wrapper held against its plain
               version on the kept inputs.  Each step's launches (zeroed
               just before it) and idle share are printed, "tensorize"
               split into lower_pods, tensorize and the live-node gather;
               the paths' launches join the kernel rows.  (Cut in depth
               when phase 17 came: no replay of the disruption cell without
               the arena, which phase 13 runs; and when phase 20 came, the
               operator cell to a tenth of its pods: at full depth its 2048
               launches each waited out the CreateFleet batcher's 35 ms idle
               window, 74 s of round 1 and 33 s of round 2.  Live round 2's
               provision() timed on fresh copies without the arena, with it
               and behind an IngestBatcher went then too, and the arena
               replays of provision-noguide-50k and provision-ffd-50k, whose
               one round starts from an empty cluster: their gathers found
               no node to serve, and phase 10 runs both.)
 15. the operator loop — after phase 14, with its kernel spans and
               recorded inputs: (a) SimHarness on the card replays the
               canned scenarios whose goldens carry no gated section
               (diurnal, spot-reclaim-storm, ice-starvation,
               steady-state-drip, long-soak, at tests/test_sim.py's
               horizons), each report byte for byte against
               tests/golden/ (read, never written), then drip and soak
               with the arena off, drip with IngestBatch and diurnal with
               DeviceDecode against the same goldens; (b) the cell
               sim-long-soak-480 with the arena on, then off, each
               against GOLDEN_SIM_SOAK, and steady-state-drip at 480 s
               likewise, its reports equal, with wall time, speedup,
               ticks, gathers, launches and idle share; (c) the /v1 cell: the
               operator from the command line at full width, restarted
               over a launched fleet, its endpoints served and its loop
               in a thread — /readyz 200 with the parity probe "ok",
               /v1/apply, /v1/nodepools, /v1/solve of the headline's
               50 000 Pod manifests against GOLDEN_V1_SOLVE, timed once
               with the split decode / solve / response — and
               `python3 -m karpenter_tpu_torch` as a child process
               (/readyz, a small /v1/solve, exit 0 on SIGTERM); (d) every
               kernel wrapper those paths launched against its plain
               version on the inputs of its last call on each path.
 16. robustness — after phase 15: (a) the native C++ packer
               (`native.ffd_pack_native`, host code) against K7 on the
               card and K7's plain version, on every K7 input of at most
               256 rows that phase 15 recorded, provision-small-3x64's
               three batches and tests/test_native.py's edge cases:
               assignment, slot options and slot usage bit-equal across
               the three, the native call's host ms beside K7's card ms
               and host-rate ms; (b) SimHarness replays
               scenarios/chaos-storm.yaml (seed 0, 5400 s) with the arena
               on, then off, each report byte for byte against
               tests/golden/sim-chaos-storm.json, every wrapper held
               against plain on its last call's inputs, then once with
               the chaos block off for K7's unarmed count; (c) a
               `solver.pack` hang of 2 s on the "jax" rung under a 0.5 s
               solve deadline on provision-small-3x64: the watchdog books
               `jax>native:timeout`, every round equals GOLDEN_PROVISION,
               and the abandoned worker is waited out; (d) with chaos
               armed and one SolverHealth shared by both controllers of
               the disruption cell under a ControllerManager, K5 raising
               KernelError once in a consolidation sweep and K1 once in a
               provisioning solve: each `tick()` raises it, and neither
               the ladder nor a supervisor books anything.
 17. forecast-driven headroom and gang scheduling — after phase 16, with
               its kernel spans and recorded inputs: (a) SimHarness on the
               card replays diurnal-forecast, spot-reclaim-storm-forecast,
               gang-churn-storm and mixed-priority-diurnal (arena on, at
               tests/test_sim.py's horizons), each report byte for byte
               against tests/golden/; (b) the gang cell at a tenth of its
               depth (`workloads.GANG_SMALL_SCALE`, full width) —
               Provisioner(gang_scheduling=True, 8192 slots) on 5000 of
               the headline's pods with 102 gangs of 4 (tier 1, zone), 6
               short ones, 4 split over two zones and 4 at tier 0 with a
               member no type holds, then 2000 more with 25 gangs of 8
               (tier 2, hostname), then one DisruptionController reconcile
               executing the first preemption plan — against
               GOLDEN_GANG_SMALL, each round counted, spanned and timed
               with the gang audit's host ms beside the rest of the solve
               (the full 50 000-pod cell spent 60 s of host time in one
               round-2 audit; tests/test_torch_gang_golden.py holds the
               JAX package to both goldens); (c) every wrapper held
               against its plain version on the kept inputs; (d) a
               KernelError armed in the HeadroomController's dry-run solve
               of a Forecast operator and in the re-solve after a gang
               preemption: each tick() raises it out of that solve (the
               other controllers held back), and the cluster, the
               controller's books, the ladder and the supervisors stay as
               they were (tests/test_torch_fault_ticks.py runs both on
               the CPU).
 18. durability and HA — after phase 17: (a) SimHarness replays
               scenarios/failover-drill.yaml (HAFailover with a
               virtual-clock LeaderElector, a lease blackout and a flaky
               window; seed 0, 5400 s) with the arena on, then off, each
               report byte for byte against
               tests/golden/sim-failover-drill.json, with its wall, ticks,
               launches of K1, K2, K3, K5, K7 and idle share, every
               wrapper held against plain on its recorded inputs; (b) the
               warm restart at full width (the operator cell's tenth):
               phase 14(c)'s snapshot (its
               bytes and host write ms, its sections host data only) is
               restored by a fresh `python3 -c` process (`successor`)
               that loads the kernels built in build/, runs round 2 and
               the tick against GOLDEN_OPERATOR_SMALL with 0 cold gathers, its
               provision() ms printed beside phase 14's, and holds its
               recorded K1, K2, K3 inputs against plain; (c) a deposed
               elector's snapshot write, launch and terminate refused
               (StaleFenceError for the last two), nothing written,
               launched or deleted, `refusals` counting each; (d) a
               KernelError in a restored successor's first solve leaves
               tick() through `Provisioner.solve` with no snapshot written
               (tests/test_torch_fault_ticks.py runs (c) and (d) on the
               CPU).
 19. metrics and tracing — after phase 18: (a) the tracer's cost: the
               warm guided headline (against GOLDEN_GUIDED, after a cold
               golden run) and, inside phase 10 where its state is, the
               live cell's round-2 `Provisioner.solve` (every run the
               first run's plan; the round's golden provision() follows)
               run with `TRACER.enabled` on and off in turns (21 and 2
               pairs; 5 on the live cell before phase 21 came), their
               p50s and the overhead printed
               (`[trace-cost]`);
               (b) one provisioning round (5000 headline pods, 600 types,
               the default Provisioner) and one consolidation tick over
               the fleet it launched, thinned to one pod a node, each with
               the launch
               counts zeroed just before it and its kernels' launches and
               CUDA-event times keyed by the span open at each call: each
               `solve.kernel` and sweep span lasts at least its kernels'
               card time, a `solve.kernel` is one K1, one K2 and one K3 (and
               K6 with the slab decode), a sweep span's `device_calls` its
               K1 and K5 launches, a ffd `solve.pack`'s its K7 launches;
               the host ms of each span printed; (c) a small operator
               served by `serve_endpoints`, on the CPU and on the card:
               `/metrics` lists the same families on both,
               `/debug/traces?span=provision` returns the round's tree,
               `/debug/pprof` answers 403, then 200 with
               `enable_profiling`; (d) host ms by span summed over whole
               runs (the tracer's duration histogram, registries reset
               first): the long-soak replay at tests/test_sim.py's
               horizon against tests/golden/ (the loop; the 480 s cell
               before phase 21 came) and the megafleet's three
               `solve_partitioned` modes (the sharded path).
 20. incidents, the flight recorder, the SLO engine and the cost ledger
               — after phase 19, with its kernel spans and recorded inputs:
               (a) SimHarness on the card replays chaos-storm and
               failover-drill (5400 s) ungated against tests/golden/, then
               with the FlightRecorder gate against GOLDEN_INCIDENTS, and
               spot-reclaim-storm (7200 s) ungated, then with the SLOEngine
               gate and with both against GOLDEN_SLO (`tick_duration`'s
               wall-clock fields by outcome), the metric registry reset
               before each run; every gated report stripped of its gated
               sections equals the ungated golden; each run's wall, ticks,
               launches of K1, K2, K3, K5, K7 and idle share, and the gated
               wall over the ungated; every wrapper held against plain on
               its recorded inputs; (b) the host time of
               `FlightRecorder.sample`, `SLOEngine.tick` and
               `IncidentBus.publish` per call over those replays
               (`[obs-cost]`); (c) a small operator's snapshot
               with both gates off and on (bytes, and each new section's),
               restored by a successor with the sections as written; (d) a
               KernelError in a provisioning solve under both gates leaves
               tick() with nothing booked and no incident; (e)
               `tools.trace_demo` on the card prints its incident index
               ((c)-(e) run on the CPU in tests/test_torch_obs.py).
 21. the certified cost bounds (ops/lpbound.py, ops/ggbound.py) — after
               phase 20: (b) first, tools/certify.py's default instance
               (10 000 pods x 200 types, `workloads.certify_problem`):
               its class_lp_bound (HiGHS) solved on a thread started
               before the build, against GOLDEN_CERTIFY; solve_classpack
               on the card; gg_bound(device=True) for
               `workloads.CERTIFY_GG_ITERS` round(s) with the class LP
               patched out (its screen one pdhg launch over every
               candidate option, the streaming kernel), its own value
               and column count against GOLDEN_CERTIFY's (the JAX
               package's, on its HiGHS screen), class LP <= gg <= plan
               cost, gg = max(class LP, own) against the golden; (a) the
               pricing sweep of bench.run_lp_ab (40 types, C = 100, 250
               and 500 from one default_rng(42)) under the class LP's
               duals: the serial HiGHS screen over the jobs (no other
               thread running), then one `ggbound._device_screen` batch
               on the card (one pdhg launch, counted), every certified
               bound at least its HiGHS optimum; (c)
               lpbound.device_dual_bound at lp-100 (one pdhg launch,
               counted) against the same function on pdhg_plain.  Each
               screen's batch and (c)'s solve are held against
               pdhg_plain; each screen's kernel is timed beside its
               bound (`pdhg_bound`'s terms summed over the members'
               natural dims and iterations; the padded envelope's bytes
               are printed beside it, bounding nothing); the records join
               the pdhg row (`screen`, `sweeps`).

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
import os
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
    from karpenter_tpu_torch import _build, native
    t0 = time.perf_counter()
    lib = native.build()          # raises NativeBuildError: no quiet fall
    check(native.available(), f"the native packer {lib} does not load")
    log(f"[build] native packer {lib.name} ({native.CXX} "
        f"{' '.join(native.CXX_FLAGS)}) in {time.perf_counter() - t0:.3f} s")
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


def untraced(torch, card, what, counter, fn, iters):
    """The witness of a kernel whose launches a profiler trace did not
    name (torch.profiler drops some ctypes launches; ROADMAP.md, "To
    watch"): `counter`'s launches over `iters` more calls of `fn`, and the
    CUDA-event ms of a call.  Fails unless it launched every call."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    before = ck.LAUNCHES[counter]
    ms = event_ms(torch, fn, iters)
    calls = ck.LAUNCHES[counter] - before
    check(calls >= iters + 1, f"{what}: {counter} launched {calls} times "
                              f"in {iters + 1} calls")
    log(f"[trace] {what}: the trace named no {counter} kernel; CUDA events "
        f"witness it instead: {calls} launches in {iters + 1} calls, "
        f"{ms:.4f} ms a call on {card}")


def trace_kernel(torch, card, what, fn, counter, new, old, iters=3):
    """`device_busy` of `fn` with the launch counter `counter` read around
    the same calls: it must have launched at least once a call, and the
    trace must name the kernel of this design (`new`) and none of the
    earlier design's (`old`); a trace that names none of `counter`'s
    launches is answered by `untraced`."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    before = ck.LAUNCHES[counter]
    busy = device_busy(torch, fn, iters)
    calls = ck.LAUNCHES[counter] - before
    hit = [k for k in busy["names"] if new in k]
    stale = [k for k in busy["names"] if any(o in k for o in old)]
    check(calls >= iters + 1 and not stale,
          f"{what}: {counter} launched {calls} times in {iters + 1} calls; "
          f"the trace names {hit} of this design and {stale} of the earlier")
    if not hit:
        untraced(torch, card, what, counter, fn, iters)
        return busy
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
            iters=1)
        out["arena build, replace face"] = p50_ms(
            lambda: SimulationArena(cands, ctrl.cluster,
                                    ctrl.provider.get_instance_types(),
                                    list(ctrl.nodepools.values()),
                                    device=ctrl.device).replace_side,
            iters=1)
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
                      path="resident", summary=False):
    """The kernel against `pdhg_plain` on one captured or built batch, on
    the kernel `path` names (checked by its launch counter), and a second
    launch against the first, bit for bit; returns a list of failure
    strings (empty when it agrees).  The plain call's CUDA-event time is
    kept in `case["plain_ms"]` (the kernel row's plain time).  A line per
    member, or with `summary` one line for the batch (kept in
    `case["summary"]`)."""
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
    case["plain_ms"], want = once_ms(torch, lambda: lk.pdhg_plain(*args))
    want = [w.cpu().numpy() for w in want]
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
        if not summary:
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
    if summary:
        dxs = np.abs(got[0] - want[0]).max(axis=1)
        case["summary"] = (
            f"against plain: {B} members, {int(got[3].sum())} converged "
            f"(plain {int(want[3].sum())}); iterations {got[4].min()}-"
            f"{got[4].max()} (plain {want[4].min()}-{want[4].max()}); max "
            f"|dx| {dxs.max():.3g}; two launches bit-equal")
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
    generation (exact_lp_mix, HiGHS masters, in one cold solve; three
    before phase 21 came), and in warm solves the remainder solve (K1-K3 +
    decode), the flexible alternatives, and the rest (mix lookup, stripe,
    tuck, merge).  Each layer is timed by wrapping the function the guide
    calls; p50 over `iters` warm solves."""
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
        for cold in (True,) + (False,) * iters:
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
    out["guided headline, cold (mix caches cleared)"] = p50_ms(cold, 1, sync)
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
    headline's master (20 000 iterations, the cap); its plain time is the
    one phase 7 took holding the kernel against it (one call, some ten
    seconds)."""
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    case = masters["headline"]
    it = int(case["iters"][0])
    args = (*case["ops"], case["eps"], case["iters_cap"],
            case["check_every"])
    plain_ms = case["plain_ms"]
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


class layer_timer:
    """While open, time one Provisioner's layers, summed over calls, ms:
    `solve`, `pack` (`_pack_supervised`, the solve on the card with its
    decode, synchronized), and inside the solve the three parts of
    "tensorize": constraint lowering (`lower_pods`), `tensorize`, and the
    live-node gather (`Cluster.tensorize_nodes` or the arena's `gather`,
    whichever served it)."""

    PARTS = ("solve", "pack", "lower", "tensorize", "gather")

    def __init__(self, torch, prov):
        self.torch, self.prov = torch, prov
        self.acc = {k: 0.0 for k in self.PARTS}

    def _timed(self, key, fn, sync=False):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if sync:
                    self.torch.cuda.synchronize()
                self.acc[key] += (time.perf_counter() - t0) * 1e3
        return run

    def __enter__(self):
        from karpenter_tpu_torch.controllers import provisioning as pm
        prov, cluster = self.prov, self.prov.cluster
        self.module = (pm, pm.lower_pods, pm.tensorize)
        pm.lower_pods = self._timed("lower", pm.lower_pods)
        pm.tensorize = self._timed("tensorize", pm.tensorize)
        self.objects = [(prov, "solve"), (prov, "_pack_supervised"),
                        (cluster, "tensorize_nodes")]
        prov.solve = self._timed("solve", prov.solve)
        prov._pack_supervised = self._timed("pack", prov._pack_supervised,
                                            sync=True)
        cluster.tensorize_nodes = self._timed("gather",
                                              cluster.tensorize_nodes)
        if cluster.arena is not None:
            self.objects.append((cluster.arena, "gather"))
            cluster.arena.gather = self._timed("gather", cluster.arena.gather)
        return self.acc

    def __exit__(self, *exc):
        pm, lower, tens = self.module
        pm.lower_pods, pm.tensorize = lower, tens
        for obj, name in self.objects:
            del obj.__dict__[name]


def layer_line(acc, total):
    """The split of one provision(): tensorize (solve less pack) as
    lowering + tensorize + gather + the rest of the solve's host work, pack,
    and launch (the round less the solve: claims, the fake cloud,
    registration, binds)."""
    rest = acc.get("other", acc["solve"] - acc["pack"] - acc["lower"] -
                   acc["tensorize"] - acc["gather"])
    return (f"tensorize {acc['solve'] - acc['pack']:.3f} (lower_pods "
            f"{acc['lower']:.3f}, tensorize {acc['tensorize']:.3f}, gather "
            f"{acc['gather']:.3f}, other {rest:.3f}), pack {acc['pack']:.3f}, "
            f"launch {total - acc['solve']:.3f}")






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
                live_r2_tracing_cost(torch, card, env)
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


def live_r2_tracing_cost(torch, card, env):
    """Phase 19(a) on the live cell's frozen round-2 state (run here, in
    phase 10, where that state is): `Provisioner.solve` with the tracer on
    and off in turns, every run's plan the first run's (and the round's
    provision() right after must give GOLDEN_PROVISION)."""
    from karpenter_tpu_torch import workloads
    batch = env.cluster.pending_pods()
    prov = env.provisioner
    problem, packing = prov.solve(batch)
    want = workloads.plan_digest(problem, packing)[0]

    def same_plan(out):
        check(workloads.plan_digest(*out)[0] == want,
              f"{LIVE_PATH} round 2: a timed solve changed the plan")
    tracing_cost(torch, card, f"{LIVE_PATH} round 2 Provisioner.solve",
                 lambda: prov.solve(batch), same_plan)




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
    wrapper launched (each launch's error is checked there); a trace that
    names none of them is answered by `untraced`."""
    from karpenter_tpu_torch.ops import classpack_kernels as ck
    keys = ("classpack_slab", "classpack_slab_sharded")
    before = {k: ck.LAUNCHES[k] for k in keys}
    busy = device_busy(torch, fn, iters)
    moved = {k: ck.LAUNCHES[k] - before[k] for k in keys}
    calls = sum(moved.values())
    slab = {k: v for k, v in busy["per_kernel"].items() if "slab_" in k}
    split = {}
    for n in SLAB_KERNELS:
        ks = [k for k in slab if n in k]
        if ks:
            count = sum(busy["events"][k] for k in ks)
            split[n] = (sum(slab[k] for k in ks) * iters / count, count)
    check(calls == iters + 1
          and not any("slab_rank_kernel" in k for k in slab),
          f"{what}: {calls} K6 launches in {iters + 1} calls; the trace "
          f"names {sorted(slab)}")
    if not split:
        untraced(torch, card, what, max(moved, key=moved.get), fn, iters)
        return busy
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
    check(k2s == 3 and not stale,
          f"{MEGA_PATH} slab solve: K2s launched {k2s} times in 3 calls; "
          f"the trace names {hit} of this design and {stale} of the earlier")
    if not hit:
        untraced(torch, card, f"{MEGA_PATH} slab solve",
                 "classpack_scan_sharded", lambda: solve_partitioned(
                     mega, mesh=mesh, max_nodes_per_shard=workloads.MEGAFLEET_K,
                     device_decode=True), 2)
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


# ---------------------------------------------------------------------------
# phase 13: the disruption cell, carried out
# ---------------------------------------------------------------------------

DISRUPTION_PATH = "disruption-replay-500"
DISRUPTION_KERNELS = ("classpack_precompute", "classpack_sweep",
                      "classpack_scan", "classpack_assign_decode")


def fresh_disruption_env():
    """The cell's fleet built anew on the card, the guide caches cleared
    first (a warm guide cache may change the guided build's plan)."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.catalog.generate import generate_catalog
    clear_lp_caches()
    return workloads.disruption_env(
        workloads.port_kit(), generate_catalog(workloads.DISRUPTION_TYPES))


def check_disruption_golden(sigs, what):
    from karpenter_tpu_torch import workloads
    got = workloads.disruption_digests(sigs)
    gold = workloads.GOLDEN_DISRUPTION
    check(len(got) == len(gold),
          f"{what}: {len(got)} ticks, GOLDEN_DISRUPTION has {len(gold)}")
    for i, (g, w) in enumerate(zip(got, gold)):
        check(g == w, f"{what}: tick {i} {g} != golden {w}; signature "
              f"{json.dumps(sigs[i])[:2000]}")
    drift = [x for x in sigs if x["phase"] == "drift"]
    check(drift[1]["error"] and drift[1]["kept"] and not drift[1]["launched"],
          f"{what}: the ICE'd drift tick did not roll back: {drift[1]}")


# the kernel wrappers the disruption path calls: (the module that looks the
# wrapper up at its call, the module of the wrapper and its plain version,
# the wrapper's name)
DISRUPTION_WRAPPERS = tuple(
    ("karpenter_tpu_torch.ops.classpack",
     "karpenter_tpu_torch.ops.classpack_kernels", name)
    for name in ("classpack_precompute", "classpack_sweep", "classpack_scan",
                 "classpack_assign_decode", "classpack_aggregate",
                 "classpack_slab")) + (
    ("karpenter_tpu_torch.ops.ffd_kernels",
     "karpenter_tpu_torch.ops.ffd_kernels", "ffd_scan"),)


class wrapped_kernels:
    """While the context is open, every call of a DISRUPTION_WRAPPERS
    wrapper goes through `hook(name, args, kwargs, call)`, where `call()`
    runs the wrapper unchanged and returns its result."""

    def __init__(self, hook):
        self.hook, self.saved = hook, []

    def __enter__(self):
        import importlib
        for site, _, name in DISRUPTION_WRAPPERS:
            mod = importlib.import_module(site)
            orig = getattr(mod, name)
            self.saved.append((mod, name, orig))

            def wrapped(*a, _name=name, _orig=orig, **k):
                return self.hook(_name, a, k, lambda: _orig(*a, **k))
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)


def same_as_plain(torch, name, got, want, what, err):
    """A kernel's outputs against its plain version's: every integer
    output equal; K5's cost column (float32) and K4's total_cost within
    relative REL_TOL, as phases 3 and 5 hold them."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    check(len(got) == len(want), f"{what}: {len(got)} outputs, plain "
                                 f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None or w is None:
            check(g is None and w is None, f"{what}: output {i} is None on "
                                           f"one side only")
            continue
        cost = None
        if name == "classpack_sweep":
            cost, g, w = (g[:, 0].double(), w[:, 0].double()), g[:, 1:], \
                w[:, 1:]
        elif name == "classpack_aggregate":
            cost, g, w = (g[:1].double(), w[:1].double()), g[1:], w[1:]
        # K2's scalars come back in another integer type (phase 3 alike)
        check((g.dtype == w.dtype or name == "classpack_scan")
              and g.shape == w.shape and torch.equal(g.to(w.dtype), w),
              f"{what}: output {i} differs from plain")
        if cost is not None:
            gc, wc = cost
            d = float((gc - wc).abs().max()) if gc.numel() else 0.0
            check(bool(torch.isfinite(gc).all()) and bool(
                ((gc - wc).abs() <= REL_TOL * wc.abs()).all()),
                f"{what}: cost differs from plain by {d}")
            err[name] = max(err[name], d)


class kernel_log:
    """A `wrapped_kernels` hook.  Under the current `label` (None: nothing
    kept) it keeps in `recorded` the inputs of each wrapper's last call,
    cloned, per set of keyword arguments; with `spans` it also puts a pair
    of CUDA events around every call (`take_busy`).  A span runs from the
    wrapper's entry to its kernel's end, so it holds the wrapper's host
    work ahead of the launch as well; the clones fall outside it."""

    def __init__(self, torch, label=None, spans=False):
        self.torch, self.label, self.with_spans = torch, label, spans
        self.recorded, self.spans = {}, []

    def __call__(self, name, a, k, call):
        torch = self.torch
        if self.label is not None:
            clone = lambda x: x.clone() if torch.is_tensor(x) else x  # noqa: E731
            variant = ", ".join(f"{kk}={v!r}" for kk, v in sorted(k.items()))
            self.recorded[(self.label, name, variant)] = (
                tuple(map(clone, a)), {kk: clone(v) for kk, v in k.items()})
        if not self.with_spans:
            return call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            return call()
        finally:
            end.record()
            self.spans.append((start, end))

    def take_busy(self):
        """(the spans' summed time since the last take, ms, their count);
        synchronizes."""
        self.torch.cuda.synchronize()
        out = (sum(s.elapsed_time(e) for s, e in self.spans), len(self.spans))
        self.spans.clear()
        return out


def hold_recorded(torch, recorded, err, where):
    """Each kernel wrapper against its plain version on the card, on every
    recorded input: `recorded` maps (label, wrapper, keyword arguments) to
    the (args, kwargs) of the wrapper's last call under that label.
    Returns {wrapper: [labels with the input's first shape]}; fails on the
    first difference."""
    import importlib
    plain = {name: getattr(importlib.import_module(mod), name + "_plain")
             for _, mod, name in DISRUPTION_WRAPPERS}
    kernels = {name: getattr(importlib.import_module(mod), name)
               for _, mod, name in DISRUPTION_WRAPPERS}
    seen = {}
    for (label, name, variant), (args, kw) in recorded.items():
        got = kernels[name](*args, **kw)
        want = plain[name](*args, **kw)
        torch.cuda.synchronize()
        same_as_plain(torch, name, got, want, f"{name} on the input of "
                      f"{where(label)}", err)
        shape = "x".join(map(str, args[0].shape))
        seen.setdefault(name, []).append(
            f"{label} ({shape}{', ' + variant if variant else ''})")
    return seen


def compare_recorded_disruption(torch, recorded, err):
    """Each kernel wrapper against its plain version on the card, on the
    inputs of its last call in each tick of the counted replay, for each
    set of keyword arguments (K1 and K5 of the consolidation ticks' sweeps
    and decoded accepts, K1, K2 and K3 of the drift and expiration
    replacement solves, what the re-provision after the interruptions
    ran).  Fails unless K1 and K5 were recorded in a consolidation tick
    and K1, K2 and K3 in a drift tick."""
    seen = hold_recorded(torch, recorded, err,
                         lambda tick: f"{DISRUPTION_PATH}'s {tick}")
    for phase, names in (("consolidation", ("classpack_precompute",
                                            "classpack_sweep")),
                         ("drift", ("classpack_precompute", "classpack_scan",
                                    "classpack_assign_decode"))):
        for name in names:
            check(any(t.startswith(phase) and n == name
                      for t, n, _ in recorded),
                  f"no input of {name} was recorded in a {phase} tick")
    for name, where in seen.items():
        log(f"[disruption] {name} on the {len(where)} inputs recorded on "
            f"{DISRUPTION_PATH} (its last call in each tick; first "
            f"argument's shape): equal to plain — {', '.join(where)}")


def disruption_path(torch, card, err):
    """Phase 13's counted run: the cell with the launch counts set to 0
    just before `disruption_replay` and read just after, each tick's
    launches read around it; every tick must reproduce GOLDEN_DISRUPTION
    and K1, K5, K2 and K3 must have launched.  The inputs of each kernel
    wrapper's last call in each tick (for each set of keyword arguments)
    are kept (cloned) and, after the counts are read, the wrapper is held
    against its plain version on them.  Returns the launches by path: the
    whole replay, phase (a)'s decision ticks, the drift ticks."""
    from karpenter_tpu_torch import workloads
    t0 = time.perf_counter()
    env = fresh_disruption_env()
    build_s = time.perf_counter() - t0
    log(f"[disruption] fleet: {len(env.cluster.nodes)} nodes, "
        f"{len(env.cluster.pods)} pods after the scale-down, built in "
        f"{build_s:.3f} s (Provisioner.provision on the card)")
    ticks = []
    # (tick, kernel, keyword arguments) -> (args, kwargs) of the wrapper's
    # last call there (K1's sweep calls, with_ok=False, apart from its
    # accept's); calls between ticks are phase (d)'s re-provision
    record = kernel_log(torch, label="interruption re-provision")

    def counted(env, phase):
        before = all_launches()
        n_dec = len(decisions)
        record.label = f"{phase} tick {len(ticks)}"
        sig, res = workloads.disruption_tick(env, phase)
        record.label = "interruption re-provision"
        after = all_launches()
        ticks.append((phase, sig, {k: after[k] - before[k] for k in after},
                      len(decisions) > n_dec))
        return sig, res

    decisions = []
    ctrl = env.disruption
    orig = ctrl.consolidation_action

    def consolidation_action(cands):
        decisions.append(1)
        return orig(cands)
    ctrl.consolidation_action = consolidation_action
    with wrapped_kernels(record):
        reset_all_launches()
        t0 = time.perf_counter()
        sigs = workloads.disruption_replay(env, tick=counted)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches()
    check_disruption_golden(sigs, "disruption (counted run)")
    for name in DISRUPTION_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} never launched on the disruption path")
    for phase, sig, lt, dec in ticks:
        log(f"[disruption] {phase} tick: action {sig['action']}, launched "
            f"{len(sig['launched'])}, deleted {sig['deleted']}, running "
            f"{sig['running']} at {sig['price']!r} $/h, error "
            f"{sig['error']}; launches {({k: v for k, v in lt.items() if v})}")
    inter = sigs[-2]
    log(f"[disruption] interruption: {len(inter['interrupted'])} spot "
        f"instances reclaimed, {inter['provision']['launched']} launched for "
        f"{inter['provision']['bound_new']} evicted pods; gc: "
        f"{sigs[-1]['leaked']} leaked instance terminated")
    log(f"[disruption] {len(sigs)} ticks reproduce GOLDEN_DISRUPTION in "
        f"{wall:.3f} s (the wrappers' inputs cloned as they ran); launches "
        f"of the replay {launches}")
    compare_recorded_disruption(torch, record.recorded, err)

    def total(sel):
        out = {k: 0 for k in launches}
        for phase, _, lt, dec in ticks:
            if sel(phase, dec):
                for k, v in lt.items():
                    out[k] += v
        return out
    return {DISRUPTION_PATH: launches,
            f"{DISRUPTION_PATH} consolidation ticks": total(
                lambda ph, dec: ph == "consolidation" and dec),
            f"{DISRUPTION_PATH} drift ticks": total(
                lambda ph, dec: ph == "drift")}


def disruption_timings(torch, card):
    """Phase 13's timed runs, each on a fleet built anew: one with the
    tick split by wall clock (candidates = the reconcile less the
    decision and the execution; the execution split into launch, rebind
    and drain) and every kernel wrapper's call spanned by CUDA events
    (their sum is the ticks' kernel busy time, against the same run's
    wall: the idle share), one with each reconcile under the profiler (a
    second witness: it sees the torch operations on the card, and drops
    the kernels launched through ctypes).  Both must reproduce
    GOLDEN_DISRUPTION as well.  The drift p50 is over the executed ticks;
    the rolled-back tick is printed on its own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from karpenter_tpu_torch import workloads
    env = fresh_disruption_env()
    ctrl, acc, split = env.disruption, {}, []
    span = kernel_log(torch, spans=True)

    def timed(name, fn):
        def wrap(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[name] = acc.get(name, 0.0) + \
                    (time.perf_counter() - t) * 1e3
        return wrap

    ctrl.consolidation_action = timed("decision", ctrl.consolidation_action)
    ctrl._replace_or_delete = timed("decision", ctrl._replace_or_delete)
    ctrl.execute = timed("execute", ctrl.execute)
    env.provider.create = timed("launch", env.provider.create)
    env.cluster.bind_pod = timed("rebind", env.cluster.bind_pod)
    env.terminator.drain_sync = timed("drain", env.terminator.drain_sync)
    reconcile = ctrl.reconcile

    def tick_reconcile():
        acc.clear()
        span.take_busy()
        t = time.perf_counter()
        out = reconcile()
        torch.cuda.synchronize()
        acc["tick"] = (time.perf_counter() - t) * 1e3
        acc["kernels"], acc["calls"] = span.take_busy()
        return out
    ctrl.reconcile = tick_reconcile

    def split_tick(env, phase):
        sig, res = workloads.disruption_tick(env, phase)
        split.append((phase, dict(acc), sig["error"]))
        return sig, res
    with wrapped_kernels(span):
        sigs = workloads.disruption_replay(env, tick=split_tick)
    check_disruption_golden(sigs, "disruption (timed run)")

    env = fresh_disruption_env()
    ctrl, traced = env.disruption, []
    reconcile2 = ctrl.reconcile
    decided = []
    orig = ctrl.consolidation_action

    def consolidation_action(cands):
        decided.append(1)
        return orig(cands)
    ctrl.consolidation_action = consolidation_action

    def traced_reconcile():
        torch.cuda.synchronize()
        n_dec = len(decided)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            out = reconcile2()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        busy = sum(ev.self_device_time_total for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA) / 1e3
        traced.append((wall, busy, len(decided) > n_dec))
        return out
    ctrl.reconcile = traced_reconcile
    phases = []

    def traced_tick(env, phase):
        phases.append(phase)
        sig, res = workloads.disruption_tick(env, phase)
        phases[-1] = (phase, sig["error"])
        return sig, res
    sigs = workloads.disruption_replay(env, tick=traced_tick)
    check_disruption_golden(sigs, "disruption (traced run)")

    parts = ("tick", "candidates", "decision", "execute", "launch", "rebind",
             "drain", "kernels")
    consolidation = lambda ph, a, err: ph == "consolidation" and \
        "decision" in a  # noqa: E731
    drift = lambda ph, a, err: ph == "drift" and not err  # noqa: E731
    out = {}
    for group, sel in (("consolidation", consolidation), ("drift", drift)):
        rows = [a for ph, a, e in split if sel(ph, a, e)]
        for a in rows:
            a["candidates"] = a["tick"] - a.get("decision", 0.0) - \
                a.get("execute", 0.0)
        p50 = {k: statistics.median(a.get(k, 0.0) for a in rows)
               for k in parts}
        out[group] = p50
        each = [round(a["tick"], 3) for a in rows]
        kind = " (executed)" if group == "drift" else ""
        log(f"[time] disruption {group} tick{kind}: p50 {p50['tick']:.3f} "
            f"ms over {len(rows)} ticks {each}; candidates "
            f"{p50['candidates']:.3f}, "
            f"decision {p50['decision']:.3f}, execute {p50['execute']:.3f} "
            f"(launch {p50['launch']:.3f}, rebind {p50['rebind']:.3f}, "
            f"drain {p50['drain']:.3f}) ms on {card}")
        # the kernel wrappers' CUDA-event spans over the same ticks' wall:
        # a span runs from the wrapper's entry to its kernel's end, so it
        # holds the wrapper's host work ahead of the launch as well
        busy = sum(a["kernels"] for a in rows)
        wall = sum(a["tick"] for a in rows)
        calls = sum(a["calls"] for a in rows)
        out[group]["idle_share"] = 1 - busy / wall
        tr = [(w, b) for (w, b, dec), (ph, e) in zip(traced, phases)
              if (ph == "consolidation" and dec if group == "consolidation"
                  else ph == "drift" and not e)]
        check(len(tr) == len(rows), f"{len(tr)} traced {group} ticks, "
              f"{len(rows)} timed")
        seen = sum(b for _, b in tr)
        log(f"[trace] disruption {group} ticks: the {calls} kernel calls' "
            f"CUDA-event spans {busy:.3f} ms of {wall:.3f} ms wall over "
            f"{len(rows)} ticks: idle share {out[group]['idle_share']:.4f}; "
            f"the profiler (a second witness, blind to the ctypes "
            f"launches) saw {seen:.3f} ms of device time over the same "
            f"ticks on {card}")
        check(busy > 0 and calls > 0, f"the disruption {group} ticks "
              f"spanned no kernel call")
    rolled = [a for ph, a, e in split if ph == "drift" and e]
    check(len(rolled) == 1, f"{len(rolled)} rolled-back drift ticks")
    a = rolled[0]
    a["candidates"] = a["tick"] - a.get("decision", 0.0) - \
        a.get("execute", 0.0)
    log(f"[time] disruption drift tick (rolled back: every replacement "
        f"launch ICE'd): {a['tick']:.3f} ms; candidates "
        f"{a['candidates']:.3f}, decision {a.get('decision', 0.0):.3f}, "
        f"execute {a.get('execute', 0.0):.3f} (launch "
        f"{a.get('launch', 0.0):.3f}, rebind {a.get('rebind', 0.0):.3f}, "
        f"drain {a.get('drain', 0.0):.3f}) ms; kernel spans "
        f"{a['kernels']:.3f} ms over {a['calls']} calls on {card}")
    return out


# ---------------------------------------------------------------------------
# phase 14: the arena and the operator
# ---------------------------------------------------------------------------

ARENA = " +arena"
INGEST_PATH = LIVE_PATH + " +arena +ingest"
OPERATOR_PATH = "operator-live-5k-2k"


def operator_kit(snapshot_path=None):
    """The port's kit for `workloads.operator_env`; with `snapshot_path`
    its Options turn the WarmRestart gate on and name that file."""
    from types import SimpleNamespace
    from karpenter_tpu_torch.cloud.fake import (ImageInfo, SecurityGroupInfo,
                                                SubnetInfo)
    from karpenter_tpu_torch.operator import (Operator, Options,
                                              build_controllers)
    if snapshot_path is not None:
        plain = Options

        def Options():
            opts = plain(snapshot_path=snapshot_path)
            opts.feature_gates["WarmRestart"] = True
            return opts
    return SimpleNamespace(Operator=Operator, Options=Options,
                           build_controllers=build_controllers,
                           SubnetInfo=SubnetInfo,
                           SecurityGroupInfo=SecurityGroupInfo,
                           ImageInfo=ImageInfo)


def idle_line(busy, calls, wall):
    return (f"kernel spans {busy:.3f} ms over {calls} calls of {wall:.3f} ms "
            f"wall: idle share {1 - busy / wall:.4f}")


def arena_round(torch, card, env, hook, path, r, want, ingest=False):
    """One counted provision() of an arena run: launch counts zeroed just
    before it and read just after, its kernel wrappers' inputs recorded
    under `path round r` and spanned, its layers split; it must give
    `want`, and on a live cluster its gather must have been served warm
    from the arena's slab.  Returns the round's launches."""
    from karpenter_tpu_torch import workloads
    arena = env.cluster.arena
    if ingest:
        arena.flush()              # the manager's top-of-tick flush
    live = len(env.cluster.nodes) > 0
    g0 = dict(arena.gathers)
    hook.label = f"{path} round {r}"
    hook.take_busy()
    reset_all_launches()
    with layer_timer(torch, env.provisioner) as acc:
        t0 = time.perf_counter()
        sig, _ = workloads.provision_pending(env)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    launches = all_launches()
    busy, calls = hook.take_busy()
    check(sig == want, f"{path} round {r}: {sig} != golden {want}")
    warm = arena.gathers["warm"] - g0["warm"]
    check(arena.gathers["fallback"] == g0["fallback"],
          f"{path} round {r}: the arena refused a gather")
    check(warm >= 1 or not live, f"{path} round {r}: the live nodes were not "
          f"gathered from the arena")
    log(f"[arena] {path} round {r}: golden matches ({sig['launched']} "
        f"launched, {sig['bound_existing']} bound to existing nodes); "
        f"{warm} warm gathers; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    log(f"[time] {path} round {r}: provision() {wall:.3f} ms "
        f"({layer_line(acc, wall)}); {idle_line(busy, calls, wall)} on {card}")
    return launches


def arena_cells(torch, card, hook, device="cuda"):
    """14(a): every cell of GOLDEN_PROVISION with more than one round (a
    live cluster for the arena to serve: the one-round cells' gathers find
    no node, and phase 10 runs them) with the arena attached before round
    1, every round against its golden (`arena_round`), the ladder and the
    decode breaker clean; then the live cell once more behind an
    IngestBatcher flushed before each provision().  Returns the launches by
    path."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.api.objects import NodePool
    from karpenter_tpu_torch.catalog.generate import generate_catalog
    from karpenter_tpu_torch.cloud import CloudProvider, FakeCloud
    from karpenter_tpu_torch.controllers.provisioning import Provisioner
    from karpenter_tpu_torch.ops.decode import DecodeHealth
    from karpenter_tpu_torch.ops.health import SolverHealth
    from karpenter_tpu_torch.state import Cluster
    from karpenter_tpu_torch.state.ingest import IngestBatcher
    catalog = generate_catalog(workloads.PROVISION_TYPES)
    by_path = {}
    runs = [(cell, cell + ARENA, False) for cell in workloads.GOLDEN_PROVISION
            if len(workloads.PROVISION_CELLS[cell][1]) > 1]
    runs.append((LIVE_PATH, INGEST_PATH, True))
    for cell, path, ingest in runs:
        clear_lp_caches()
        health, dh = SolverHealth(), DecodeHealth()
        env = workloads.provision_env(cell, FakeCloud, CloudProvider, Cluster,
                                      Provisioner, NodePool, catalog,
                                      arena=True, health=health,
                                      decode_health=dh, device=device)
        if ingest:
            env.cluster.arena = IngestBatcher(env.cluster.arena)
        total = {}
        for r, (kw, seed) in enumerate(workloads.PROVISION_CELLS[cell][1]):
            env.cluster.add_pods(workloads.build_pods(
                rng=np.random.default_rng(seed), **kw))
            got = arena_round(torch, card, env, hook, path, r + 1,
                              workloads.GOLDEN_PROVISION[cell][r], ingest)
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
        check(not health.transitions and all(
            v["total_failures"] == 0
            for v in health.snapshot()["rungs"].values()),
            f"{path}: the solver ladder booked a failure")
        check(dh.total_failures == 0 and not dh.transitions,
              f"{path}: the decode breaker booked a failure")
        if ingest:
            log(f"[arena] {path}: {env.cluster.arena.events_total} events "
                f"coalesced into {env.cluster.arena.flushes_total} flushes")
        by_path[path] = total
    hook.label = None
    return by_path




def arena_disruption(torch, card, hook, device="cuda"):
    """14(b): disruption-replay-500 with the arena attached before the fleet
    is built, every tick against GOLDEN_DISRUPTION, the consolidation ticks'
    SimulationArena faces gathered warm.  (Phase 13 replays it without the
    arena.)  Returns the run's launches."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.catalog.generate import generate_catalog
    clear_lp_caches()
    env = workloads.disruption_env(
        workloads.port_kit(), generate_catalog(workloads.DISRUPTION_TYPES),
        arena=True, device=device)
    ctrl, decided, ticks = env.disruption, [], []
    orig = ctrl.consolidation_action

    def consolidation_action(cands):
        decided.append(1)
        return orig(cands)
    ctrl.consolidation_action = consolidation_action
    path = DISRUPTION_PATH + ARENA

    def tick(env, phase):
        n_dec = len(decided)
        g0 = dict(env.cluster.arena.gathers)
        hook.label = f"{path} {phase} tick {len(ticks)}"
        hook.take_busy()
        t0 = time.perf_counter()
        sig, res = workloads.disruption_tick(env, phase)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        busy, calls = hook.take_busy()
        # calls between ticks are phase (d)'s re-provision
        hook.label = f"{path} interruption re-provision"
        ticks.append((phase, len(decided) > n_dec, wall, busy, calls,
                      env.cluster.arena.gathers["warm"] - g0["warm"]))
        return sig, res
    reset_all_launches()
    sigs = workloads.disruption_replay(env, tick=tick)
    hook.label = None
    check_disruption_golden(sigs, "disruption (with the arena)")
    launches = all_launches()
    dec = [t for t in ticks if t[0] == "consolidation" and t[1]]
    busy, calls = sum(t[3] for t in dec), sum(t[4] for t in dec)
    wall = sum(t[2] for t in dec)
    check(env.cluster.arena.gathers["fallback"] == 0,
          "the disruption cell's arena refused a gather")
    check(all(t[5] >= 1 for t in dec),
          "a consolidation tick's faces were not gathered from the arena")
    log(f"[arena] {path}: {len(sigs)} ticks reproduce GOLDEN_DISRUPTION; "
        f"warm gathers in the consolidation ticks with a decision "
        f"{[t[5] for t in dec]}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    log(f"[time] {DISRUPTION_PATH} consolidation tick with a decision (with "
        f"the arena): p50 {statistics.median(t[2] for t in dec):.3f} ms over "
        f"{len(dec)} ticks {[round(t[2], 3) for t in dec]}; "
        f"{idle_line(busy, calls, wall)} on {card}")
    return {path: launches}


def operator_cell(torch, card, hook, device="cuda", snap=None):
    """14(c): the operator cell at a tenth of its depth —
    `Operator(Options())` on the card with its default full-width catalog
    and a stepped clock, `build_controllers`, the live cell's two bursts
    cut to 5000 and 2000 pods (`workloads.OPERATOR_SMALL_ROUNDS`) through
    its Provisioner, one DisruptionController reconcile 10 000 s later —
    against GOLDEN_OPERATOR_SMALL, each step counted (launches zeroed just
    before it), timed with its split, spanned and its kernel inputs
    recorded.  With `snap` (a dict naming a "path"), the operator's Options
    carry the WarmRestart gate and that path, and right after round 1 a
    `SnapshotWriter` writes the file under the state lock: `snap` gets its
    bytes, its write's host ms and round 2's provision() ms (phase 18
    restores it in a fresh process).  Returns the launches by step."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.state.snapshot import SnapshotWriter
    clear_lp_caches()
    t0 = time.perf_counter()
    env = workloads.operator_env(
        operator_kit(snap["path"] if snap is not None else None),
        device=device)
    check(env.op.device.type == device, "the operator is not on the card")
    log(f"[operator] Operator(Options()) and build_controllers in "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms: "
        f"{len(env.op.catalog)} types, arena "
        f"{type(env.op.cluster.arena).__name__}, cloud "
        f"{type(env.op.cloud_provider.cloud).__name__}, controllers "
        f"{sorted(env.controllers)}")
    arena, by_path = env.op.cluster.arena, {}

    def counted(label, fn):
        g0 = dict(arena.gathers)
        hook.label = label
        hook.take_busy()
        reset_all_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        by_path[label] = all_launches()
        busy, calls = hook.take_busy()
        warm = arena.gathers["warm"] - g0["warm"]
        check(arena.gathers["fallback"] == g0["fallback"],
              f"{label}: the arena refused a gather")
        return out, wall, busy, calls, warm

    def provision(penv):
        label = f"{OPERATOR_PATH} round {len(by_path) + 1}"
        timer = layer_timer(torch, penv.provisioner)
        with timer as acc:
            out, wall, busy, calls, warm = counted(
                label, lambda: workloads.provision_pending(penv))
        check(warm >= 1 or label.endswith("round 1"),
              f"{label}: the live nodes were not gathered from the arena")
        log(f"[operator] {label}: {out[0]['launched']} launched, "
            f"{out[0]['bound_existing']} bound to existing nodes; {warm} "
            f"warm gathers; launches "
            f"{ {k: v for k, v in by_path[label].items() if v} }")
        log(f"[time] {label}: provision() {wall:.3f} ms "
            f"({layer_line(acc, wall)}); {idle_line(busy, calls, wall)} "
            f"on {card}")
        if snap is not None and label.endswith("round 1"):
            check(env.op.options.gate("WarmRestart"),
                  "the operator cell's WarmRestart gate is off")
            writer = SnapshotWriter(snap["path"], env.op)
            with env.op.state_lock:
                check(writer.write_final(), f"the snapshot after {label} "
                                            f"was not written")
            snap.update(bytes=writer.last_bytes,
                        write_ms=writer.last_write_ms)
            log(f"[restart] {label}: snapshot of {len(env.op.cluster.pods)} "
                f"pods and {len(env.op.cluster.nodes)} nodes, "
                f"{writer.last_bytes} bytes, written in "
                f"{writer.last_write_ms:.3f} ms on the host under the state "
                f"lock")
        elif snap is not None and label.endswith("round 2"):
            snap["round2_ms"] = wall
        return out

    def tick():
        label = f"{OPERATOR_PATH} tick"
        res, wall, busy, calls, warm = counted(
            label, env.controllers["disruption"].reconcile)
        check(warm >= 1, f"{label}: the consolidation faces were not "
                         f"gathered from the arena")
        log(f"[operator] {label}: action {res.action and res.action.kind}, "
            f"{warm} warm gathers; launches "
            f"{ {k: v for k, v in by_path[label].items() if v} }")
        log(f"[time] {label}: reconcile() {wall:.3f} ms; "
            f"{idle_line(busy, calls, wall) if calls else 'no kernel call'} "
            f"on {card}")
        return res
    got = workloads.operator_replay(env, workloads.build_pods,
                                    provision=provision, tick=tick,
                                    rounds=workloads.OPERATOR_SMALL_ROUNDS)
    hook.label = None
    check(got == workloads.GOLDEN_OPERATOR_SMALL,
          f"{OPERATOR_PATH}: {got} != GOLDEN_OPERATOR_SMALL "
          f"{workloads.GOLDEN_OPERATOR_SMALL}")
    for name in ("classpack_precompute", "classpack_scan",
                 "classpack_assign_decode"):
        check(all(by_path[f"{OPERATOR_PATH} round {r}"][name] > 0
                  for r in (1, 2)),
              f"{name} did not launch in both of the operator's rounds")
    log(f"[operator] {OPERATOR_PATH} reproduces GOLDEN_OPERATOR_SMALL on "
        f"{card}")
    return by_path


def phase14(torch, card, err, device="cuda", snap=None):
    """Phase 14, the arena and the operator: (a) the provisioning cells with
    the arena, (b) the disruption cell with it, (c) the operator cell (its
    round 1 snapshotted into `snap` for phase 18), then
    (d) every kernel wrapper those paths launched held against its plain
    version on the inputs of its last call on each path; (e) launch counts
    and idle shares, and (f) the timings, are printed along the way.
    Returns the launches by path."""
    hook = kernel_log(torch, spans=True)
    with wrapped_kernels(hook):
        by_path = arena_cells(torch, card, hook, device)
        by_path.update(arena_disruption(torch, card, hook, device))
        by_path.update(operator_cell(torch, card, hook, device, snap))
    seen = hold_recorded(torch, hook.recorded, err, lambda label: label)
    for name, where in seen.items():
        log(f"[arena] {name} on the {len(where)} inputs recorded on phase "
            f"14's paths (its last call on each; first argument's shape): "
            f"equal to plain — {', '.join(where)}")
    for path, launches in by_path.items():
        log(f"[arena] launches on {path}: "
            f"{ {k: v for k, v in launches.items() if v} }")
    return by_path


# ---------------------------------------------------------------------------
# phase 15: the operator loop
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
# the canned goldens without a gated section, at tests/test_sim.py's
# horizons: (name, scenario file, virtual seconds)
SIM_GOLDENS = (("diurnal", "diurnal.yaml", 7200.0),
               ("spot-reclaim-storm", "spot-reclaim-storm.yaml", 7200.0),
               ("ice-starvation", "ice-starvation.yaml", 5400.0),
               ("steady-state-drip", "steady-state-drip.yaml", 300.0),
               ("long-soak", "long-soak.yaml", 120.0))
# the gate replays that must give the same goldens (tests/test_sim.py:294,
# 379, 465): (name, the harness's override)
SIM_GATED = (("steady-state-drip", dict(incremental_arena=False)),
             ("long-soak", dict(incremental_arena=False)),
             ("steady-state-drip", dict(ingest_batch=True)),
             ("diurnal", dict(device_decode=True)))
SOAK_PATH = "sim-long-soak-480"
DRIP_PATH = "sim-steady-state-drip-480"  # sweeps after its 300 s golden
V1_PATH = "v1-solve-headline"
V1_REPEATS = 1


def sim_label(name, kw):
    return "sim-" + name + "".join(f" {k}={v}" for k, v in kw.items())


def sim_replay(torch, card, hook, fname, duration, label, exceptions=0,
               scenario=None, **kw):
    """One SimHarness replay on the card (its default device): the launch
    counts zeroed just before `run()` and read just after, the manager's
    ticks counted, every kernel wrapper's call spanned and its inputs kept
    under `label`; the report must count `exceptions` tick exceptions.
    `scenario` replaces the loaded file.  Returns (the run, the harness,
    launches, wall s)."""
    from karpenter_tpu_torch.sim import SimHarness, load_scenario
    clear_lp_caches()
    if scenario is None:
        scenario = load_scenario(os.path.join(REPO, "scenarios", fname))
    h = SimHarness(scenario, seed=0, duration_s=duration, **kw)
    check(h.op.device.type == "cuda", f"{label}: the harness is not on the "
                                      f"card")
    ticks, tick = [0], h.mgr.tick

    def counted_tick():
        ticks[0] += 1
        return tick()
    h.mgr.tick = counted_tick
    hook.label = label
    hook.take_busy()
    reset_all_launches()
    t0 = time.perf_counter()
    run = h.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    busy, calls = hook.take_busy()
    hook.label = None
    check(run.report["errors"]["tick_exceptions"] == exceptions,
          f"{label}: {run.report['errors']['tick_exceptions']} tick "
          f"exceptions, not {exceptions}")
    arena = h.cluster.arena
    gathers = dict(arena.gathers) if arena is not None else None
    log(f"[sim] {label}: {run.virtual_seconds:.0f} virtual s in "
        f"{wall:.3f} s wall ({run.virtual_seconds / wall:.1f}x real time), "
        f"{ticks[0]} ticks, {run.events_delivered} events; arena gathers "
        f"{gathers}; launches { {k: v for k, v in launches.items() if v} }; "
        f"{idle_line(busy, calls, wall * 1e3)} on {card}")
    return run, h, launches, wall


def sim_goldens(torch, card, hook):
    """15(a): the five canned goldens replayed on the card, byte for byte
    against tests/golden/ (read, never written), then the gate replays
    against the same goldens.  Returns the launches by path and the walls
    of the drip's runs."""
    from karpenter_tpu_torch.sim import report_to_json
    by_path, walls = {}, {}
    runs = [(name, {}) for name, _, _ in SIM_GOLDENS] + list(SIM_GATED)
    cases = {name: (fname, dur) for name, fname, dur in SIM_GOLDENS}
    for name, kw in runs:
        fname, duration = cases[name]
        label = sim_label(name, kw)
        run, _, launches, wall = sim_replay(torch, card, hook, fname,
                                            duration, label, **kw)
        with open(os.path.join(REPO, "tests", "golden",
                               f"sim-{name}.json")) as fh:
            want = fh.read()
        got = report_to_json(run.report)
        check(got == want, f"{label}: the report differs from "
                           f"tests/golden/sim-{name}.json: {got[:3000]}")
        by_path[label] = launches
        walls[label] = wall
    for name in ("classpack_precompute", "classpack_scan",
                 "classpack_assign_decode", "classpack_sweep"):
        check(any(v[name] for v in by_path.values()),
              f"{name} did not launch on the sim replays")
    log(f"[sim] the five canned goldens and the four gate replays are "
        f"reproduced byte for byte on {card}")
    return by_path, walls


def arena_pairs(torch, card, hook, cell, label, want):
    """One replay of `cell` (a `workloads.SIM_*` dict) with the arena on
    (the default) and off, in that order (on, off, off, on before phase 17
    came: one pair keeps the script in its time), each with its
    wall time, speedup, ticks, gathers, launches and idle share; every
    report's `workloads.sim_digest` must be `want`, the JAX package's, and
    the arena must serve warm gathers and refuse none.  Returns the walls
    by arena and the first arena run's launches."""
    from karpenter_tpu_torch import workloads
    walls, first = {True: [], False: []}, None
    for arena in (True, False):
        path = label + ("" if arena else " incremental_arena=False")
        run, h, launches, wall = sim_replay(torch, card, hook,
                                            cell["scenario"],
                                            cell["duration_s"], path,
                                            incremental_arena=arena)
        got = workloads.sim_digest(run.report)
        check(got == want, f"{path}: {got} != {want}")
        if arena:
            g = h.cluster.arena.gathers
            check(g["warm"] > 0 and g["fallback"] == 0,
                  f"{path}: the arena's gathers {g}")
            first = first or launches
        walls[arena].append(wall)
    return walls, first


def ab_line(walls):
    on, off = (statistics.mean(walls[k]) for k in (True, False))
    return (f"with the arena {', '.join(f'{x:.3f}' for x in walls[True])} "
            f"s (mean {on:.3f}), without "
            f"{', '.join(f'{x:.3f}' for x in walls[False])} s (mean "
            f"{off:.3f}): with / without {on / off:.3f}")


def sim_soak(torch, card, hook, walls):
    """15(b): the cells sim-long-soak-480 (workloads.SIM_SOAK) and
    sim-steady-state-drip-480 (SIM_DRIP) with the arena on and off
    (`arena_pairs`), each run against the JAX package's GOLDEN_SIM_SOAK /
    GOLDEN_SIM_DRIP (the drip's 300 s golden sweeps nothing: its walls
    from 15(a) are printed beside).  Returns the arena runs' launches."""
    from karpenter_tpu_torch import workloads
    soak, soak_launches = arena_pairs(torch, card, hook, workloads.SIM_SOAK,
                                      SOAK_PATH, workloads.GOLDEN_SIM_SOAK)
    drip, drip_launches = arena_pairs(torch, card, hook, workloads.SIM_DRIP,
                                      DRIP_PATH, workloads.GOLDEN_SIM_DRIP)
    log(f"[time] {SOAK_PATH}: {ab_line(soak)}; on {card}")
    log(f"[time] {DRIP_PATH}: {ab_line(drip)}; steady-state-drip 300 s: "
        f"{walls['sim-steady-state-drip']:.3f} s with, "
        f"{walls['sim-steady-state-drip incremental_arena=False']:.3f} s "
        f"without; on {card}")
    return {SOAK_PATH: soak_launches, DRIP_PATH: drip_launches}


def v1_kit():
    from types import SimpleNamespace
    from karpenter_tpu_torch.operator import ControllerManager
    kit = operator_kit()
    return SimpleNamespace(**vars(kit), ControllerManager=ControllerManager)


def v1_in_process(torch, card, hook):
    """15(c), in process: the operator from the command line at full width,
    restarted over a launched fleet (`workloads.v1_manager`), its endpoints
    on a free port and `run()` in a thread (`workloads.start_loop`: the
    exception the loop ends with is kept, and none may be); /readyz,
    /v1/apply, /v1/nodepools, then /v1/solve of the headline's 50 000 Pod
    manifests against GOLDEN_V1_SOLVE, timed V1_REPEATS times with the
    split manifest decode / solve / response.  Each request runs with the
    loop held between ticks, so its launch counts, kernel spans, recorded
    inputs and timings are the /v1 path's alone."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.api import serialize
    clear_lp_caches()
    t0 = time.perf_counter()
    mgr = workloads.v1_manager(v1_kit(), workloads.build_pods)
    check(mgr.operator.device.type == "cuda", "the /v1 operator is not on "
                                              "the card")
    port = mgr.serve_endpoints(metrics_port=0)
    loop, loop_errors, pause = workloads.start_loop(mgr)
    log(f"[v1] restarted operator up in "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms: "
        f"{len(mgr.operator.cluster.nodes)} hydrated nodes, port {port}")
    try:
        code, ready = workloads.http_json(port, "/readyz")
        check(code == 200 and ready["ready"] and ready["probe"] == "ok",
              f"/readyz: {code} {ready}")
        code, out = workloads.http_json(
            port, "/v1/apply", {"manifests": workloads.V1_MANIFESTS})
        check(code == 200, f"/v1/apply: {code} {out}")
        code, listed = workloads.http_json(port, "/v1/nodepools")
        check(code == 200 and listed["items"][0]["spec"]["template"][
            "metadata"]["labels"] == {"team": "v1"},
            f"/v1/nodepools: {code} {listed}")
        code, body = http_get(port, "/metrics")
        check(code == 200 and b"# TYPE karpenter_nodes_created " in body,
              f"/metrics: {code}, not the registry's exposition")
        pods = workloads.build_pods(rng=np.random.default_rng(
            workloads.HEADLINE_SEED), **workloads.HEADLINE)
        payload = workloads.v1_solve_payload(pods)
        body = json.dumps(payload).encode()
        # the split: the handler's three parts, timed in process on the
        # same payload (decode, solve, response), beside the HTTP round trip
        decode, solve, respond, total = [], [], [], []
        by_path = {}
        prov = mgr.controllers["provisioning"]
        orig_solve = prov.solve
        for i in range(V1_REPEATS):
            times = {}

            def timed_solve(*a, **k):
                t = time.perf_counter()
                out = orig_solve(*a, **k)
                torch.cuda.synchronize()
                times["solve"] = time.perf_counter() - t
                return out
            with pause:     # no tick of the loop inside the window
                clear_lp_caches()
                prov.solve = timed_solve
                hook.label = V1_PATH if i == 0 else None
                hook.take_busy()
                reset_all_launches()
                t = time.perf_counter()
                code, resp = workloads.http_json(port, "/v1/solve", payload)
                total.append((time.perf_counter() - t) * 1e3)
                launches = all_launches()
                busy, calls = hook.take_busy()
                hook.label = None
                prov.solve = orig_solve
            check(code == 200, f"/v1/solve: {code} {str(resp)[:2000]}")
            got = workloads.v1_solve_digest(resp)
            check(got == workloads.GOLDEN_V1_SOLVE,
                  f"/v1/solve: {got} != GOLDEN_V1_SOLVE "
                  f"{workloads.GOLDEN_V1_SOLVE}")
            if i == 0:
                by_path[V1_PATH] = launches
                log(f"[v1] {V1_PATH}: GOLDEN_V1_SOLVE reproduced over HTTP "
                    f"({got['nodes']} nodes, {got['total_price']} $/h); "
                    f"launches "
                    f"{ {k: v for k, v in launches.items() if v} }; "
                    f"{idle_line(busy, calls, total[-1])} on {card}")
            t = time.perf_counter()
            [serialize.pod_from_manifest(p)
             for p in json.loads(body)["pods"]]
            decode.append((time.perf_counter() - t) * 1e3)
            solve.append(times["solve"] * 1e3)
            t = time.perf_counter()
            json.dumps(resp).encode()
            respond.append((time.perf_counter() - t) * 1e3)
        for name in ("classpack_precompute", "classpack_scan",
                     "classpack_assign_decode"):
            check(by_path[V1_PATH][name] > 0,
                  f"{name} did not launch in /v1/solve")
        med = statistics.median
        log(f"[time] {V1_PATH}: /v1/solve p50 {med(total):.3f} ms over "
            f"{V1_REPEATS} requests ({', '.join(f'{x:.1f}' for x in total)};"
            f" cold guide caches each): manifest decode {med(decode):.3f}, "
            f"solve {med(solve):.3f}, response encode {med(respond):.3f}, "
            f"the rest (HTTP, JSON parse, admission) "
            f"{med(total) - med(decode) - med(solve) - med(respond):.3f} on "
            f"{card}")
        report, live = mgr.liveness_report()
        check(live, f"/healthz: {report}")
        check(loop.is_alive() and not loop_errors,
              f"the manager's loop ended early: {loop_errors!r}")
    finally:
        mgr.stop()
        loop.join(timeout=60)
    check(not loop.is_alive(), "the manager's loop did not stop")
    check(not loop_errors, f"the manager's loop raised: {loop_errors!r}")
    check(mgr.phase == "DRAINING", f"the manager ends in {mgr.phase}")
    return by_path


def v1_process(card):
    """15(c), as a process: `python3 -m karpenter_tpu_torch` on the card,
    its "up" line awaited, /readyz and /v1/solve of a small batch, then
    SIGTERM: it must exit 0."""
    import signal
    import threading
    from karpenter_tpu_torch import workloads
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "karpenter_tpu_torch",
                             "--metrics-port", "0"], cwd=REPO,
                            stderr=subprocess.PIPE, text=True)
    try:
        port, deadline, seen = None, time.time() + 300, []
        while port is None and time.time() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            seen.append(line)
            if "karpenter-tpu up:" in line:
                port = int(line.split("endpoints=127.0.0.1:")[1].split()[0])
        check(port is not None, f"python3 -m karpenter_tpu_torch printed no "
                                f"up line: {''.join(seen)[-3000:]}")
        up = time.perf_counter() - t0
        threading.Thread(target=proc.stderr.read, daemon=True).start()
        code, ready = workloads.http_json(port, "/readyz")
        check(code == 200 and ready["ready"], f"/readyz: {code} {ready}")
        pods = workloads.build_pods(rng=np.random.default_rng(0), **dict(
            workloads.HEADLINE, spec_count=30, total=600))
        t = time.perf_counter()
        code, resp = workloads.http_json(port, "/v1/solve",
                                         workloads.v1_solve_payload(pods))
        solve_ms = (time.perf_counter() - t) * 1e3
        check(code == 200 and resp["nodes"] and not resp["unschedulable"],
              f"/v1/solve: {code} {str(resp)[:2000]}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        check(rc == 0, f"python3 -m karpenter_tpu_torch exited {rc} on "
                       f"SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log(f"[v1] python3 -m karpenter_tpu_torch: up in {up:.3f} s, /readyz "
        f"200, /v1/solve of 600 pods {solve_ms:.3f} ms "
        f"({len(resp['nodes'])} nodes), exit 0 on SIGTERM, on {card}")


def phase15(torch, card, err):
    """Phase 15, the operator loop: (a) the canned goldens replayed by the
    simulator on the card, (b) the soak cell with the arena on and off,
    (c) the /v1 surface in process and `python3 -m karpenter_tpu_torch` as
    a process, then (d) every kernel wrapper those paths launched held
    against its plain version on the inputs of its last call on each path;
    (e) the timings, launches and idle shares along the way.  Returns the
    launches by path and the recorded inputs."""
    hook = kernel_log(torch, spans=True)
    with wrapped_kernels(hook):
        by_path, walls = sim_goldens(torch, card, hook)
        by_path.update(sim_soak(torch, card, hook, walls))
        by_path.update(v1_in_process(torch, card, hook))
    v1_process(card)
    seen = hold_recorded(torch, hook.recorded, err, lambda label: label)
    for name, where in seen.items():
        log(f"[loop] {name} on the {len(where)} inputs recorded on phase "
            f"15's paths (its last call on each; first argument's shape): "
            f"equal to plain — {', '.join(where)}")
    for path, launches in by_path.items():
        log(f"[loop] launches on {path}: "
            f"{ {k: v for k, v in launches.items() if v} }")
    return by_path, hook.recorded


# ---------------------------------------------------------------------------
# phase 16: robustness — the native packer, the chaos storm, the watchdog,
# and device faults under both ladders
# ---------------------------------------------------------------------------

CHAOS_PATH = "sim-chaos-storm"
CHAOS_EXCEPTIONS = 9      # the golden's tick exceptions (injected faults)
NATIVE_ROWS = 256         # ops/ffd.NATIVE_CUTOVER_ROWS


def native_inputs(torch, scans, recorded):
    """The K7 inputs phase 16(a) runs the native packer on, as (name, the
    wrapper's arguments on the card, K): every K7 input of at most
    NATIVE_ROWS rows that phase 15 recorded (its last call on each path),
    provision-small-3x64's batches (phase 10), and tests/test_native.py's
    edge cases (`ffd_edge_cases`, plus existing nodes whose usage defaults
    to empty)."""
    from karpenter_tpu_torch.ops.ffd import ffd_device_args, lower_ffd
    out = []
    for (label, name, _), (args, _kw) in sorted(recorded.items()):
        if name == "ffd_scan" and int(args[4].sum()) <= NATIVE_ROWS:
            out.append((label, args[:-1], args[-1]))
    check(out, "phase 15 recorded no K7 input of at most 256 rows")
    for label, args in scans.items():
        if label.startswith(SMALL_PATH):
            out.append((label, args[:-1], args[-1]))
    dev = torch.device("cuda")
    cases = ffd_edge_cases()
    name, prob, kw = cases[-1]
    cases.append((name + ", usage default-empty", prob,
                  dict(existing_alloc=kw["existing_alloc"])))
    for name, prob, kw in cases:
        low = lower_ffd(prob, **kw)
        out.append((name, ffd_device_args(low, dev), low.K))
    return out


def native_against_k7(torch, card, scans, recorded):
    """16(a): on each input of `native_inputs`, the native packer on the
    host, K7 on the card and K7's plain version on the card and on the
    host: assignment, slot options, slot usage (float32 bits) and the open
    count equal across the four; then the native call's host p50 beside
    K7's card time (`card_ms`), its host-rate time (`event_ms`) and the
    host p50 of K7's plain version (the other candidate for the ladder's
    "native" rung)."""
    from karpenter_tpu_torch import native, workloads
    from karpenter_tpu_torch.ops import ffd_kernels as fk
    rows = []
    for name, args, K in native_inputs(torch, scans, recorded):
        host = [a.cpu().numpy() for a in args]
        nargs = workloads.ffd_native_args(host, K)
        P = len(nargs["requests"])
        assignment, slot_option, slot_used, n_open = \
            native.ffd_pack_native(**nargs)
        cpu_args = [a.cpu() for a in args]
        got = fk.ffd_scan(*args, K)
        want = fk.ffd_scan_plain(*args, K)
        on_host = fk.ffd_scan_plain(*cpu_args, K)
        torch.cuda.synchronize()
        for out, who in ((got, "K7"), (want, "K7's plain version"),
                         (on_host, "K7's plain version on the host")):
            a, so, su, n = (t.cpu().numpy() for t in out)
            check(np.array_equal(a[:P], assignment) and (a[P:] == -1).all()
                  and np.array_equal(so, slot_option)
                  and np.array_equal(su.view(np.int32),
                                     slot_used.view(np.int32))
                  and int(n) == n_open,
                  f"[native] {name}: the native packer differs from {who}")
        nat, _ = p50_ms(lambda: native.ffd_pack_native(**nargs), iters=21)
        dev = card_ms(torch, lambda: fk.ffd_scan(*args, K), 50)
        rate = event_ms(torch, lambda: fk.ffd_scan(*args, K), 50)
        plain, _ = p50_ms(lambda: fk.ffd_scan_plain(*cpu_args, K), iters=21)
        rows.append((name, P, K, nat, dev, rate, plain))
        log(f"[native] {name}: P={P} K={K} n_open={n_open}: native, K7 and "
            f"plain (card, host) bit-equal; native {nat:.4f} ms (host "
            f"p50), K7 {dev:.4f} ms card, {rate:.4f} ms host-rate, K7's "
            f"plain version {plain:.4f} ms (host p50, "
            f"{torch.get_num_threads()} threads), on {card}")
    faster = sum(1 for r in rows if r[3] < r[5])
    log(f"[native] {len(rows)} inputs of at most {NATIVE_ROWS} rows: the "
        f"native packer's host time under K7's host-rate time on {faster}; "
        f"native {min(r[3] for r in rows):.4f}-{max(r[3] for r in rows):.4f}"
        f" ms, K7 card {min(r[4] for r in rows):.4f}-"
        f"{max(r[4] for r in rows):.4f} ms, host-rate "
        f"{min(r[5] for r in rows):.4f}-{max(r[5] for r in rows):.4f} ms")
    log(f"[native] K7's plain version on the host "
        f"{min(r[6] for r in rows):.4f}-{max(r[6] for r in rows):.4f} ms, "
        f"{min(r[6] / r[3] for r in rows):.2f}-"
        f"{max(r[6] / r[3] for r in rows):.2f}x the native packer's; under "
        f"it on {sum(1 for r in rows if r[6] < r[3])} of {len(rows)}")


def chaos_storm(torch, card, hook):
    """16(b): scenarios/chaos-storm.yaml (seed 0, 5400 s) on the card with
    the arena on, then off, each report byte for byte against
    tests/golden/sim-chaos-storm.json; then its chaos block off (no golden:
    K7's unarmed count).  Returns the launches by path."""
    from karpenter_tpu_torch.sim import load_scenario, report_to_json
    with open(os.path.join(REPO, "tests", "golden",
                           "sim-chaos-storm.json")) as fh:
        want = fh.read()
    by_path = {}
    for kw in ({}, {"incremental_arena": False}):
        label = sim_label("chaos-storm", kw)
        run, h, launches, _ = sim_replay(
            torch, card, hook, "chaos-storm.yaml", 5400.0, label,
            exceptions=CHAOS_EXCEPTIONS, **kw)
        got = report_to_json(run.report)
        check(got == want, f"{label}: the report differs from "
                           f"tests/golden/sim-chaos-storm.json: {got[:3000]}")
        check(h.cluster.arena is None or h.cluster.arena.gathers[
            "fallback"] == 0, f"{label}: the arena refused a gather")
        log(f"[chaos] {label}: the golden matches; chaos section "
            f"{json.dumps(run.report['chaos'], sort_keys=True)}")
        by_path[label] = launches
    sc = load_scenario(os.path.join(REPO, "scenarios", "chaos-storm.yaml"))
    sc.chaos = None
    label = "sim-chaos-storm unarmed"
    _, _, unarmed, _ = sim_replay(torch, card, hook,
                                  "chaos-storm.yaml", 5400.0, label,
                                  scenario=sc)
    armed = by_path[CHAOS_PATH]
    log(f"[chaos] K7 ffd_scan launches: {armed['ffd_scan']} armed (the "
        f"demoted solves run the native packer), {unarmed['ffd_scan']} "
        f"unarmed; K1 {armed['classpack_precompute']} / "
        f"{unarmed['classpack_precompute']}, K5 {armed['classpack_sweep']} / "
        f"{unarmed['classpack_sweep']}")
    check(armed["ffd_scan"] > 0, "K7 did not launch on the chaos replay")
    return by_path


def join_watchdog_workers(timeout=300.0):
    """Wait out every watchdog worker the deadline abandoned, so none
    launches a kernel into the next step."""
    import threading
    for t in threading.enumerate():
        if t.name.startswith("watchdog:"):
            t.join(timeout)
            check(not t.is_alive(), f"{t.name} did not end")


def watchdog_trip(torch, card, device="cuda"):
    """16(c): provision-small-3x64 on the card with a 0.5 s solve deadline
    and a `solver.pack` hang of 2 s (a real sleep) on the "jax" rung of its
    first batch: the watchdog abandons the solve and books
    `jax>native:timeout`, the native packer answers, and every round equals
    GOLDEN_PROVISION (the K7 plans).  The abandoned worker is waited out
    before the next round."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.api.objects import NodePool
    from karpenter_tpu_torch.catalog.generate import generate_catalog
    from karpenter_tpu_torch.cloud import CloudProvider, FakeCloud
    from karpenter_tpu_torch.controllers.provisioning import Provisioner
    from karpenter_tpu_torch.ops.health import SolverHealth
    from karpenter_tpu_torch.state import Cluster
    from karpenter_tpu_torch.utils.chaos import CHAOS, ChaosRule
    health = SolverHealth()
    env = workloads.provision_env(
        SMALL_PATH, FakeCloud, CloudProvider, Cluster, Provisioner, NodePool,
        generate_catalog(workloads.PROVISION_TYPES), health=health,
        watchdog_timeout_s=0.5, device=device)
    CHAOS.configure([ChaosRule("solver.pack", key="jax", action="hang",
                               latency_s=2.0, count=1)], seed=0)
    try:
        gold = workloads.GOLDEN_PROVISION[SMALL_PATH]
        for r, (kw, seed) in enumerate(workloads.PROVISION_CELLS[SMALL_PATH][
                1]):
            env.cluster.add_pods(workloads.build_pods(
                rng=np.random.default_rng(seed), **kw))
            reset_all_launches()
            t0 = time.perf_counter()
            sig, _ = workloads.provision_pending(env)
            wall = time.perf_counter() - t0
            t1 = time.perf_counter()
            join_watchdog_workers()
            if device == "cuda":
                torch.cuda.synchronize()
            waited = time.perf_counter() - t1
            check(sig == gold[r], f"[watchdog] round {r + 1}: {sig} != "
                                  f"golden {gold[r]}")
            log(f"[watchdog] {SMALL_PATH} round {r + 1}: golden matches in "
                f"{wall:.3f} s wall (the abandoned worker then waited out "
                f"for {waited:.3f} s); transitions {health.transitions}; "
                f"K7 launches {all_launches()['ffd_scan']}")
            if r == 0:
                check(0.5 <= wall < 2.0, f"[watchdog] round 1 took "
                                         f"{wall:.3f} s: no trip at 0.5 s")
    finally:
        CHAOS.reset()
    check(health.transitions == {"jax>native:timeout": 1},
          f"[watchdog] transitions {health.transitions}")
    check(CHAOS.fired_total() == 0, "the injector was not disarmed")


class raise_once:
    """While open, the next call of `module.name` raises KernelError (the
    ones after it run the wrapper unchanged); `calls` counts them."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        from karpenter_tpu_torch._build import KernelError
        self.orig = getattr(self.module, self.name)

        def faulty(*a, **k):
            self.calls += 1
            if self.calls == 1:
                raise KernelError(f"{self.name}: injected launch fault")
            return self.orig(*a, **k)
        setattr(self.module, self.name, faulty)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def kernel_faults(torch, card, device="cuda"):
    """16(d): the disruption cell built on the card with one SolverHealth
    (and a 30 s deadline) for its Provisioner and DisruptionController,
    both under a ControllerManager, and a chaos schedule armed that does
    not fire on these paths.  K5 raises KernelError once in a
    consolidation sweep (ticks 30 s apart until one sweeps: the first three
    delete empty nodes, 100 a tick), then K1 once in a provisioning solve of 300 pods
    against the fleet: the tick must raise it, and neither the ladder nor
    a supervisor may book anything."""
    import threading
    from types import SimpleNamespace
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch._build import KernelError
    from karpenter_tpu_torch.api.objects import Pod
    from karpenter_tpu_torch.api.resources import CPU, MEMORY, ResourceList
    from karpenter_tpu_torch.catalog.generate import generate_catalog
    from karpenter_tpu_torch.operator import ControllerManager, Options
    from karpenter_tpu_torch.ops import classpack as cp
    from karpenter_tpu_torch.ops.health import SolverHealth
    from karpenter_tpu_torch.utils.chaos import CHAOS, ChaosRule
    from karpenter_tpu_torch.utils.events import Recorder
    clear_lp_caches()
    health = SolverHealth()
    env = workloads.disruption_env(
        workloads.port_kit(), generate_catalog(workloads.DISRUPTION_TYPES),
        health=health, watchdog_timeout_s=30.0, device=device)
    check(env.provisioner.health is env.disruption.health is health,
          "the ladder is not shared")
    op = SimpleNamespace(options=Options(), recorder=Recorder(log=False),
                         cluster=env.cluster, state_lock=threading.RLock(),
                         node_classes={})
    mgr = ControllerManager(op, {"provisioning": env.provisioner,
                                 "disruption": env.disruption},
                            clock=env.clock)
    CHAOS.configure([ChaosRule("solver.pack", key="native"),
                     ChaosRule("cloud.api", key="describe_instances",
                               rate=0.5, at_s=1e12)],
                    seed=0, clock=env.clock, sleep=lambda s: None)
    try:
        for what, name in (("K5 in a consolidation sweep", "classpack_sweep"),
                           ("K1 in a provisioning solve",
                            "classpack_precompute")):
            if name == "classpack_precompute":
                rng = np.random.default_rng(SEED)
                env.cluster.add_pods([Pod(requests=ResourceList({
                    CPU: int(rng.integers(200, 3000)),
                    MEMORY: int(rng.integers(256, 4096)) * 2**20}))
                    for _ in range(300)])
                env.clock.step(30.0)
                mgr.tick()                 # the batch window opens
                env.clock.step(2.0)        # ripe; disruption not yet due
            raised, ticks = None, 0
            with raise_once(cp, name) as fault:
                while raised is None and ticks < 6:
                    nodes = [(n.name, n.marked_for_deletion, len(n.pods))
                             for n in env.cluster.nodes.values()]
                    ticks += 1
                    try:
                        mgr.tick()
                    except KernelError as e:
                        raised = e
                    env.clock.step(30.0)
            join_watchdog_workers()
            check(raised is not None and name in str(raised),
                  f"[fault] {what}: tick() did not raise the KernelError "
                  f"({fault.calls} calls in {ticks} ticks)")
            check(not health.transitions and all(
                v["total_failures"] == 0
                for v in health.snapshot()["rungs"].values()),
                f"[fault] {what}: the ladder booked {health.snapshot()}")
            check(all(s.total_failures == 0 for s in mgr.supervisors.values()),
                  f"[fault] {what}: a supervisor booked it")
            check([(n.name, n.marked_for_deletion, len(n.pods))
                   for n in env.cluster.nodes.values()] == nodes,
                  f"[fault] {what}: the faulting tick changed the fleet")
            log(f"[fault] {what}: tick {ticks} raised "
                f"{type(raised).__name__} ({raised}) through the watchdog "
                f"worker, as expected; ladder and supervisors clean; chaos "
                f"armed, fired {CHAOS.fired_total()}; on {card}")
    finally:
        CHAOS.reset()


def phase16(torch, card, err, scans, recorded):
    """Phase 16, robustness: (a) the native packer against K7, (b) the
    chaos storm on the card, arena on and off, its wrappers held against
    plain, (c) a watchdog trip in wall time, (d) kernel faults under both
    ladders.  Returns the launches by path."""
    t0 = time.perf_counter()
    native_against_k7(torch, card, scans, recorded)
    log(f"[robust] 16(a) {time.perf_counter() - t0:.1f} s")
    hook = kernel_log(torch, spans=True)
    with wrapped_kernels(hook):
        by_path = chaos_storm(torch, card, hook)
    seen = hold_recorded(torch, hook.recorded, err, lambda label: label)
    for name, where in seen.items():
        log(f"[chaos] {name} on the {len(where)} inputs recorded on the "
            f"chaos replays (its last call on each): equal to plain — "
            f"{', '.join(where)}")
    log(f"[robust] 16(b) {time.perf_counter() - t0:.1f} s")
    watchdog_trip(torch, card)
    log(f"[robust] 16(c) {time.perf_counter() - t0:.1f} s")
    kernel_faults(torch, card)
    log(f"[robust] 16(d) {time.perf_counter() - t0:.1f} s")
    return by_path


# ---------------------------------------------------------------------------
# phase 17: forecast-driven headroom and gang scheduling
# ---------------------------------------------------------------------------

# the canned goldens with a gated forecast or gang section, at
# tests/test_sim.py's horizons: (name, scenario file, virtual seconds)
GATED_GOLDENS = (
    ("diurnal-forecast", "diurnal-forecast.yaml", 7200.0),
    ("spot-reclaim-storm-forecast", "spot-reclaim-storm-forecast.yaml",
     7200.0),
    ("gang-churn-storm", "gang-churn-storm.yaml", 7200.0),
    ("mixed-priority-diurnal", "mixed-priority-diurnal.yaml", 12600.0))
GANG_PATH = "provision-gang-5k"


def gated_goldens(torch, card, hook):
    """17(a): the four forecast and gang goldens replayed on the card (the
    arena on, the harness's default), each report byte for byte against
    tests/golden/.  Returns the launches by path."""
    from karpenter_tpu_torch.sim import report_to_json
    by_path = {}
    for name, fname, duration in GATED_GOLDENS:
        label = sim_label(name, {})
        run, _, launches, _ = sim_replay(torch, card, hook, fname, duration,
                                         label)
        with open(os.path.join(REPO, "tests", "golden",
                               f"sim-{name}.json")) as fh:
            want = fh.read()
        check(report_to_json(run.report) == want,
              f"{label}: the report differs from tests/golden/sim-{name}.json")
        section = "forecast" if "forecast" in run.report else "gang"
        log(f"[gated] {label}: golden matches; its {section} section "
            f"{json.dumps(run.report[section], sort_keys=True)}")
        by_path[label] = launches
    for name in ("classpack_precompute", "classpack_scan",
                 "classpack_assign_decode", "classpack_sweep", "ffd_scan"):
        check(sum(launches[name] for launches in by_path.values()) > 0,
              f"{name} did not launch in the forecast and gang replays")
    return by_path


def gang_cell(torch, card, hook, device="cuda"):
    """17(b): the gang cell on the card at `workloads.GANG_SMALL_SCALE`
    (a tenth of provision-gang-50k's pods and gangs, full width) — the
    port's Provisioner(gang_scheduling=True) with 8192 slots, the
    headline's burst with its gangs, then PROVISION_ROUND2's with its
    tier-2 hostname gangs, then one DisruptionController reconcile that
    executes the first queued preemption plan — against
    GOLDEN_GANG_SMALL.  Each round is counted
    (launches zeroed just before it), spanned, its kernel inputs kept, and
    timed with the gang audit (`_enforce_gangs`, host) beside the rest of
    the solve.  Returns the launches by step."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.catalog.generate import generate_catalog
    clear_lp_caches()
    env = workloads.gang_env(workloads.port_kit(),
                             generate_catalog(workloads.PROVISION_TYPES),
                             device=device)
    prov, by_path, audit = env.penv.provisioner, {}, []
    check(prov.device.type == device, "the gang cell is not on the card")
    orig = prov._enforce_gangs

    def timed_audit(*a, **k):
        t = time.perf_counter()
        try:
            return orig(*a, **k)
        finally:
            audit.append((time.perf_counter() - t) * 1e3)
    prov._enforce_gangs = timed_audit

    def counted(label, fn):
        hook.label = label
        hook.take_busy()
        reset_all_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        by_path[label] = all_launches()
        busy, calls = hook.take_busy()
        return out, wall, busy, calls

    def provision(penv):
        label = f"{GANG_PATH} round {len(by_path) + 1}"
        audit.clear()
        with layer_timer(torch, penv.provisioner) as acc:
            out, wall, busy, calls = counted(
                label, lambda: workloads.provision_pending(penv))
        sig, spent = out[0], sum(audit)
        log(f"[gang] {label}: {sig['launched']} launched, "
            f"{sig['bound_existing']} bound to existing nodes, "
            f"{sig['unschedulable']} unschedulable; launches "
            f"{ {k: v for k, v in by_path[label].items() if v} }")
        log(f"[time] {label}: provision() {wall:.3f} ms; solve "
            f"{acc['solve']:.3f} ms = gang audit {spent:.3f} ms (host, "
            f"{len(audit)} calls) + the rest {acc['solve'] - spent:.3f} "
            f"(pack {acc['pack']:.3f}); launch {wall - acc['solve']:.3f}; "
            f"{idle_line(busy, calls, wall)} on {card}")
        return out

    def tick():
        label = f"{GANG_PATH} tick"
        res, wall, busy, calls = counted(label, env.disruption.reconcile)
        log(f"[time] {label}: reconcile() {wall:.3f} ms, action "
            f"{res.action and [res.action.kind, res.action.reason]}; "
            f"{idle_line(busy, calls, wall) if calls else 'no kernel call'} "
            f"on {card}")
        return res
    got = workloads.gang_replay(env, workloads.build_pods,
                                provision=provision, tick=tick,
                                scale=workloads.GANG_SMALL_SCALE)
    hook.label = None
    check(got == workloads.GOLDEN_GANG_SMALL,
          f"{GANG_PATH}: {json.dumps(got)[:3000]} != GOLDEN_GANG_SMALL")
    for r in (1, 2):
        for name in ("classpack_precompute", "classpack_scan",
                     "classpack_assign_decode"):
            check(by_path[f"{GANG_PATH} round {r}"][name] > 0,
                  f"{name} did not launch in {GANG_PATH} round {r}")
    log(f"[gang] {GANG_PATH} reproduces GOLDEN_GANG_SMALL on {card}: audits "
        f"{[r['audits'] for r in got['rounds']]}, plans "
        f"{[r['plans'] for r in got['rounds']]}, the tick evicted "
        f"{len(got['tick']['evicted'])} pods; registry {got['registry']}")
    return by_path


def _seed_small_cloud(op):
    from karpenter_tpu_torch.cloud.fake import (ImageInfo, SecurityGroupInfo,
                                                SubnetInfo)
    op.cloud.subnets = [SubnetInfo("s-a", "zone-a", 10_000, {}),
                        SubnetInfo("s-b", "zone-b", 10_000, {})]
    op.cloud.security_groups = [SecurityGroupInfo("sg", "nodes", {})]
    op.cloud.images = [ImageInfo("img-1", "std", "amd64", 1.0)]
    op.params.parameters = {
        "/karpenter-tpu/images/standard/1.28/amd64/latest": "img-1"}
    return op


def small_operator(gates, clock, device, pools=None, snapshot_path="",
                   leader=None):
    """An Operator with `gates` on over a 10-type catalog, its fake cloud
    seeded, on `device`, with its ControllerManager on `clock` (and
    `leader`, a LeaderElector, if given)."""
    from karpenter_tpu_torch.catalog.generate import generate_catalog
    from karpenter_tpu_torch.operator import (ControllerManager, Operator,
                                              Options, build_controllers)
    opts = Options(interruption_queue="q", snapshot_path=snapshot_path)
    for g in gates:
        opts.feature_gates[g] = True
    op = _seed_small_cloud(Operator(opts, catalog=generate_catalog(10),
                                    clock=clock, device=device))
    if pools is not None:
        op.nodepools.clear()
        op.nodepools.update({p.name: p for p in pools})
    mgr = ControllerManager(op, build_controllers(op), clock=clock,
                            leader=leader)
    return op, mgr


def cluster_state(cluster):
    return sorted((p.uid, p.node_name) for p in cluster.pods.values())


class raised_through:
    """While open, `obj.name` is wrapped: every exception that leaves it is
    kept in `self.raised` (and raised on), so a check can tell that a fault
    passed through that call and not through another."""

    def __init__(self, obj, name):
        self.obj, self.name, self.raised = obj, name, []

    def __enter__(self):
        orig = getattr(self.obj, self.name)

        def through(*a, **k):
            try:
                return orig(*a, **k)
            except BaseException as e:
                self.raised.append(e)
                raise
        setattr(self.obj, self.name, through)
        return self

    def __exit__(self, *exc):
        delattr(self.obj, self.name)       # the instance's own wrapper


def armed_fault(torch, what, mgr, arm, booked, site):
    """One tick() with KernelError armed (`arm()`: a context that makes
    the next launch of K1 or K7 raise) around one controller's work: the
    tick must raise it, the fault must have left through `site` (a
    `raised_through`, open around the tick), `booked()` (the cluster, the
    controller's own books) must be as it was, and no supervisor or ladder
    may book it."""
    from karpenter_tpu_torch._build import KernelError
    health = mgr.controllers["provisioning"].health
    before = (booked(), health.snapshot())
    raised = None
    with site, arm() as faults:
        try:
            mgr.tick()
        except KernelError as e:
            raised = e
    check(raised is not None, f"[fault] {what}: tick() did not raise the "
                              f"KernelError ({faults.calls} launches armed)")
    check(any(e is raised for e in site.raised),
          f"[fault] {what}: the KernelError did not leave through "
          f"{type(site.obj).__name__}.{site.name} ({site.raised})")
    check(booked() == before[0], f"[fault] {what}: the faulting tick "
                                 f"booked something")
    check(health.snapshot() == before[1] and not health.transitions,
          f"[fault] {what}: the ladder booked it: {health.snapshot()}")
    check(all(s.total_failures == 0 for s in mgr.supervisors.values()),
          f"[fault] {what}: a supervisor booked it")
    log(f"[fault] {what}: tick() raised {type(raised).__name__} ({raised}) "
        f"through {type(site.obj).__name__}.{site.name}; cluster, books, "
        f"ladder and supervisors as they were")


class fault_on_launch:
    """While open, the next launch of K1 (`classpack_precompute`) or K7
    (`ffd_scan`), whichever comes first, raises KernelError."""

    def __init__(self):
        import karpenter_tpu_torch.ops.classpack as cp
        import karpenter_tpu_torch.ops.ffd_kernels as fk
        self.sites = [(cp, "classpack_precompute"), (fk, "ffd_scan")]
        self.calls = 0

    def __enter__(self):
        from karpenter_tpu_torch._build import KernelError
        self.saved = [(m, n, getattr(m, n)) for m, n in self.sites]
        for m, n, orig in self.saved:
            def faulty(*a, _n=n, _orig=orig, **k):
                self.calls += 1
                if self.calls == 1:
                    raise KernelError(f"{_n}: injected launch fault")
                return _orig(*a, **k)
            setattr(m, n, faulty)
        return self

    def __exit__(self, *exc):
        for m, n, orig in self.saved:
            setattr(m, n, orig)


def headroom_fault(torch, card, device="cuda"):
    """17(d), forecast: an operator with the Forecast gate (EWMA, 30 s
    cadence) whose demand class "web" ramps up bucket by bucket, bound as
    it comes; then a tick with no pod pending and every other controller
    held back, so the only solve is the HeadroomController's dry run, with
    KernelError armed.  The tick must raise it out of that solve
    (`_within_budget`), with one more reconcile counted, no placeholder
    admitted and the controller's other books unchanged."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.api.objects import Pod
    from karpenter_tpu_torch.api.resources import CPU, MEMORY, ResourceList
    from karpenter_tpu_torch.forecast import is_headroom
    clear_lp_caches()
    clock = workloads.SteppedClock(1000.0)
    op, mgr = small_operator(("Forecast",), clock, device)
    fc = mgr.controllers["forecast"]
    n = 0
    for step in range(8):
        op.cluster.add_pods([Pod(labels={"sim.karpenter.sh/wave": "web"},
                                 requests=ResourceList({CPU: 500,
                                                        MEMORY: 2**29}))
                             for _ in range(2 + 2 * step)])
        n += 2 + 2 * step
        for _ in range(30):
            mgr.tick()
            clock.step(2.0)
    while op.cluster.pending_pods():
        mgr.tick()
        clock.step(2.0)
    entry = next(e for e in mgr._entries if e.name == "forecast")
    clock.t = entry.last_run + entry.interval
    for e in mgr._entries:                 # the forecast reconcile alone
        if e is not entry:
            e.last_run = clock()
    check(not op.cluster.pending_pods(), "[fault] forecast: pods pending")
    reconciles = fc.stats["reconciles"]

    def books():
        return (cluster_state(op.cluster),
                {k: v for k, v in fc.stats.items() if k != "reconciles"},
                sorted(p.name for p in op.cluster.pods.values()
                       if is_headroom(p)))
    armed_fault(torch, "KernelError in the HeadroomController's dry-run "
                "solve", mgr, fault_on_launch, books,
                raised_through(fc, "_within_budget"))
    check(fc.stats["reconciles"] == reconciles + 1,
          f"[fault] forecast: {fc.stats['reconciles'] - reconciles} "
          f"reconciles in the faulting tick, not 1")
    log(f"[fault] forecast: {n} real pods, stats {fc.stats}; on {card}")


def preemption_fault(torch, card, device="cuda"):
    """17(d), gangs: an operator with the GangScheduling gate whose one
    NodePool is capped at 16 vCPU; tier-0 pods fill it, a tier-1 gang of
    two 1.5-vCPU members arrives and is rejected (no room, no new node),
    its preemption plan queued; the disruption tick evicts the plan's
    victims; then the preemption re-solve, with KernelError armed around
    the provisioner: the tick must raise it and leave the cluster, the
    gang registry and the plan queue as they were."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.api.objects import NodePool, Pod
    from karpenter_tpu_torch.api.resources import CPU, MEMORY, ResourceList
    clear_lp_caches()
    clock = workloads.SteppedClock(1000.0)
    pool = NodePool(limits=ResourceList({CPU: 16_000}))
    op, mgr = small_operator(("GangScheduling",), clock, device,
                             pools=[pool])
    prov = mgr.controllers["provisioning"]
    disruption = next(e for e in mgr._entries if e.name == "disruption")

    def settle(ticks=4):
        for _ in range(ticks):
            disruption.last_run = clock()      # held back until asked
            mgr.tick()
            clock.step(2.0)
    op.cluster.add_pods([Pod(requests=ResourceList({CPU: 1000,
                                                    MEMORY: 2**30}))
                         for _ in range(15)])
    settle()
    op.cluster.add_pods([Pod(requests=ResourceList({CPU: 1500,
                                                    MEMORY: 2**30}),
                             gang_name="trainer", gang_size=2, gang_tier=1)
                         for _ in range(2)])
    settle()
    rec = prov.gang_registry.get("trainer")
    check(rec is not None and not rec.admitted and
          "trainer" in prov.gang_preemption_plans,
          f"[fault] the gang was not rejected with a plan: "
          f"{rec and rec.to_dict()}, plans {list(prov.gang_preemption_plans)}")
    disruption.last_run = clock() - disruption.interval
    mgr.tick()                           # the disruption tick preempts
    check(prov.gang_registry.get("trainer").preempted > 0 and
          "trainer" not in prov.gang_preemption_plans,
          "[fault] the disruption tick preempted no victim")
    clock.step(2.0)
    disruption.last_run = clock()
    mgr.tick()                           # the batch window opens
    clock.step(2.0)                      # ripe: the re-solve is next

    pending = {p.gang_name for p in op.cluster.pending_pods()}
    check("trainer" in pending, f"[fault] the gang is not pending for the "
                                f"re-solve: {pending}")

    def books():
        return (cluster_state(op.cluster), prov.gang_registry.summary(),
                list(prov.gang_preemption_plans))
    armed_fault(torch, "KernelError in the preemption re-solve", mgr,
                fault_on_launch, books, raised_through(prov, "solve"))
    log(f"[fault] gangs: registry {prov.gang_registry.summary()}; on {card}")


def phase17(torch, card, err, device="cuda"):
    """Phase 17, forecast-driven headroom and gang scheduling: (a) the four
    gated goldens on the card, (b) the gang cell at a tenth of its depth
    against GOLDEN_GANG_SMALL,
    (c) every kernel wrapper those paths launched held against its plain
    version on the inputs of its last call on each path, (d) a KernelError
    in the HeadroomController's solve and in a preemption re-solve.
    Returns the launches by path."""
    t0 = time.perf_counter()
    hook = kernel_log(torch, spans=True)
    with wrapped_kernels(hook):
        by_path = gated_goldens(torch, card, hook)
        log(f"[gated] 17(a) {time.perf_counter() - t0:.1f} s")
        by_path.update(gang_cell(torch, card, hook, device))
        log(f"[gang] 17(b) {time.perf_counter() - t0:.1f} s")
    seen = hold_recorded(torch, hook.recorded, err, lambda label: label)
    for name, where in seen.items():
        log(f"[gated] {name} on the {len(where)} inputs recorded on phase "
            f"17's paths (its last call on each; first argument's shape): "
            f"equal to plain — {', '.join(where)}")
    for path, launches in by_path.items():
        log(f"[gated] launches on {path}: "
            f"{ {k: v for k, v in launches.items() if v} }")
    log(f"[gated] 17(c) {time.perf_counter() - t0:.1f} s")
    headroom_fault(torch, card, device)
    preemption_fault(torch, card, device)
    log(f"[gated] 17(d) {time.perf_counter() - t0:.1f} s")
    return by_path


# ---------------------------------------------------------------------------
# phase 18: durability and HA
# ---------------------------------------------------------------------------

FAILOVER = ("failover-drill", "failover-drill.yaml", 5400.0)
RESTART_PATH = "operator-restart-5k-2k"
# the kernels the failover drill's lines name (its launches of each)
DRILL_KERNELS = ("classpack_precompute", "classpack_scan",
                 "classpack_assign_decode", "classpack_sweep", "ffd_scan")


def failover_drill(torch, card, hook):
    """18(a): scenarios/failover-drill.yaml (seed 0, 5400 s) on the card —
    the HAFailover gate with a virtual-clock LeaderElector, a lease
    blackout and a flaky window — with the arena on, then off, each report
    byte for byte against tests/golden/sim-failover-drill.json, with its
    wall, ticks, launches and idle share (`sim_replay`).  Returns the
    launches by path."""
    from karpenter_tpu_torch.sim import report_to_json
    name, fname, duration = FAILOVER
    with open(os.path.join(REPO, "tests", "golden",
                           f"sim-{name}.json")) as fh:
        want = fh.read()
    by_path = {}
    for arena in (True, False):
        kw = {} if arena else {"incremental_arena": False}
        label = sim_label(name, kw)
        run, h, launches, wall = sim_replay(torch, card, hook, fname,
                                            duration, label, **kw)
        check(report_to_json(run.report) == want,
              f"{label}: the report differs from tests/golden/sim-{name}"
              f".json")
        check(h.leader is not None and h.mgr.fence is not None,
              f"{label}: no elector or fence in the manager")
        log(f"[ha] {label}: golden matches; its ha section "
            f"{json.dumps(run.report['ha'], sort_keys=True)}; launches of "
            f"K1, K2, K3, K5, K7 {[launches[k] for k in DRILL_KERNELS]}; "
            f"{wall:.3f} s wall on {card}")
        by_path[label] = launches
    check(sum(sum(launches[k] for k in DRILL_KERNELS)
              for launches in by_path.values()) > 0,
          "the failover drill launched no kernel")
    return by_path


def successor(path, card) -> int:
    """18(b)'s successor, run as a fresh Python process (`python3 -c
    "import chip_smoke; chip_smoke.successor(path, card)"`): the kernels
    the parent built are loaded from build/ (none rebuilt), the operator
    cell is built anew on the card with the WarmRestart gate and restores
    the parent's round-1 snapshot, then runs round 2 and the disruption
    tick — each counted (launches zeroed just before it), spanned and its
    kernel inputs recorded, round 2 with its split and its count of
    `Cluster.tensorize_nodes` calls (cold gathers) — against
    GOLDEN_OPERATOR_SMALL's round 2 and tick; every recorded K1, K2, K3
    input is
    then held against the plain versions.  Prints its lines, then one
    `SUCCESSOR {json}` line; a failed check exits 1."""
    import torch
    from karpenter_tpu_torch import _build, workloads
    from karpenter_tpu_torch.state import cluster as cluster_mod
    from karpenter_tpu_torch.state.snapshot import restore_snapshot
    check(torch.cuda.is_available(), "the successor sees no card")
    srcs = sorted(_build.CSRC.glob("*.cu"))
    unbuilt = [src.name for src in srcs if not _build._target(src).exists()]
    check(not unbuilt, f"the successor found {unbuilt} unbuilt in build/")
    t0 = time.perf_counter()
    env = workloads.operator_env(operator_kit(path), device="cuda")
    build_ms = (time.perf_counter() - t0) * 1e3
    arena = env.op.cluster.arena
    t0 = time.perf_counter()
    with env.op.state_lock:
        outcome = restore_snapshot(path, env.op)
    restore_ms = (time.perf_counter() - t0) * 1e3
    check(outcome == "restored", f"the successor's restore: {outcome}")
    log(f"[restart] successor: Operator(Options()) with the WarmRestart "
        f"gate built in {build_ms:.3f} ms; restore {outcome} in "
        f"{restore_ms:.3f} ms on the host ({len(env.op.cluster.pods)} pods, "
        f"{len(env.op.cluster.nodes)} nodes, arena epoch {arena.epoch}); "
        f"the kernels loaded from build/ ({len(srcs)} libraries, none "
        f"rebuilt)")
    hook = kernel_log(torch, spans=True)
    by_path, stats = {}, {}
    cold, orig = [0], cluster_mod.Cluster.tensorize_nodes

    def counting(self, *a, **k):
        cold[0] += 1
        return orig(self, *a, **k)

    def counted(label, fn):
        g0 = dict(arena.gathers)
        hook.label = label
        hook.take_busy()
        reset_all_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        by_path[label] = all_launches()
        busy, calls = hook.take_busy()
        check(arena.gathers["fallback"] == g0["fallback"],
              f"{label}: the arena refused a gather")
        return out, wall, busy, calls, arena.gathers["warm"] - g0["warm"]

    def provision(penv):
        label = f"{RESTART_PATH} round 2"
        cluster_mod.Cluster.tensorize_nodes = counting
        try:
            with layer_timer(torch, penv.provisioner) as acc:
                out, wall, busy, calls, warm = counted(
                    label, lambda: workloads.provision_pending(penv))
        finally:
            cluster_mod.Cluster.tensorize_nodes = orig
        stats.update(round2_ms=wall, cold=cold[0], warm=warm,
                     round2_idle=1 - busy / wall)
        log(f"[restart] {label}: {out[0]['launched']} launched, "
            f"{out[0]['bound_existing']} bound to existing nodes; {warm} "
            f"warm gathers, {cold[0]} cold (tensorize_nodes calls); "
            f"launches { {k: v for k, v in by_path[label].items() if v} }")
        log(f"[time] {label}: provision() {wall:.3f} ms "
            f"({layer_line(acc, wall)}); {idle_line(busy, calls, wall)} "
            f"on {card}")
        return out

    def tick():
        label = f"{RESTART_PATH} tick"
        res, wall, busy, calls, warm = counted(
            label, env.controllers["disruption"].reconcile)
        stats.update(tick_ms=wall)
        log(f"[restart] {label}: action {res.action and res.action.kind}, "
            f"{warm} warm gathers; launches "
            f"{ {k: v for k, v in by_path[label].items() if v} }")
        log(f"[time] {label}: reconcile() {wall:.3f} ms; "
            f"{idle_line(busy, calls, wall) if calls else 'no kernel call'} "
            f"on {card}")
        return res
    with wrapped_kernels(hook):
        got = workloads.operator_replay(env, workloads.build_pods,
                                        provision=provision, tick=tick,
                                        rounds=workloads
                                        .OPERATOR_SMALL_ROUNDS[1:])
    hook.label = None
    want = workloads.GOLDEN_OPERATOR_SMALL
    check(got["rounds"][0] == want["rounds"][1],
          f"{RESTART_PATH} round 2: {got['rounds'][0]} != "
          f"GOLDEN_OPERATOR_SMALL's {want['rounds'][1]}")
    check(got["tick"] == want["tick"], f"{RESTART_PATH} tick: "
                                       f"{got['tick']} != {want['tick']}")
    check(stats["cold"] == 0 and stats["warm"] >= 1,
          f"{RESTART_PATH}: the first gather was not warm ({stats})")
    for name in ("classpack_precompute", "classpack_scan",
                 "classpack_assign_decode"):
        check(by_path[f"{RESTART_PATH} round 2"][name] > 0,
              f"{name} did not launch in the successor's round 2")
    err = {name: 0.0 for _, _, name in DISRUPTION_WRAPPERS}
    seen = hold_recorded(torch, hook.recorded, err, lambda label: label)
    check({"classpack_precompute", "classpack_scan",
           "classpack_assign_decode"} <= set(seen),
          f"the successor recorded no K1, K2 or K3 input: {sorted(seen)}")
    for name, where in seen.items():
        log(f"[restart] {name} on the {len(where)} inputs the successor "
            f"recorded: equal to plain — {', '.join(where)}")
    print("SUCCESSOR " + json.dumps(dict(
        outcome=outcome, restore_ms=restore_ms, build_ms=build_ms,
        launches=by_path, err=err, held={k: len(v) for k, v in seen.items()},
        **stats)), flush=True)
    return 0


def object_types(obj):
    """The qualified type names reachable from `obj` through containers and
    object attributes (the check that a snapshot holds host data only)."""
    seen, out, todo = set(), set(), [obj]
    while todo:
        x = todo.pop()
        if id(x) in seen:
            continue
        seen.add(id(x))
        t = type(x)
        out.add(f"{t.__module__}.{t.__qualname__}")
        if isinstance(x, dict):
            todo.extend(x.keys())
            todo.extend(x.values())
        elif isinstance(x, (list, tuple, set, frozenset)):
            todo.extend(x)
        elif isinstance(x, np.ndarray):
            if x.dtype == object:
                todo.extend(x.ravel().tolist())
        elif hasattr(x, "__dict__") and not isinstance(x, type):
            todo.extend(vars(x).values())
    return out


def warm_restart(torch, card, snap, err):
    """18(b): the successor (`successor`) in a fresh Python process on the
    card, restoring phase 14(c)'s round-1 snapshot of the operator cell;
    its restore must be "restored", its first gather warm, its round 2 and
    tick GOLDEN_OPERATOR_SMALL's, its recorded kernel inputs equal to
    plain.
    Its provision() ms is printed beside phase 14's uninterrupted round 2.
    Returns the successor's launches by path."""
    from karpenter_tpu_torch.state.snapshot import load_sections
    check("bytes" in snap and "round2_ms" in snap,
          f"phase 14(c) wrote no snapshot: {snap}")
    sections, reason = load_sections(snap["path"])
    check(reason == "ok", f"phase 14(c)'s snapshot does not load: {reason}")
    tensors = sorted(t for t in object_types(sections)
                     if t.startswith("torch."))
    check(not tensors, f"the snapshot holds {tensors}")
    log(f"[restart] the snapshot's sections {sorted(sections)} hold host "
        f"data only (no torch type among {len(object_types(sections))})")
    del sections
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.successor(sys.argv[1], sys.argv[2]))",
         snap["path"], card], cwd=REPO, capture_output=True, text=True,
        timeout=900)
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    for line in lines:
        if not line.startswith("SUCCESSOR "):
            log(line)
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
        fail(f"the successor process exited {proc.returncode}")
    got = json.loads(next(ln for ln in lines
                          if ln.startswith("SUCCESSOR "))[len("SUCCESSOR "):])
    check(got["outcome"] == "restored" and got["cold"] == 0,
          f"the successor: {got['outcome']}, {got['cold']} cold gathers")
    for name, d in got["err"].items():
        err[name] = max(err[name], d)
    log(f"[restart] {RESTART_PATH}: snapshot {snap['bytes']} bytes, written "
        f"in {snap['write_ms']:.3f} ms (host, under the state lock); the "
        f"successor process {wall:.1f} s: restore {got['outcome']} in "
        f"{got['restore_ms']:.3f} ms, {got['cold']} cold gathers, round 2 "
        f"provision() {got['round2_ms']:.3f} ms beside phase 14's "
        f"uninterrupted {snap['round2_ms']:.3f} ms, tick "
        f"{got['tick_ms']:.3f} ms; GOLDEN_OPERATOR_SMALL's round 2 and tick; "
        f"on {card}")
    return got["launches"]


def small_pods(n, cpu_m=500):
    from karpenter_tpu_torch.api.objects import Pod
    from karpenter_tpu_torch.api.resources import CPU, MEMORY, ResourceList
    return [Pod(requests=ResourceList({CPU: cpu_m, MEMORY: 2**29}))
            for _ in range(n)]


def file_digest(path):
    import hashlib
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def fence_refusals(torch, card, device="cuda"):
    """18(c): an HAFailover + WarmRestart operator leading through a lease
    (TTL 5 s) provisions six pods and snapshots; a rival acquires the
    expired lease.  The deposed replica's tick is skipped whole, and its
    snapshot write, launch and terminate are refused — the write returns
    False, `CloudProvider.create` / `delete` raise StaleFenceError — with
    the snapshot's bytes, the running instances and the claims as they
    were, and `LeaseFence.refusals` counting each operation once."""
    import tempfile
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.operator.manager import LeaderElector
    from karpenter_tpu_torch.utils.fencing import StaleFenceError
    clear_lp_caches()
    with tempfile.TemporaryDirectory() as d:
        snap, lease = os.path.join(d, "s.bin"), os.path.join(d, "ha.lease")
        clock = workloads.SteppedClock(1000.0)
        op, mgr = small_operator(
            ("WarmRestart", "HAFailover"), clock, device, snapshot_path=snap,
            leader=LeaderElector(lease, "alpha", ttl=5.0, clock=clock))
        op.cluster.add_pods(small_pods(6))
        mgr.tick()
        clock.step(1.1)
        mgr.tick()
        check(op.cluster.nodes and not op.cluster.pending_pods()
              and os.path.exists(snap) and mgr.phase == "LEADING",
              "[fence] the leader did not provision and snapshot")
        epoch = mgr.leader.fence_epoch()
        rival = LeaderElector(lease, "rival", ttl=5.0, clock=clock)
        clock.step(6.0)
        check(rival.try_acquire(), "[fence] the rival did not acquire")
        before = (file_digest(snap), sorted(i.id for i in op.cloud.running()),
                  sorted(op.cluster.nodeclaims))
        check(mgr.tick() == {} and mgr.phase == "STANDBY",
              "[fence] the deposed replica's tick was not skipped")
        claims = [c for c in op.cloud_provider.list() if c.provider_id]
        wrote = mgr._snapshotter.write_final()
        raised = []
        for what, call in (("launch", op.cloud_provider.create),
                           ("terminate", op.cloud_provider.delete)):
            try:
                call(claims[0])
            except StaleFenceError as e:
                raised.append((what, str(e)))
        after = (file_digest(snap), sorted(i.id for i in op.cloud.running()),
                 sorted(op.cluster.nodeclaims))
        check(not wrote and [w for w, _ in raised] == ["launch", "terminate"],
              f"[fence] deposed writes not refused: wrote {wrote}, raised "
              f"{raised}")
        check(after == before, "[fence] a refused write changed the "
                               "snapshot, the instances or the claims")
        check(mgr.fence.refusals == {"snapshot": 1, "launch": 1,
                                     "terminate": 1},
              f"[fence] refusals {mgr.fence.refusals}")
        log(f"[fence] epoch {epoch} deposed by the rival's epoch "
            f"{rival.fence_epoch()}: tick skipped ({mgr._skipped_ticks} "
            f"skipped, phase {mgr.phase}); snapshot write refused, "
            f"{'; '.join(f'{w}: StaleFenceError' for w, _ in raised)}; "
            f"nothing written, launched or deleted "
            f"({len(before[1])} instances); refusals "
            f"{json.dumps(mgr.fence.refusals, sort_keys=True)}; elector "
            f"acquisitions / losses / releases {mgr.leader.acquisitions} / "
            f"{mgr.leader.losses} / {mgr.leader.releases}; on {card}")


def restart_fault(torch, card, device="cuda"):
    """18(d): a WarmRestart operator provisions six pods, then four more
    arrive and its batch window opens; its final snapshot holds them
    pending.  A successor restores it (`startup()`: "restored", parity
    probe "ok") and its first tick solves them with KernelError armed on
    the next K1 or K7 launch: tick() must raise it out of
    `Provisioner.solve`, with no snapshot written for that tick (the file
    keeps its bytes, the writer counts no write), no lease error, and
    nothing booked by the ladder or a supervisor.  The next tick solves
    and writes."""
    import tempfile
    from karpenter_tpu_torch import workloads
    clear_lp_caches()
    with tempfile.TemporaryDirectory() as d:
        snap = os.path.join(d, "s.bin")
        clock = workloads.SteppedClock(1000.0)
        op, mgr = small_operator(("WarmRestart",), clock, device,
                                 snapshot_path=snap)
        op.cluster.add_pods(small_pods(6))
        mgr.tick()
        clock.step(1.1)
        mgr.tick()
        op.cluster.add_pods(small_pods(4, cpu_m=3900))
        clock.step(1.0)
        mgr.tick()                       # the window opens, not yet ripe
        check(len(op.cluster.pending_pods()) == 4,
              "[fault] restart: the new pods did not wait in the window")
        check(mgr._snapshotter.write_final(), "[fault] restart: no final "
                                              "snapshot")
        op2, mgr2 = small_operator(("WarmRestart",), clock, device,
                                   snapshot_path=snap)
        outcome = mgr2.startup()
        check(outcome == "restored" and mgr2.probe_outcome == "ok",
              f"[fault] restart: startup {outcome}, probe "
              f"{mgr2.probe_outcome}")
        clock.step(1.1)
        prov = mgr2.controllers["provisioning"]
        digest = file_digest(snap)

        def books():
            return (cluster_state(op2.cluster), file_digest(snap),
                    dict(mgr2._snapshotter.writes), mgr2._lease_errors)
        armed_fault(torch, "KernelError in the restored successor's first "
                    "solve", mgr2, fault_on_launch, books,
                    raised_through(prov, "solve"))
        check(file_digest(snap) == digest and not mgr2._snapshotter.writes,
              "[fault] restart: the faulting tick wrote a snapshot")
        mgr2.tick()
        check(not op2.cluster.pending_pods()
              and mgr2._snapshotter.writes == {"ok": 1}
              and file_digest(snap) != digest,
              f"[fault] restart: the next tick did not solve and write "
              f"({len(op2.cluster.pending_pods())} pending, writes "
              f"{mgr2._snapshotter.writes})")
        log(f"[fault] restart: the successor restored {len(op2.cluster.pods)} "
            f"pods; its faulting tick wrote nothing, the next bound the "
            f"4 pods and wrote the snapshot; on {card}")


def phase18(torch, card, err, snap):
    """Phase 18, durability and HA: (a) the failover drill on the card,
    arena on and off, against its golden, with every kernel wrapper held
    against plain on its recorded inputs; (b) the warm restart at full
    width in a fresh process; (c) the fence; (d) a device fault in the
    restored successor's first solve.  Returns the launches by path."""
    t0 = time.perf_counter()
    hook = kernel_log(torch, spans=True)
    with wrapped_kernels(hook):
        by_path = failover_drill(torch, card, hook)
    seen = hold_recorded(torch, hook.recorded, err, lambda label: label)
    for name, where in seen.items():
        log(f"[ha] {name} on the {len(where)} inputs recorded in the "
            f"failover drill (its last call in each run): equal to plain — "
            f"{', '.join(where)}")
    log(f"[ha] 18(a) {time.perf_counter() - t0:.1f} s")
    by_path.update(warm_restart(torch, card, snap, err))
    log(f"[restart] 18(b) {time.perf_counter() - t0:.1f} s")
    fence_refusals(torch, card)
    restart_fault(torch, card)
    log(f"[fence] 18(c, d) {time.perf_counter() - t0:.1f} s")
    return by_path


# ---------------------------------------------------------------------------
# phase 19: metrics and tracing
# ---------------------------------------------------------------------------

# tracing's cost on the two timed paths, filled as they run (the live
# cell's round 2 inside phase 10, where its state is)
TRACE_COST = {}
TRACE_PAIRS = 2     # the live round-2 solve's pairs (5 before phase 21)
PROVISION_19 = "trace-provision-5k"
TICK_19 = "trace-consolidation-tick"


def tracing_cost(torch, card, what, fn, ok, pairs=TRACE_PAIRS):
    """`fn()` with the tracer on and off in turns (on/off, then off/on),
    `pairs` runs of each after one warm call; `ok(result)` must hold for
    every run.  Logs and keeps the two p50s and the overhead."""
    from karpenter_tpu_torch.utils import tracing
    tr = tracing.TRACER
    ok(fn())
    torch.cuda.synchronize()
    xs = {True: [], False: []}
    try:
        for i in range(pairs):
            for on in ((True, False) if i % 2 == 0 else (False, True)):
                tr.enabled = on
                t0 = time.perf_counter()
                res = fn()
                torch.cuda.synchronize()
                xs[on].append((time.perf_counter() - t0) * 1e3)
                ok(res)
    finally:
        tr.enabled = True
    on, off = statistics.median(xs[True]), statistics.median(xs[False])
    pct = (on - off) / off * 100.0
    # the tracer's own work: the spans one run opens, times one span's
    # measured host cost (open, annotate, close, histogram observe)
    tr.reset()
    fn()
    n_spans = sum(_count_spans(t) for t in tr.traces())
    tr.reset()
    reps = 20_000
    t0 = time.perf_counter()
    for _ in range(reps):
        with tracing.span("trace.cost.probe") as sp:
            sp.annotate(device_calls=1)
    per_span_us = (time.perf_counter() - t0) / reps * 1e6
    tr.reset()
    accounted = n_spans * per_span_us / 1e3 / off * 100.0
    TRACE_COST[what] = {"on_p50_ms": on, "off_p50_ms": off,
                        "overhead_pct": pct, "spans": n_spans,
                        "us_per_span": per_span_us,
                        "accounted_pct": accounted}
    log(f"[trace-cost] {what}: tracer on p50 {on:.3f} ms, off p50 "
        f"{off:.3f} ms over {pairs} pairs (on {', '.join(f'{x:.1f}' for x in xs[True])}; "
        f"off {', '.join(f'{x:.1f}' for x in xs[False])}), overhead "
        f"{pct:.2f}%; the tracer's own work: {n_spans} spans a run x "
        f"{per_span_us:.3f} us = {accounted:.4f}% of the off p50, on {card}")


def _count_spans(t):
    return 1 + sum(_count_spans(c) for c in t["children"])


class span_launches:
    """A `wrapped_kernels` hook: each wrapper call's launch-count delta and
    CUDA-event time (wrapper entry to kernel end), keyed by the tracing
    span open at the call."""

    def __init__(self, torch):
        self.torch, self.calls = torch, []

    def __call__(self, name, a, k, call):
        from karpenter_tpu_torch.utils import tracing
        sp = tracing.TRACER.current()
        before = all_launches()
        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            return call()
        finally:
            end.record()
            after = all_launches()
            self.calls.append((sp.span_id if sp is not None else None,
                               {n: v - before.get(n, 0)
                                for n, v in after.items()
                                if v != before.get(n, 0)}, start, end))

    def by_span(self):
        """span id → {"launches": {...}, "ms": card ms}; synchronizes."""
        self.torch.cuda.synchronize()
        out = {}
        for sid, delta, start, end in self.calls:
            d = out.setdefault(sid, {"launches": {}, "ms": 0.0})
            for n, v in delta.items():
                d["launches"][n] = d["launches"].get(n, 0) + v
            d["ms"] += start.elapsed_time(end)
        self.calls.clear()
        return out


def _subtree(t, per_span):
    """(launches, card ms) of the kernels launched in `t`'s subtree."""
    mine = per_span.get(t["span_id"], {"launches": {}, "ms": 0.0})
    launches, ms = dict(mine["launches"]), mine["ms"]
    for c in t["children"]:
        cl, cm = _subtree(c, per_span)
        for n, v in cl.items():
            launches[n] = launches.get(n, 0) + v
        ms += cm
    return launches, ms


def check_span_tree(trace, per_span, what):
    """Each `solve.kernel` and sweep span lasts at least the card time of
    the kernels launched in it, and every `device_calls` annotation maps to
    its span's launch delta: a classpack program is one K1, one K2 and one
    K3 (K6 after it with the slab decode), a pod-granular scan one K7, a
    sweep call one K1 and one K5.  Returns the lines it checked."""
    lines = []

    def walk(t):
        ann = t["annotations"]
        launches, ms = _subtree(t, per_span)
        if t["name"] == "solve.kernel" or t["name"].startswith("sweep."):
            check(t["duration_ms"] >= ms,
                  f"{what}: span {t['name']} lasts {t['duration_ms']} ms, "
                  f"less than the {ms:.4f} ms of its kernels {launches}")
        if t["name"] == "solve.kernel":
            k = {n: v for n, v in launches.items() if n != "classpack_slab"}
            check(k == {"classpack_precompute": 1, "classpack_scan": 1,
                        "classpack_assign_decode": 1}
                  and launches.get("classpack_slab", 0) <= 1,
                  f"{what}: solve.kernel launched {launches}")
        if "device_calls" in ann:
            d = ann["device_calls"]
            if t["name"] == "solve.pack" and ann.get("solver") == "ffd":
                check(launches.get("ffd_scan", 0) == d,
                      f"{what}: ffd solve.pack device_calls {d}, launches "
                      f"{launches}")
            elif t["name"] in ("sweep.prefix", "sweep.single"):
                check(launches.get("classpack_sweep", 0) == d ==
                      launches.get("classpack_precompute", 0),
                      f"{what}: {t['name']} device_calls {d}, launches "
                      f"{launches}")
            else:
                # the classpack solve's annotation, on the span it ran in
                check(1 <= d <= launches.get("classpack_scan", 0),
                      f"{what}: {t['name']} device_calls {d}, launches "
                      f"{launches}")
            lines.append(f"{t['name']} device_calls={d} launches={launches} "
                         f"kernels {ms:.3f} ms of {t['duration_ms']:.3f} ms")
        elif t["name"] == "solve.kernel":
            lines.append(f"{t['name']} launches={launches} kernels "
                         f"{ms:.3f} ms of {t['duration_ms']:.3f} ms")
        for c in t["children"]:
            walk(c)
    walk(trace)
    return lines


def span_split(trace, depth=2):
    """`name ms` of a trace's spans to `depth` levels: the host-ms split
    by layer."""
    out = []

    def walk(t, d, pre):
        out.append(f"{pre}{t['name']} {t['duration_ms']:.3f}")
        if d < depth:
            for c in t["children"]:
                walk(c, d + 1, pre + "  ")
    walk(trace, 0, "")
    return "; ".join(x.strip() for x in out)


def traced_paths(torch, card):
    """Phase 19(b): one provisioning round (5000 headline pods on the
    600-type catalog, the default guided Provisioner) and one consolidation
    tick over the fleet it launched, thinned to one pod a node, on the
    card, each with the launch counts zeroed just before it; their span
    trees against the kernels' card time and launch counts.  Returns the
    launches by path."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.api.objects import Disruption, NodePool
    from karpenter_tpu_torch.controllers.disruption import \
        DisruptionController
    from karpenter_tpu_torch.catalog.generate import generate_catalog
    from karpenter_tpu_torch.cloud import CloudProvider, FakeCloud
    from karpenter_tpu_torch.controllers.provisioning import Provisioner
    from karpenter_tpu_torch.state import Cluster
    from karpenter_tpu_torch.utils import tracing
    by_path = {}
    clear_lp_caches()
    cluster = Cluster()
    cluster.add_pods(workloads.build_pods(
        rng=np.random.default_rng(SEED), **dict(workloads.HEADLINE,
                                                total=5000)))
    pools = [NodePool(disruption=Disruption(
        consolidation_policy="WhenUnderutilized"))]
    provider = CloudProvider(FakeCloud(), generate_catalog(
        workloads.PROVISION_TYPES))
    prov = Provisioner(provider, cluster, pools)
    ctrl = DisruptionController(provider, cluster, pools,
                                clock=lambda: time.time() + 10_000,
                                stabilization_s=0.0)

    def thin_and_tick():
        # under-utilize without emptying: one pod left on each node, so
        # the tick reaches the consolidation sweep
        keep = set()
        for p in sorted(cluster.pods.values(), key=lambda p: p.name):
            if p.node_name in keep:
                cluster.delete_pod(p)
            else:
                keep.add(p.node_name)
        return ctrl.reconcile()
    for path, run, root in ((PROVISION_19, prov.provision, "provision"),
                            (TICK_19, thin_and_tick,
                             "disruption.reconcile")):
        hook = span_launches(torch)
        tracing.TRACER.reset()
        reset_all_launches()
        with wrapped_kernels(hook):
            out = run()
            torch.cuda.synchronize()
        by_path[path] = {k: v for k, v in all_launches().items() if v}
        trace = tracing.TRACER.traces(span=root)[0]
        lines = check_span_tree(trace, hook.by_span(), path)
        check(lines, f"{path}: no span carries device_calls")
        log(f"[trace] {path}: {len(lines)} spans checked — "
            + " | ".join(lines))
        log(f"[trace] {path} host ms by span: {span_split(trace)} on {card}")
        if path == PROVISION_19:
            check(not out.unschedulable and out.launched,
                  f"{path}: {len(out.launched)} launched, "
                  f"{len(out.unschedulable)} unschedulable")
    return by_path


def http_get(port, path):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def served_scrape(device):
    """A small operator on `device` from fresh registries: two ticks that
    provision 40 pods, then its endpoints.  Returns (the /metrics family
    names, the provision trace, /debug/pprof's codes off and on)."""
    from karpenter_tpu_torch.api.objects import Pod
    from karpenter_tpu_torch.api.resources import CPU, MEMORY, ResourceList
    from karpenter_tpu_torch.utils import metrics, tracing
    metrics.REGISTRY.reset()
    tracing.TRACER.reset()
    clock = [100.0]
    op, mgr = small_operator((), lambda: clock[0], device)
    op.cluster.add_pods([Pod(requests=ResourceList(
        {CPU: 500, MEMORY: 512 * 2 ** 20})) for _ in range(40)])
    mgr.tick()
    clock[0] += 1.1
    mgr.tick()
    port = mgr.serve_endpoints(metrics_port=0)
    try:
        code, body = http_get(port, "/metrics")
        check(code == 200, f"/metrics on {device} answered {code}")
        families = sorted(ln.split()[2] for ln in body.decode().splitlines()
                          if ln.startswith("# TYPE "))
        code, body = http_get(port, "/debug/traces?span=provision")
        check(code == 200, f"/debug/traces on {device} answered {code}")
        traces = json.loads(body)["traces"]
        check(traces and traces[0]["name"] == "provision" and
              traces[0]["children"][0]["name"] == "provision.round",
              f"/debug/traces?span=provision on {device}: {traces[:1]}")
        off, _ = http_get(port, "/debug/pprof")
        op.options.enable_profiling = True
        on, body = http_get(port, "/debug/pprof")
        check(off == 403 and on == 200 and json.loads(body)["threads"],
              f"/debug/pprof on {device}: {off} off, {on} on")
        return families, traces[0], (off, on)
    finally:
        mgr.stop()



def span_sums():
    """The tracer's duration histogram read back: span name → [host ms
    summed, spans]."""
    from karpenter_tpu_torch.utils import metrics
    out = {}
    for name, kv, v in metrics.trace_span_duration().samples():
        acc = out.setdefault(dict(kv)["span"], [0.0, 0])
        if name.endswith("_sum"):
            acc[0] = v * 1e3
        elif name.endswith("_count"):
            acc[1] = int(v)
    return out


def span_line(sums):
    return ", ".join(f"{k} {ms:.3f} ({n})" for k, (ms, n) in
                     sorted(sums.items(), key=lambda x: -x[1][0]))


def whole_run_splits(torch, card, mega):
    """Phase 19(d): host ms by span summed over whole runs, from fresh
    registries: the long-soak replay at tests/test_sim.py's horizon (the
    loop; its report against tests/golden/sim-long-soak.json; the 480 s
    cell before phase 21 came) and the megafleet's three
    `solve_partitioned` modes (the sharded path)."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.parallel import solve_partitioned
    from karpenter_tpu_torch.sim import report_to_json
    from karpenter_tpu_torch.utils import metrics
    metrics.REGISTRY.reset()
    name, fname, duration = SIM_GOLDENS[-1]
    hook = kernel_log(torch, spans=True)
    with wrapped_kernels(hook):
        run, _, _, wall = sim_replay(torch, card, hook, fname, duration,
                                     f"trace sim-{name}")
    with open(os.path.join(REPO, "tests", "golden", f"sim-{name}.json")) as fh:
        check(report_to_json(run.report) == fh.read(),
              f"trace sim-{name}: the report differs from its golden")
    log(f"[trace] sim-{name} host ms by span over the replay "
        f"({wall * 1e3:.3f} ms wall; span (count)): "
        f"{span_line(span_sums())} on {card}")
    metrics.REGISTRY.reset()
    mesh = shard_mesh()
    t0 = time.perf_counter()
    for kw in workloads.MEGAFLEET_MODES.values():
        solve_partitioned(mega, mesh=mesh,
                          max_nodes_per_shard=workloads.MEGAFLEET_K, **kw)
    torch.cuda.synchronize()
    log(f"[trace] {MEGA_PATH} host ms by span over its three modes "
        f"({(time.perf_counter() - t0) * 1e3:.3f} ms wall): "
        f"{span_line(span_sums())} on {card}")

def phase19(torch, card, problem, mega):
    """Phase 19, metrics and tracing: (a) the tracer's cost on the warm
    guided headline (the live cell's round 2 ran inside phase 10);
    (b) the span trees of a provision and a consolidation tick against the
    kernels; (c) the endpoints of a served operator, on the card against
    the same run on the CPU; (d) host ms by span over a sim replay and the
    megafleet's solves.  Returns the launches by path."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.ops.classpack import solve_classpack
    t0 = time.perf_counter()
    clear_lp_caches()
    check_guided(problem, solve_classpack(problem), "phase 19, cold")
    gold = workloads.GOLDEN_GUIDED["digest"]

    def guided_ok(res):
        check(workloads.plan_digest(problem, res)[0] == gold,
              "phase 19: a timed guided headline left GOLDEN_GUIDED")
    # 21 pairs: a warm guided solve is ~55 ms and its runs spread ±20%
    tracing_cost(torch, card, "guided headline, warm",
                 lambda: solve_classpack(problem), guided_ok, pairs=21)
    log(f"[trace-cost] 19(a) {time.perf_counter() - t0:.1f} s; "
        f"{json.dumps(TRACE_COST)}")
    by_path = traced_paths(torch, card)
    log(f"[trace] 19(b) {time.perf_counter() - t0:.1f} s; launches {by_path}")
    cpu, _, cpu_codes = served_scrape("cpu")
    card_f, trace, codes = served_scrape("cuda")
    check(card_f == cpu, f"/metrics families on the card differ from the "
                         f"CPU run: {sorted(set(card_f) ^ set(cpu))}")
    check(codes == cpu_codes == (403, 200), f"/debug/pprof {codes}")
    log(f"[endpoints] /metrics: {len(card_f)} families, the CPU run's; "
        f"/debug/traces?span=provision: {span_split(trace, 1)}; "
        f"/debug/pprof 403 off, 200 with enable_profiling on {card}")
    log(f"[trace] 19(c) {time.perf_counter() - t0:.1f} s")
    whole_run_splits(torch, card, mega)
    log(f"[trace] 19(d) {time.perf_counter() - t0:.1f} s")
    return by_path


# ---------------------------------------------------------------------------
# phase 20: incidents, the flight recorder, the SLO engine and the cost ledger
# ---------------------------------------------------------------------------

# per method, the host time its calls took during the gated replays
OBS_COST = {}


class obs_cost:
    """While open, `FlightRecorder.sample`, `SLOEngine.tick` and
    `IncidentBus.publish` are timed on the host clock: per method its
    calls, the calls that did work (a sample taken, an evaluation run, a
    publish that reached the recorder rather than its dedup window) and
    the seconds of each kind, summed into OBS_COST.  All three are host
    work over the metric registry and the bus."""

    def __enter__(self):
        from karpenter_tpu_torch.obs.incidents import IncidentBus
        from karpenter_tpu_torch.obs.recorder import FlightRecorder
        from karpenter_tpu_torch.obs.slo import SLOEngine
        self.saved = [(FlightRecorder, "sample", FlightRecorder.sample),
                      (SLOEngine, "tick", SLOEngine.tick),
                      (IncidentBus, "publish", IncidentBus.publish)]
        for cls, name, orig in self.saved:
            st = OBS_COST.setdefault(f"{cls.__name__}.{name}", {
                "calls": 0, "worked": 0, "s": 0.0, "worked_s": 0.0})

            def timed(obj, *a, _orig=orig, _st=st, **k):
                t0 = time.perf_counter()
                out = _orig(obj, *a, **k)
                dt = time.perf_counter() - t0
                _st["calls"] += 1
                _st["s"] += dt
                if out:
                    _st["worked"] += 1
                    _st["worked_s"] += dt
                return out
            setattr(cls, name, timed)
        return self

    def __exit__(self, *exc):
        for cls, name, orig in self.saved:
            setattr(cls, name, orig)


def obs_replays(torch, card, hook):
    """20(a, b): each scenario of `workloads.OBS_REPLAYS` on the card,
    first ungated against its tests/golden/ report, then with its gates
    (chaos-storm and failover-drill with the FlightRecorder gate,
    spot-reclaim-storm with the SLOEngine gate, then with both), the
    metric registry reset before each run.  A gated report must equal its
    digest in GOLDEN_INCIDENTS or GOLDEN_SLO (`workloads.obs_digest`) and,
    stripped of what the gates add, the ungated golden; each run's wall,
    ticks, launches and idle share, and the gated wall over the ungated
    one, are printed, with the host time of the recorder's sampling and the
    engine's evaluations and the bus's publishes.  Returns the launches by
    path."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.sim import report_to_json
    from karpenter_tpu_torch.utils.metrics import REGISTRY
    by_path, ungated, gated_wall = {}, {}, 0.0
    for name, (fname, duration, gates) in workloads.OBS_REPLAYS.items():
        scen = fname[:-len(".yaml")]
        exceptions = CHAOS_EXCEPTIONS if scen == "chaos-storm" else 0
        with open(os.path.join(REPO, "tests", "golden",
                               f"sim-{scen}.json")) as fh:
            want = fh.read()
        if scen not in ungated:
            REGISTRY.reset()
            label = f"sim-{scen} ungated"
            run, _, launches, wall = sim_replay(
                torch, card, hook, fname, duration, label,
                exceptions=exceptions)
            check(report_to_json(run.report) == want,
                  f"{label}: the report differs from tests/golden/sim-{scen}"
                  f".json")
            by_path[label] = launches
            ungated[scen] = wall
        REGISTRY.reset()
        label = sim_label(scen, gates)
        with obs_cost():
            run, h, launches, wall = sim_replay(
                torch, card, hook, fname, duration, label,
                exceptions=exceptions, **gates)
        gated_wall += wall
        golden = workloads.GOLDEN_INCIDENTS.get(name) \
            or workloads.GOLDEN_SLO[name]
        got = workloads.obs_digest(run.report)
        check(got == golden, f"{label}: {got}, not the golden {golden}")
        check(report_to_json(workloads.without_obs(run.report)) == want,
              f"{label}: without its gated sections the report differs "
              f"from tests/golden/sim-{scen}.json")
        check(not h.mgr.flight or not h.mgr.flight.write_errors,
              f"{label}: the recorder failed a write")
        parts = []
        if "incidents" in run.report:
            inc = run.report["incidents"]
            parts.append(f"incidents by kind {inc['by_kind']}, published "
                         f"{inc['published']}, suppressed "
                         f"{inc['suppressed']}, ring {inc['ring']}")
        if "ledger" in run.report:
            led, bud = run.report["ledger"], run.report["slo"]["budgets"]
            tick = bud["slos"][workloads.WALL_SLI]
            parts.append(
                f"SLO evaluations {bud['evaluations']}, ring samples "
                f"{bud['ring_samples']}, {workloads.WALL_SLI} bad "
                f"{tick['bad']} of {tick['total']} (wall-clock), ledger "
                f"opened {led['entries_opened']} closed "
                f"{led['entries_closed']}, by source "
                f"{ {k: v['realized_dh'] for k, v in led['by_decision_source'].items()} }")
        log(f"[obs] {label}: {got['sha256'][:16]}… = its golden; "
            f"{'; '.join(parts)}; launches of K1, K2, K3, K5, K7 "
            f"{[launches[k] for k in DRILL_KERNELS]}; {wall:.3f} s wall, "
            f"{wall / ungated[scen]:.3f}x the ungated run's "
            f"{ungated[scen]:.3f} s, on {card}")
        by_path[label] = launches
    for name in DRILL_KERNELS:
        check(sum(v[name] for k, v in by_path.items()
                  if not k.endswith("ungated")) > 0,
              f"{name} did not launch in the gated replays")
    for method, st in OBS_COST.items():
        log(f"[obs-cost] {method}: {st['calls']} calls, {st['worked']} did "
            f"work; {st['s'] * 1e3:.3f} ms host in all "
            f"({st['s'] / max(st['calls'], 1) * 1e6:.1f} µs a call, "
            f"{st['worked_s'] / max(st['worked'], 1) * 1e6:.1f} µs a call "
            f"that worked), {st['s'] / gated_wall * 100:.3f}% of the gated "
            f"replays' {gated_wall:.3f} s wall, on {card}")
    return by_path


def obs_restart(torch, card, device="cuda"):
    """20(c): a small WarmRestart operator (`small_operator`) provisions
    six pods, ticks a minute on (a ring sample, an SLO evaluation) and has
    its solver ladder demoted once (a watchdog-style timeout), then writes
    its final snapshot — with the FlightRecorder and SLOEngine gates off,
    then on.  Off, the snapshot has no `incidents`, `slo` or `ledger`
    section; on, it has the three, and a successor with the same gates
    restores them: the bundle summaries carried, the bus's counts, the
    SLO budgets and the ledger as written.  Prints the bytes of each
    snapshot and of each section."""
    import pickle
    import tempfile
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.obs import BUS, LEDGER
    from karpenter_tpu_torch.state.snapshot import load_sections
    clear_lp_caches()
    sizes = {}
    for gates in ((), ("FlightRecorder", "SLOEngine")):
        with tempfile.TemporaryDirectory() as d:
            snap = os.path.join(d, "s.bin")
            clock = workloads.SteppedClock(1000.0)
            op, mgr = small_operator(("WarmRestart",) + gates, clock, device,
                                     snapshot_path=snap)
            op.cluster.add_pods(small_pods(6))
            mgr.tick()
            clock.step(1.1)
            mgr.tick()
            clock.step(61.0)
            mgr.tick()
            mgr.controllers["provisioning"].health.report_failure(
                "jax", reason="timeout")
            check(mgr._snapshotter.write_final(),
                  f"[restart] gates {gates}: no final snapshot")
            sections, status = load_sections(snap)
            check(status == "ok", f"[restart] gates {gates}: {status}")
            keys = {"incidents", "slo", "ledger"} & set(sections)
            check(keys == set(("incidents", "slo", "ledger") if gates else ()),
                  f"[restart] gates {gates}: sections {sorted(keys)}")
            sizes[gates] = (os.path.getsize(snap), {
                k: len(pickle.dumps(sections[k],
                                    protocol=pickle.HIGHEST_PROTOCOL))
                for k in sorted(keys)})
            mgr.stop()
            check(not BUS.armed and not LEDGER.enabled,
                  f"[restart] gates {gates}: stop() left the bus or the "
                  f"ledger armed")
            if not gates:
                continue
            check(sections["incidents"]["bundles"]
                  and sections["incidents"]["bundles"][-1]["kind"]
                  == "solver_demotion" and sections["ledger"]["open"],
                  f"[restart] no demotion bundle or open ledger entry in "
                  f"the snapshot")
            op2, mgr2 = small_operator(("WarmRestart",) + gates, clock,
                                       device, snapshot_path=snap)
            outcome = mgr2.startup()
            check(outcome == "restored", f"[restart] startup {outcome}")
            inc = mgr2.incidents_snapshot_state()
            check(inc["restored"] == sections["incidents"]["bundles"]
                  and inc["bus"] == sections["incidents"]["bus"]
                  and mgr2.slo_snapshot_state()["budgets"]
                  == sections["slo"]["budgets"]
                  and mgr2.ledger_snapshot_state() == sections["ledger"],
                  "[restart] the successor did not restore the incidents, "
                  "slo and ledger sections as written")
            mgr2.stop()
    (off, _), (on, secs) = sizes[()], sizes[("FlightRecorder", "SLOEngine")]
    log(f"[restart] small operator snapshot: {off} bytes with the "
        f"FlightRecorder and SLOEngine gates off, {on} bytes on (+{on - off}; "
        f"sections pickled alone {secs}); the successor restored the three "
        f"sections as written, on {card}")


def incident_fault(torch, card, device="cuda"):
    """20(d): a small operator with the FlightRecorder and SLOEngine gates
    on, its provisioning solve with KernelError armed on the next K1 or K7
    launch: tick() must raise it out of `Provisioner.solve` with nothing
    booked, no ladder transition and no incident published or bundled;
    the next tick solves.  A kernel fault is never a demotion, so it never
    becomes a `solver_demotion` bundle."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.obs import BUS
    clear_lp_caches()
    clock = workloads.SteppedClock(1000.0)
    op, mgr = small_operator(("FlightRecorder", "SLOEngine"), clock, device)
    try:
        op.cluster.add_pods(small_pods(6))
        mgr.tick()
        clock.step(1.1)
        prov = mgr.controllers["provisioning"]

        def books():
            return (cluster_state(op.cluster), len(mgr.flight.bundles),
                    dict(BUS.published), dict(BUS.suppressed))
        armed_fault(torch, "KernelError under the FlightRecorder and "
                    "SLOEngine gates", mgr, fault_on_launch, books,
                    raised_through(prov, "solve"))
        check(not mgr.flight.bundles and not BUS.published,
              f"[fault] incidents: the kernel fault was published "
              f"{BUS.published}")
        mgr.tick()
        check(not op.cluster.pending_pods() and not mgr.flight.bundles,
              "[fault] incidents: the next tick did not solve cleanly")
    finally:
        mgr.stop()
    log(f"[fault] incidents: no bundle, no publish; the next tick bound "
        f"the 6 pods; on {card}")


def trace_demo_run(card):
    """20(e): `python -m karpenter_tpu_torch.tools.trace_demo` in process on
    the card: it must print the incident index with one solver_demotion
    bundle.  Prints the index and the bundle's lines and its wall."""
    import contextlib
    import io
    from karpenter_tpu_torch.tools import trace_demo
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = trace_demo.main([])
    wall = time.perf_counter() - t0
    text = out.getvalue()
    i = text.find("# /debug/incidents —")
    check(rc == 0 and i >= 0 and "by kind {'solver_demotion': 1}" in text,
          f"trace_demo: rc {rc}, no solver_demotion index: {text[-2000:]}")
    lines = [ln for ln in text[i:].splitlines()
             if ln.startswith(("# /debug/incidents", "  kind:", "  window:"))]
    log(f"[trace-demo] {' | '.join(lines)}; {wall:.3f} s wall on {card}")


def phase20(torch, card, err):
    """Phase 20, incidents, the flight recorder, the SLO engine and the
    cost ledger: (a, b) the gated replays against GOLDEN_INCIDENTS and
    GOLDEN_SLO beside their ungated goldens, with the recorder's and the
    engine's host cost, every kernel wrapper held against plain on its
    recorded inputs; (c) a small snapshot with the gates off and on, and
    its restore; (d) a KernelError under both gates; (e) trace_demo.
    Returns the launches by path."""
    t0 = time.perf_counter()
    hook = kernel_log(torch, spans=True)
    with wrapped_kernels(hook):
        by_path = obs_replays(torch, card, hook)
    seen = hold_recorded(torch, hook.recorded, err, lambda label: label)
    for name, where in seen.items():
        log(f"[obs] {name} on the {len(where)} inputs recorded in phase 20's "
            f"replays (its last call in each): equal to plain — "
            f"{', '.join(where)}")
    log(f"[obs] 20(a, b) {time.perf_counter() - t0:.1f} s")
    obs_restart(torch, card)
    incident_fault(torch, card)
    trace_demo_run(card)
    log(f"[obs] 20(c-e) {time.perf_counter() - t0:.1f} s")
    return by_path


# ---------------------------------------------------------------------------
# phase 21: the certified cost bounds on the card
# ---------------------------------------------------------------------------

SCREEN_TOL = 1e-6       # a certified pricing bound under its HiGHS optimum
# GOLDEN_CERTIFY's plan cost and LP values across scipy versions (the
# tolerance tests/test_torch_bounds.py states)
CERTIFY_RTOL = 1e-6
SWEEP_PATH_PREFIX = "bounds-sweep-"
CERTIFY_PATH = "certify-10k-200"
DUAL_C = 100            # device_dual_bound's LP instance (workloads.LP_SIZES)
DUAL_ITERS_CAP = 2000   # its iteration cap here: the certificate holds at any
DUAL_PATH = f"lp-{DUAL_C} device_dual_bound"
# 21(b)'s class LP (HiGHS on the host, about 20 s), solved on a thread that
# `start_certify_lp` starts before the build and phase 21 joins
CERTIFY_LP = {}


def start_certify_lp():
    """Build certify's default instance and solve its class LP on a thread
    while nvcc builds the kernels: the main thread only waits on nvcc
    then, and nothing on the card waits for the LP.  The modules it needs
    are imported here, in the main thread, before it starts."""
    import threading
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.ops import lpbound
    import scipy.optimize  # noqa: F401

    def run():
        try:
            t = time.perf_counter()
            CERTIFY_LP["prob"] = prob = workloads.certify_problem()
            t1 = time.perf_counter()
            CERTIFY_LP["z"] = lpbound.class_lp_bound(prob)
            CERTIFY_LP["build_s"] = t1 - t
            CERTIFY_LP["lp_s"] = time.perf_counter() - t1
        except BaseException as e:    # joined and reported by phase 21
            CERTIFY_LP["error"] = repr(e)
    th = threading.Thread(target=run, name="certify-class-lp", daemon=True)
    CERTIFY_LP["thread"] = th
    th.start()


def join_certify_lp():
    """(problem, class LP) from `start_certify_lp`'s thread; the seconds
    phase 21 waited for it are logged."""
    t = time.perf_counter()
    CERTIFY_LP["thread"].join()
    waited = time.perf_counter() - t
    check("error" not in CERTIFY_LP,
          f"{CERTIFY_PATH}: the class LP's thread raised "
          f"{CERTIFY_LP.get('error')}")
    log(f"[bounds] {CERTIFY_PATH}: instance built in "
        f"{CERTIFY_LP['build_s']:.1f} s and class_lp_bound solved in "
        f"{CERTIFY_LP['lp_s']:.1f} s of host on a thread started before the "
        f"build; phase 21 waited {waited:.1f} s for it")
    return CERTIFY_LP["prob"], CERTIFY_LP["z"]


def screen_bound(torch, case, dims):
    """(bound ms, "bytes" or "operations", binding term, {term: ms}) of one
    batched PDHG solve on the members' natural dims (`dims`: (n, mi) of
    each member, in batch order; the pricing LPs have no equality rows),
    counted member by member from this run's iterations: `pdhg_bound`'s
    three terms, summed over the members, plus two figures that bound
    nothing: the natural operator streamed from HBM once a step, and the
    padded envelope ((me + mi) x n of the batch) read once a step."""
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    its = np.asarray(case["iters"], np.float64)
    checks = np.ceil(its / case["check_every"])
    mat = np.array([4.0 * n * mi for n, mi in dims])   # float32 bytes
    sms, optin, _ = lk.device_smem(case["ops"][0].device)
    fits = mat.sum() <= sms * optin
    rate = SMEM_BYTES_PER_CLOCK * sms * SM_CLOCK_HZ if fits else MEM_BW
    terms = {"hbm bytes": float(((1 + 2 * checks) * mat).sum()) / MEM_BW * 1e3,
             "on-chip bytes" + (" (shared memory)" if fits else " (HBM)"):
             float((2 * its * mat).sum()) / rate * 1e3,
             "operations": float((its * mat).sum()) / F32_PEAK * 1e3}
    term = max(terms, key=terms.get)
    A, G = case["ops"][0], case["ops"][2]
    padded = (A.shape[1] + G.shape[1]) * A.shape[2] * 4
    extra = {"natural operator from HBM a step":
             float((its * mat).sum()) / MEM_BW * 1e3,
             "padded envelope from HBM a step":
             padded * float(its.sum()) / MEM_BW * 1e3}
    return (terms[term], "operations" if term == "operations" else "bytes",
            term, terms, extra)


def screen_line(torch, card, name, screen, launches, err):
    """One screen's batch on the card (`screen`: a `screens` record): its
    kernel path (from the launch counts read around the run), envelope and
    natural dims, iterations, the kernel's own CUDA-event time, its bound,
    and the kernel held against plain.  Returns the record."""
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    case, dims = screen["case"], screen["dims"]
    path = "resident" if launches["pdhg_resident"] else "streaming"
    args = (*case["ops"], case["eps"], case["iters_cap"],
            case["check_every"])
    ms = event_ms(torch, lambda: lk.pdhg(*args), 1)
    bad = compare_pdhg_case(torch, name, case, err, path=path, summary=True)
    check(not bad, f"pdhg on {name}'s screen: {bad[:8]}")
    plain_ms = case["plain_ms"]
    bound_ms, by, term, terms, extra = screen_bound(torch, case, dims)
    B, n = case["ops"][4].shape
    me, mi = case["ops"][1].shape[1], case["ops"][3].shape[1]
    ns = [d[0] for d in dims]
    it = case["iters"]
    r = lambda d: {k: round(v, 4) for k, v in d.items()}
    log(f"[bounds] {name} screen: B={B} pricing LPs, one pdhg launch "
        f"({path}), envelope n={n} me={me} mi={mi}, natural n {min(ns)}-"
        f"{max(ns)} (sum {sum(ns)}) me=0 mi={sorted({d[1] for d in dims})}; "
        f"iterations {int(it.min())}-{int(it.max())} (sum {int(it.sum())}), "
        f"{int(case['done'].sum())} converged; {screen['ms']:.3f} ms CUDA "
        f"events over _device_screen (padding, upload, launch, copies "
        f"back), the kernel {ms:.3f} ms; bound {bound_ms:.4f} ms by {term} "
        f"on the natural dims (terms {r(terms)}: {ms / bound_ms:.0f}x; "
        f"beside it, bounding nothing, {r(extra)}); plain {plain_ms:.3f} "
        f"ms; {case['summary']}; on {card}")
    return dict(B=B, n=n, me=me, mi=mi, natural_n_sum=sum(ns), path=path,
                ms=ms, call_ms=screen["ms"], plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, bound_term=term,
                bound_terms=terms, **{k.replace(" ", "_") + "_ms": v
                                      for k, v in extra.items()},
                iterations=int(it.max()), iterations_sum=int(it.sum()),
                launches=launches["pdhg"])


def screens(torch, fn):
    """Run `fn()` with every `ggbound._device_screen` call spanned by CUDA
    events and its pdhg call captured: (fn's result, [{ms, case, dims}]),
    `dims` each member's natural (n, mi) in batch order."""
    from karpenter_tpu_torch.ops import ggbound
    real = ggbound._device_screen
    seen = []

    def timed(jobs, duals, req, alloc, *a, **kw):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out, cases = capture_masters(
            lambda: real(jobs, duals, req, alloc, *a, **kw))
        e1.record()
        torch.cuda.synchronize()
        check(len(cases) == 1, f"a screen made {len(cases)} pdhg calls")
        seen.append(dict(ms=e0.elapsed_time(e1), case=cases[0],
                         dims=[(len(idx), req.shape[1]) for _, idx, _ in
                               jobs]))
        return out
    ggbound._device_screen = timed
    try:
        res = fn()
    finally:
        ggbound._device_screen = real
    return res, seen


def pricing_sweeps(torch, card, err):
    """21(a): the pricing sweep of bench.run_lp_ab (40 types, C = 100,
    250, 500 from one default_rng(42)) under the class LP's duals: the
    serial HiGHS screen over the jobs (timed with no other thread of this
    process running), then one `_device_screen` batch on the card from
    cold warm-start caches, with the launch counts set to 0 just before it
    and read just after; every certified bound at least its HiGHS
    optimum.  Returns ({path: launches}, {C: record})."""
    from scipy.optimize import linprog
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.ops import ggbound, lpsolve
    rng = np.random.default_rng(workloads.LP_SEED)
    paths, recs = {}, {}
    for C in workloads.SWEEP_SIZES:
        req, cnt, compat, alloc, price = workloads.lp_instance(
            C, workloads.LP_TYPES, rng)
        z, duals = workloads.lp_duals(req, cnt, compat, alloc, price)
        jobs = workloads.lp_pricing_jobs(req, compat, alloc, duals)
        t0 = time.perf_counter()
        highs = {}
        for j, idx, ubj in jobs:
            r = linprog(-duals[idx], A_ub=req[idx].T, b_ub=alloc[j],
                        bounds=[(0, u) for u in ubj], method="highs")
            check(r.status == 0, f"HiGHS pricing LP {j} at C={C} failed")
            highs[j] = -r.fun
        highs_ms = (time.perf_counter() - t0) * 1e3
        name = f"{SWEEP_PATH_PREFIX}{C}"
        lpsolve.reset_caches()
        reset_all_launches()
        ub, seen = screens(torch, lambda: ggbound._device_screen(
            jobs, duals, req, alloc))
        paths[name] = launches = all_launches()
        check(launches["pdhg"] == 1,
              f"{name}: {launches['pdhg']} pdhg launches, not 1")
        slack = np.array([ub[j] - highs[j] for j, _, _ in jobs])
        check(sorted(ub) == sorted(highs) and slack.min() >= -SCREEN_TOL,
              f"{name}: a certified pricing bound fell under its HiGHS "
              f"optimum by {-slack.min()}")
        rec = screen_line(torch, card, name, seen[0], launches, err)
        rec.update(highs_ms=highs_ms, class_lp=z)
        recs[C] = rec
        log(f"[bounds] {name}: class LP {z!r} over {len(alloc)} options; "
            f"the serial HiGHS screen over the same {len(jobs)} jobs "
            f"{highs_ms:.1f} ms of host (no other thread running) against "
            f"{seen[0]['ms']:.3f} ms for the batch; every certified bound >= "
            f"its HiGHS optimum (slack {slack.min():.3g} to "
            f"{slack.max():.3g}); on {card}")
    return paths, recs


def certify_path(torch, card, err):
    """21(b): tools/certify.py's path at its default size (10 000 pods x
    200 types): solve_classpack on the card; class_lp_bound (from
    `start_certify_lp`'s thread) against GOLDEN_CERTIFY; gg_bound(
    device=True) for CERTIFY_GG_ITERS rounds with `lpbound.class_lp_bound`
    patched to -inf, so that it returns the column generation's own value
    (the bound is its max with the class LP, as gg_bound takes it), each
    of the two card runs with the launch counts set to 0 just before it
    and read just after.  The own value and the column count against
    GOLDEN_CERTIFY's (the JAX package's, on its HiGHS screen), class LP <=
    gg <= plan cost, and gg against the golden.  Returns ({path:
    launches}, the screen's record)."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.ops import ggbound, lpbound, lpsolve
    from karpenter_tpu_torch.ops.classpack import solve_classpack
    gold = workloads.GOLDEN_CERTIFY
    t0 = time.perf_counter()
    prob, z = join_certify_lp()
    check(abs(z - gold["class_lp"]) <= CERTIFY_RTOL * gold["class_lp"],
          f"{CERTIFY_PATH}: class LP {z} against GOLDEN_CERTIFY")
    clear_lp_caches()
    reset_all_launches()
    t1 = time.perf_counter()
    plan = solve_classpack(prob)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t1
    paths = {f"{CERTIFY_PATH} plan": all_launches()}
    log(f"[bounds] {CERTIFY_PATH}: C={prob.num_classes} O={prob.num_options};"
        f" solve_classpack on the card {plan_s:.3f} s: {len(plan.nodes)} "
        f"nodes, cost {plan.total_price!r} (golden {gold['nodes']}, "
        f"{gold['plan_cost']!r}); class LP {z!r} (golden "
        f"{gold['class_lp']!r}); launches {paths[f'{CERTIFY_PATH} plan']}")
    check(len(plan.nodes) == gold["nodes"] and not plan.unschedulable
          and abs(plan.total_price - gold["plan_cost"])
          <= CERTIFY_RTOL * gold["plan_cost"],
          f"{CERTIFY_PATH}: plan {plan.total_price} / {len(plan.nodes)} "
          f"nodes against GOLDEN_CERTIFY")
    name = f"{CERTIFY_PATH} gg_bound"
    real_lp = lpbound.class_lp_bound
    lpbound.class_lp_bound = lambda p: -math.inf
    try:
        lpsolve.reset_caches()
        reset_all_launches()
        t1 = time.perf_counter()
        (own, info), seen = screens(torch, lambda: ggbound.gg_bound(
            prob, iters=workloads.CERTIFY_GG_ITERS, warm_plan=plan,
            device=True))
        gg_s = time.perf_counter() - t1
        paths[name] = launches = all_launches()
    finally:
        lpbound.class_lp_bound = real_lp
    gg = max(z, own)
    log(f"[bounds] {name}(iters={workloads.CERTIFY_GG_ITERS}, device=True): "
        f"the column generation's own value {own!r} (golden {gold['own']!r},"
        f" the JAX package's on its HiGHS screen) with {info['columns']} "
        f"columns (golden {gold['columns']}), converged {info['converged']},"
        f" in {gg_s:.1f} s of host; the bound max(class LP, own) {gg!r} "
        f"(golden {gold['gg']!r}); class LP <= gg <= plan: {z!r} <= {gg!r} "
        f"<= {plan.total_price!r}; launches {launches}")
    check(info["pricing_screen"] == "device"
          and info["iters"] == workloads.CERTIFY_GG_ITERS == gold["gg_iters"]
          and len(seen) == info["iters"] == launches["pdhg"],
          f"{name}: {info['iters']} rounds, {len(seen)} screens, "
          f"{launches['pdhg']} pdhg launches")
    check(info["columns"] == gold["columns"],
          f"{name}: {info['columns']} columns, GOLDEN_CERTIFY "
          f"{gold['columns']}")
    check(abs(own - gold["own"]) <= CERTIFY_RTOL * abs(gold["own"]),
          f"{name}: own value {own} against GOLDEN_CERTIFY {gold['own']}")
    check(z - SCREEN_TOL <= gg <= plan.total_price + SCREEN_TOL,
          f"{name}: the certified ordering broke: {z} / {gg} / "
          f"{plan.total_price}")
    check(abs(gg - gold["gg"]) <= CERTIFY_RTOL * gold["gg"],
          f"{name}: {gg} against GOLDEN_CERTIFY {gold['gg']}")
    rec = screen_line(torch, card, name, seen[-1], launches, err)
    log(f"[bounds] 21(b) {time.perf_counter() - t0:.1f} s (plan "
        f"{plan_s:.1f}, gg_bound {gg_s:.1f})")
    return paths, rec


def dual_bound_path(torch, card, err):
    """21(c): `lpbound.device_dual_bound` on the card at the LP instance
    lp-100 (`workloads.lp_problems`; its dense class LP is one PDHG solve,
    capped at DUAL_ITERS_CAP here), with the launch counts set to 0 just
    before it and read just after, against the same function with the
    kernel's plain version (`pdhg_plain` on the card) in its place, within
    LP_RTOL of the class LP; both a certified bound (positive, at most the
    class LP); the kernel held against plain on the captured solve.
    Returns {path: launches}."""
    from karpenter_tpu_torch import workloads
    from karpenter_tpu_torch.ops import lpbound, lpsolve
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    prob = workloads.lp_problems()[DUAL_C]
    t = time.perf_counter()
    lp = lpbound.class_lp_bound(prob)
    lp_s = time.perf_counter() - t
    lpsolve.reset_caches()
    reset_all_launches()
    t = time.perf_counter()
    got, cases = capture_masters(lambda: lpbound.device_dual_bound(
        prob, iters_cap=DUAL_ITERS_CAP))
    torch.cuda.synchronize()
    got_s = time.perf_counter() - t
    launches = all_launches()
    check(launches["pdhg"] == 1 and len(cases) == 1,
          f"{DUAL_PATH}: {launches['pdhg']} pdhg launches")
    case = cases[0]
    bad = compare_pdhg_case(torch, DUAL_PATH, case, err, pod_scale=True,
                            path=("resident" if launches["pdhg_resident"]
                                  else "streaming"))
    check(not bad, f"pdhg on {DUAL_PATH}: {bad[:8]}")
    real = lpsolve._pdhg_kernel
    lpsolve._pdhg_kernel = lambda *a, **kw: lk.pdhg_plain(
        *a[:10], kw["iters_cap"], kw["check_every"])
    try:
        lpsolve.reset_caches()
        want = lpbound.device_dual_bound(prob, iters_cap=DUAL_ITERS_CAP)
    finally:
        lpsolve._pdhg_kernel = real
    log(f"[bounds] {DUAL_PATH}: {got!r} with the kernel ({got_s:.2f} s "
        f"host, {'converged' if case['done'][0] else 'cap'} at "
        f"{int(case['iters'][0])} iterations, envelope "
        f"{tuple(case['ops'][0].shape)} + {tuple(case['ops'][2].shape)}), "
        f"{want!r} with pdhg_plain on the card; class LP {lp!r} (HiGHS "
        f"{lp_s:.1f} s); |kernel - plain| {abs(got - want):.3g} (limit "
        f"{LP_RTOL} x the class LP); launches {launches}; on {card}")
    check(abs(got - want) <= LP_RTOL * lp,
          f"{DUAL_PATH}: {got} with the kernel, {want} with plain")
    check(0.0 < got <= lp * (1 + CERTIFY_RTOL)
          and 0.0 < want <= lp * (1 + CERTIFY_RTOL),
          f"{DUAL_PATH}: {got} / {want} is not a certified bound under the "
          f"class LP {lp}")
    return {DUAL_PATH: launches}


def phase21(torch, card, err, rows):
    """Phase 21, the certified cost bounds: (a) the pricing sweeps at the
    bench's LP A/B sizes, (b) the certify tool's path at its default size
    (its class LP solved on a thread during the build) and (c)
    device_dual_bound at lp-100.  The screens' records join the pdhg row.
    Returns the launches by path."""
    t0 = time.perf_counter()
    paths, rec = certify_path(torch, card, err)
    sweep_paths, recs = pricing_sweeps(torch, card, err)
    paths.update(sweep_paths)
    paths.update(dual_bound_path(torch, card, err))
    row = next(r for r in rows if r["name"] == "pdhg")
    row["screen"] = dict(rec, main_path=f"{CERTIFY_PATH} gg_bound")
    row["sweeps"] = {f"{SWEEP_PATH_PREFIX}{C}": r for C, r in recs.items()}
    log(f"[bounds] phase 21 {time.perf_counter() - t0:.1f} s")
    return paths


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this smoke "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    import karpenter_tpu_torch  # noqa: F401  (fails outside the repo)
    t_start = time.perf_counter()
    card = probe(torch)
    start_certify_lp()
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
    # phase 13 (run here, so the kernel rows carry its launches)
    by_path.update(disruption_path(torch, card, err))
    disruption_timings(torch, card)
    log(f"[disruption] phase 13 done "
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
    # phase 14 last, after every profiler trace (its paths' launches and
    # plain-version differences then join the rows); its operator cell
    # snapshots round 1 into a scratch directory for phase 18
    import shutil
    import tempfile
    snap_dir = tempfile.mkdtemp(prefix="chip-smoke-snapshot-")
    snap = {"path": os.path.join(snap_dir, "operator.snap")}
    try:
        return _phases_14_on(torch, card, err, rows, scans, snap, t_start,
                             problem, mega)
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)


def join_paths(rows, err, paths):
    """A later phase's plain-version differences (`err`) and its paths'
    launches join the kernel rows."""
    for row in rows:
        if row["name"] in err:
            row["max_abs_err"] = max(row["max_abs_err"], err[row["name"]])
        for path, launches in paths.items():
            if row["name"] in launches:
                row["launches_by_path"][path] = launches[row["name"]]


def _phases_14_on(torch, card, err, rows, scans, snap, t_start,
                  problem, mega) -> int:
    """Phases 14-20 and the closing lines (`main`'s tail, with phase 14's
    snapshot in `snap`, the headline problem and the megafleet for phase
    19)."""
    arena_paths = phase14(torch, card, err, snap=snap)
    join_paths(rows, err, arena_paths)
    log(f"[arena] phase 14 done ({time.perf_counter() - t_start:.1f} s "
        f"so far)")
    loop_paths, loop_recorded = phase15(torch, card, err)
    join_paths(rows, err, loop_paths)
    log(f"[loop] phase 15 done ({time.perf_counter() - t_start:.1f} s "
        f"so far)")
    robust_paths = phase16(torch, card, err, scans, loop_recorded)
    join_paths(rows, err, robust_paths)
    log(f"[robust] phase 16 done ({time.perf_counter() - t_start:.1f} s "
        f"so far)")
    gated_paths = phase17(torch, card, err)
    join_paths(rows, err, gated_paths)
    log(f"[gated] phase 17 done ({time.perf_counter() - t_start:.1f} s "
        f"so far)")
    ha_paths = phase18(torch, card, err, snap)
    join_paths(rows, err, ha_paths)
    log(f"[ha] phase 18 done ({time.perf_counter() - t_start:.1f} s so far)")
    trace_paths = phase19(torch, card, problem, mega)
    join_paths(rows, err, trace_paths)
    log(f"[trace] phase 19 done ({time.perf_counter() - t_start:.1f} s "
        f"so far)")
    obs_paths = phase20(torch, card, err)
    join_paths(rows, err, obs_paths)
    log(f"[obs] phase 20 done ({time.perf_counter() - t_start:.1f} s "
        f"so far)")
    bound_paths = phase21(torch, card, err, rows)
    join_paths(rows, err, bound_paths)
    log(f"[bounds] phase 21 done ({time.perf_counter() - t_start:.1f} s "
        f"so far)")
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
