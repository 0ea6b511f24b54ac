#!/usr/bin/env python3
"""Time the port's PDHG kernel per step on one CUDA card.

    python3 pdhg_steps.py [--iters 2048] [--reps 3] [--check-every 32]

For each envelope B x (n, me, mi) -- the guided headline's restricted
master, the LP instances' four masters (the shapes `chip_smoke.py` captures)
and a B = 2 batch of the headline master (over the shared-memory budget) --
a seeded feasible LP of exactly that shape is solved for `--iters` steps
(eps 0, so no member stops early; the KKT checks every `--check-every`
steps included),
and the median of `--reps` launches' CUDA-event times is printed per step,
with the kernel the launch took.  One JSON line per envelope, then the
card's name and power limit.  It calls only the wrapper
`karpenter_tpu_torch.ops.lpsolve_kernels.pdhg`, so the same file times
another tree of the port: copy it to that tree's root and run it there.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np

ENVELOPES = {                      # name -> (B, n, me, mi)
    "headline master": (1, 8192, 256, 512),
    "lp-100 master 1": (1, 512, 128, 64),
    "lp-100 master 2": (1, 2048, 128, 256),
    "lp-250 master 1": (1, 1024, 256, 128),
    "lp-250 master 2": (1, 4096, 256, 256),
    "headline master x2": (2, 8192, 256, 512),
}


def operands(torch, B, n, me, mi, rng):
    """A feasible LP per member (b = A x*, h = G x* + slack, c > 0, u = 4),
    float32 on the card, in the wrapper's argument order."""
    f32 = np.float32
    x = rng.uniform(0.0, 2.0, (B, n))
    A = rng.uniform(-1.0, 1.0, (B, me, n))
    G = rng.uniform(-1.0, 1.0, (B, mi, n))
    b = np.einsum("bmn,bn->bm", A, x)
    h = np.einsum("bmn,bn->bm", G, x) + rng.uniform(0.1, 1.0, (B, mi))
    c = rng.uniform(0.1, 1.0, (B, n))
    u = np.full((B, n), 4.0)
    zeros = [np.zeros((B, n)), np.zeros((B, me)), np.zeros((B, mi))]
    return [torch.tensor(a.astype(f32), device="cuda")
            for a in (A, b, G, h, c, u, *zeros)]


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--check-every", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pdhg_steps: no CUDA card", file=sys.stderr)
        return 2
    from karpenter_tpu_torch.ops import lpsolve_kernels as lk
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    for name, (B, n, me, mi) in ENVELOPES.items():
        ops = operands(torch, B, n, me, mi, rng)
        run = lambda: lk.pdhg(*ops, 0.0, args.iters,  # noqa: E731
                              args.check_every)
        before = dict(lk.LAUNCHES)
        out = run()
        torch.cuda.synchronize()
        path = ("resident" if lk.LAUNCHES.get("pdhg_resident", 0)
                > before.get("pdhg_resident", 0) else "streaming")
        ms = []
        for _ in range(args.reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            run()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        it = int(out[4].max())
        print(json.dumps(dict(envelope=name, B=B, n=n, me=me, mi=mi,
                              path=path, iterations=it,
                              check_every=args.check_every,
                              ms=statistics.median(ms), runs_ms=ms,
                              us_per_step=statistics.median(ms) / it * 1e3)),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
