"""graftlint: codebase-aware static analysis for karpenter_tpu_torch.

The port of the JAX package's `analysis/`: the same framework, findings,
suppressions and baseline, with every path constant naming the port's
modules.  Its checker families:

  * torch-hotpath (JH*)    — host-device syncs (`.item()`,
    `torch.cuda.synchronize()`, Python branches on tensor values, host
    conversions in the kernel wrappers) and the columnar decode-path
    discipline.  JH004 and JH005 (static argnums, buffer donation) are
    jit-spec rules with no meaning in eager PyTorch; the port's catalog
    leaves them out (see `torchhot.py`).
  * determinism (DT*)      — wall-clock reads, unseeded global RNG, and
    unordered set iteration in modules reachable from `sim/` (the golden
    reports are byte-identical; any of these breaks them).
  * lock-discipline (LK*)  — `# guarded-by: <lock>` annotations on shared
    attributes, checked lexically; plus a test-time lock-order recorder
    (analysis/lockorder.py) that fails a test module on observed
    inversions.
  * observability (OB*)    — metrics families ↔ docs/metrics.md contract,
    bounded label sets, span names drawn from utils/tracing.SPAN_NAMES.
  * arena-discipline (AR*) and robustness (RS*) — the slab delta API and
    the supervision / fencing funnels.

Entry points: `python -m karpenter_tpu_torch.tools.graftlint` and the gate
in tests/test_torch_graftlint.py (zero non-baselined findings).  See
docs/static-analysis.md for the conventions and baseline workflow.
"""

from .core import (  # noqa: F401
    Finding,
    Rule,
    RULES,
    SourceFile,
    default_checkers,
    iter_sources,
    load_baseline,
    partition,
    run_analysis,
    write_baseline,
)
