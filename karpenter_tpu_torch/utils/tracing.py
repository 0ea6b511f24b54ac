"""Dependency-free reconcile tracing.

A copy of the JAX package's `utils/tracing.py`, its span names included.
The reference operator leans on controller-runtime's tracing/logging to
answer "why did that reconcile take 2s"; this module is the reproduction's
equivalent: a `Span`/`Tracer` pair with

  * thread-local context propagation (spans opened on the manager's HTTP
    worker threads, the refinery daemon, and batcher flusher threads parent
    correctly via `capture()`/`attach()`),
  * monotonic-clock timing (`time.perf_counter`; wall-clock start kept only
    for display),
  * a bounded ring buffer of recently *completed root* traces,
  * JSON export (`Tracer.traces`) consumed by the manager's
    `/debug/traces` endpoint and `make trace-demo`,
  * a configurable slow-span WARN threshold, and
  * span durations fed into the `karpenter_trace_span_duration_seconds`
    histogram so Grafana needs no new scrape target.

Everything is stdlib-only and cheap enough to stay on in production: an
enabled span costs two `perf_counter` calls, a couple of dict/list appends
and one histogram observe; `Tracer.enabled = False` reduces `span()` to a
shared no-op span (bench.py uses the toggle to measure the overhead).
"""

from __future__ import annotations

import itertools
import json
import logging
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

from ..analysis.lockorder import named_lock
from . import metrics

logger = logging.getLogger("karpenter.tracing")

# The one span-name registry (graftlint OB004/OB005): every literal
# `tracing.span("...")` name lives here, so the `span` label set of
# karpenter_trace_span_duration_seconds stays enumerable and docs/
# dashboards can list the full vocabulary.  Dynamic names must pass
# through `registered()`, which asserts membership at runtime.
SPAN_NAMES = frozenset({
    # provisioning tick
    "provision", "provision.round", "provision.launch",
    "provision.provenance",
    "solve.tensorize", "solve.pack", "solve.kernel", "solve.decode",
    # disruption sweep (disruption.<method> from the timed() dispatcher)
    "disruption.reconcile", "disruption.candidates", "disruption.execute",
    "disruption.expiration", "disruption.drift", "disruption.consolidation",
    "sweep.arena", "sweep.prefix", "sweep.decode", "sweep.single",
    # persistent cluster arena (ops/arena.py)
    "arena.rebuild", "arena.compact", "arena.ingest_flush",
    # fleet-scale partitioned solve (parallel/partition.py + driver.py)
    "shard.partition", "shard.solve", "shard.reconcile",
    "shard.tensorize", "shard.kernel", "shard.assemble",
    # refinery + LP guide
    "refinery.refine", "refinery.lp", "refinery.price",
    # device LP solver (ops/lpsolve.py): one dispatch of the batched
    # PDHG kernel — lp.solve is a B=1 batch, lp.batch covers B>1
    "lp.solve", "lp.batch",
    # forecast/headroom reconcile
    "forecast.reconcile", "forecast.model", "forecast.plan",
    "forecast.preempt",
    # substrate
    "batcher.flush", "http.solve",
})


def registered(name: str) -> str:
    """Runtime gate for dynamically-composed span names: asserts the
    result is in SPAN_NAMES so a new code path can't mint an unbounded
    `span` label behind the static checker's back."""
    if name not in SPAN_NAMES:
        raise ValueError(f"span name {name!r} is not in tracing.SPAN_NAMES")
    return name


_ids = itertools.count(1)
_id_lock = threading.Lock()


def _next_id() -> str:
    with _id_lock:
        return format(next(_ids), "x")


class Span:
    """One timed operation. Children are built through the tracer's
    thread-local stack (same thread) or `Tracer.attach` (cross-thread);
    mutation of `children` is guarded by the owning tracer's lock because
    a refinery/batcher child may finish after its parent did."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "end", "wall_start", "annotations", "children")

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _next_id()
        self.parent_id = parent_id
        self.start = time.perf_counter()
        self.end: Optional[float] = None
        self.wall_start = time.time()
        self.annotations: Dict[str, Any] = {}
        self.children: List["Span"] = []

    @property
    def duration_ms(self) -> float:
        end = self.end if self.end is not None else time.perf_counter()
        return (end - self.start) * 1000.0

    def annotate(self, **kw: Any) -> None:
        self.annotations.update(kw)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_unix": self.wall_start,
            "duration_ms": round(self.duration_ms, 4),
            "annotations": dict(self.annotations),
            "children": [c.to_dict() for c in self.children],
        }


class _NullSpan:
    """Shared no-op stand-in when tracing is disabled."""

    __slots__ = ()
    name = trace_id = span_id = parent_id = ""
    annotations: Dict[str, Any] = {}
    children: List[Span] = []
    duration_ms = 0.0

    def annotate(self, **kw: Any) -> None:
        pass

    def to_dict(self) -> Dict[str, Any]:
        return {}


NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-local span stacks + a bounded ring of completed root traces."""

    def __init__(self, max_traces: int = 256):
        self.enabled = True
        self.slow_ms = 0.0          # 0 disables slow-span WARNs
        self.max_traces = max_traces
        self._lock = named_lock("tracer")
        self._ring: deque = deque(maxlen=max_traces)  # guarded-by: _lock
        self._local = threading.local()

    # ---- thread-local stack ----
    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    # ---- span lifecycle ----
    @contextmanager
    def span(self, name: str, **annotations: Any) -> Iterator[Span]:
        if not self.enabled:
            yield NULL_SPAN  # type: ignore[misc]
            return
        stack = self._stack()
        parent = stack[-1] if stack else None
        sp = Span(name,
                  trace_id=parent.trace_id if parent else _next_id(),
                  parent_id=parent.span_id if parent else None)
        if annotations:
            sp.annotations.update(annotations)
        stack.append(sp)
        try:
            yield sp
        finally:
            stack.pop()
            sp.end = time.perf_counter()
            with self._lock:
                if parent is not None:
                    parent.children.append(sp)
                else:
                    self._ring.append(sp)
            self._finish(sp)

    def _finish(self, sp: Span) -> None:
        dur_s = (sp.end - sp.start) if sp.end is not None else 0.0
        try:
            metrics.trace_span_duration().observe(dur_s, {"span": sp.name})
            if self.slow_ms > 0 and dur_s * 1000.0 >= self.slow_ms:
                metrics.trace_slow_spans().inc({"span": sp.name})
                logger.warning(
                    "slow span %s took %.1fms (threshold %.1fms) trace=%s span=%s %s",
                    sp.name, dur_s * 1000.0, self.slow_ms,
                    sp.trace_id, sp.span_id, sp.annotations)
        except Exception:  # metrics must never break the traced path
            pass

    # ---- cross-thread propagation ----
    def capture(self) -> Optional[Span]:
        """Snapshot the current span to hand to another thread."""
        return self.current() if self.enabled else None

    @contextmanager
    def attach(self, parent: Optional[Span]) -> Iterator[None]:
        """Adopt a span captured on another thread as this thread's current
        parent, so spans opened here join its trace. A `None` parent (or a
        disabled tracer) makes this a no-op: spans become their own roots."""
        if not self.enabled or parent is None or parent is NULL_SPAN:
            yield
            return
        stack = self._stack()
        stack.append(parent)
        try:
            yield
        finally:
            stack.pop()

    # ---- export ----
    def traces(self, min_ms: float = 0.0,
               span: Optional[str] = None) -> List[Dict[str, Any]]:
        """Completed root traces, newest first, as JSON-ready dicts.
        `span` keeps only traces whose root span name starts with the
        given prefix (e.g. "controller." for the reconcile family)."""
        with self._lock:
            roots = list(self._ring)
        out = [r.to_dict() for r in reversed(roots)]
        if min_ms > 0:
            out = [t for t in out if t["duration_ms"] >= min_ms]
        if span:
            out = [t for t in out if str(t.get("name", "")).startswith(span)]
        return out

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
        self._local = threading.local()


TRACER = Tracer()


def span(name: str, **annotations: Any):
    """Module-level convenience: `with tracing.span("solve.pack"): ...`."""
    return TRACER.span(name, **annotations)


def annotate(**kw: Any) -> None:
    """Annotate the innermost active span; a silent no-op outside any span
    (the ops kernels call this unconditionally)."""
    cur = TRACER.current()
    if cur is not None:
        cur.annotate(**kw)


# ---------------------------------------------------------------------------
# Structured logging (satellite: --log-format / configure_logging)
# ---------------------------------------------------------------------------

class _TraceContextFilter(logging.Filter):
    """Stamps every record with the active trace/span ids ("" outside)."""

    def filter(self, record: logging.LogRecord) -> bool:
        cur = TRACER.current()
        record.trace_id = cur.trace_id if cur is not None else ""
        record.span_id = cur.span_id if cur is not None else ""
        return True


class JsonLogFormatter(logging.Formatter):
    """One JSON object per line: ts/level/logger/message + trace ids."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
            "trace_id": getattr(record, "trace_id", ""),
            "span_id": getattr(record, "span_id", ""),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


class TextLogFormatter(logging.Formatter):
    """The classic text line, with trace/span ids appended when inside one."""

    def __init__(self):
        super().__init__("%(asctime)s %(levelname)s %(name)s %(message)s")

    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        tid = getattr(record, "trace_id", "")
        if tid:
            base += f" trace={tid} span={getattr(record, 'span_id', '')}"
        return base


def configure_logging(options=None) -> None:
    """Root-logger setup driven by `Options.log_format` / `trace_slow_ms`.

    Replaces any existing handlers (idempotent across restarts in tests)
    and installs the trace-context filter so both formats can carry ids.
    """
    fmt = getattr(options, "log_format", "text") if options is not None else "text"
    TRACER.slow_ms = float(getattr(options, "trace_slow_ms", TRACER.slow_ms) or 0.0)
    handler = logging.StreamHandler()
    handler.setFormatter(JsonLogFormatter() if fmt == "json" else TextLogFormatter())
    handler.addFilter(_TraceContextFilter())
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    root.addHandler(handler)
    root.setLevel(logging.INFO)
