"""Prometheus-style metrics registry.

A copy of the JAX package's `utils/metrics.py`, its families and label
values byte for byte.  The reference exposes ~60 metric families via controller-runtime's registry
(karpenter:website/content/en/docs/reference/metrics.md:30-195; in-tree
families at pkg/controllers/interruption/metrics.go:36-62,
pkg/providers/instancetype/metrics.go:35-46, pkg/providers/pricing/metrics.go:37,
pkg/batcher/metrics.go:40-47).  This module is a dependency-free equivalent:
Counter/Gauge/Histogram with label vectors and the text exposition format, so
the operator can serve a /metrics endpoint with parity-named families.
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..analysis.lockorder import named_lock

LabelKV = Tuple[Tuple[str, str], ...]

DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _labels_key(label_names: Sequence[str], values: Dict[str, str]) -> LabelKV:
    missing = set(label_names) - set(values)
    extra = set(values) - set(label_names)
    if missing or extra:
        raise ValueError(f"label mismatch: missing={missing} extra={extra}")
    return tuple((k, str(values[k])) for k in label_names)


class _Metric:
    def __init__(self, name: str, help_text: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._lock = named_lock("metrics.family")

    def _key(self, labels: Optional[Dict[str, str]]) -> LabelKV:
        return _labels_key(self.label_names, labels or {})


class Counter(_Metric):
    kind = "counter"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._values: Dict[LabelKV, float] = {}  # guarded-by: _lock

    def inc(self, labels: Optional[Dict[str, str]] = None, by: float = 1.0):
        if by < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + by

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._values.get(self._key(labels), 0.0)

    def samples(self) -> Iterable[Tuple[str, LabelKV, float]]:
        with self._lock:
            return [(self.name, k, v) for k, v in self._values.items()]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._values: Dict[LabelKV, float] = {}  # guarded-by: _lock

    def set(self, value: float, labels: Optional[Dict[str, str]] = None):
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def add(self, by: float, labels: Optional[Dict[str, str]] = None):
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + by

    def delete(self, labels: Optional[Dict[str, str]] = None):
        with self._lock:
            self._values.pop(self._key(labels), None)

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._values.get(self._key(labels), 0.0)

    def samples(self):
        with self._lock:
            return [(self.name, k, v) for k, v in self._values.items()]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_text: str, label_names: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_text, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[LabelKV, List[int]] = {}  # guarded-by: _lock
        self._sums: Dict[LabelKV, float] = {}        # guarded-by: _lock
        self._totals: Dict[LabelKV, int] = {}        # guarded-by: _lock

    def observe(self, value: float, labels: Optional[Dict[str, str]] = None):
        key = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            idx = bisect.bisect_left(self.buckets, value)
            if idx < len(counts):
                counts[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def count(self, labels: Optional[Dict[str, str]] = None) -> int:
        return self._totals.get(self._key(labels), 0)

    def sum(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._sums.get(self._key(labels), 0.0)

    def quantile(self, q: float, labels: Optional[Dict[str, str]] = None) -> float:
        """Approximate quantile from bucket midpoints (observability aid)."""
        key = self._key(labels)
        with self._lock:
            counts = self._counts.get(key)
            total = self._totals.get(key, 0)
        if not counts or total == 0:
            return math.nan
        target = q * total
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= target:
                return self.buckets[i]
        return self.buckets[-1]

    def samples(self):
        out = []
        with self._lock:
            for key, counts in self._counts.items():
                cum = 0
                for b, c in zip(self.buckets, counts):
                    cum += c
                    out.append((f"{self.name}_bucket",
                                key + (("le", repr(b)),), cum))
                out.append((f"{self.name}_bucket", key + (("le", "+Inf"),),
                            self._totals[key]))
                out.append((f"{self.name}_sum", key, self._sums[key]))
                out.append((f"{self.name}_count", key, self._totals[key]))
        return out


class Registry:
    """A named collection of metric families with text exposition."""

    def __init__(self):
        self._lock = named_lock("metrics.registry")
        self._metrics: Dict[str, _Metric] = {}  # guarded-by: _lock
        self._collectors: list = []             # guarded-by: _lock

    def add_collector(self, fn) -> None:
        """Register a scrape-time refresher: called (outside the lock) at the
        top of expose().  Used for gauges derived from live state — per-node
        allocatable, pod phase counts — where eager per-event updates would
        be wasteful and stale-series cleanup is easiest done in one sweep."""
        with self._lock:
            self._collectors.append(fn)

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if type(existing) is not type(metric) or \
                        existing.label_names != metric.label_names:
                    raise ValueError(f"metric {metric.name} re-registered "
                                     "with a different schema")
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name, help_text="", labels=()) -> Counter:
        return self._register(Counter(name, help_text, labels))

    def gauge(self, name, help_text="", labels=()) -> Gauge:
        return self._register(Gauge(name, help_text, labels))

    def histogram(self, name, help_text="", labels=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram(name, help_text, labels, buckets))

    def get(self, name) -> Optional[_Metric]:
        return self._metrics.get(name)

    def reset(self):
        """Drop all families (per-suite test reset — the reference resets its
        registry between suites, pkg/test/environment.go:72-176)."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()

    def sample_all(self):
        """Every sample of every registered family, as a flat sorted list
        of ``(name, labelkv, value)`` — the flight recorder's history
        ring snapshots this on the injectable-clock cadence.  Scrape-time
        collectors are deliberately NOT run: they walk live cluster state
        (per-node gauges) and exist for the scrape path; the ring wants a
        cheap, side-effect-free pass over what the process already
        counted."""
        with self._lock:
            metrics = list(self._metrics.values())
        out = []
        for m in sorted(metrics, key=lambda m: m.name):
            out.extend(m.samples())
        return out

    def expose(self) -> str:
        """Prometheus text exposition format.  Families with a legacy
        alias (the reference ships BOTH API generations' names,
        metrics.md:30-195 — machines_* beside nodeclaims_*,
        deprovisioning_* beside disruption_*) are emitted twice: once
        under the current name and once, sample-for-sample, under the
        alias, so dashboards written against either generation scrape."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            fn()
        lines = []
        with self._lock:
            metrics = list(self._metrics.values())

        def emit(m, out_name):
            lines.append(f"# HELP {out_name} {m.help}")
            lines.append(f"# TYPE {out_name} {m.kind}")
            for name, labelkv, value in m.samples():
                name = out_name + name[len(m.name):]   # keeps _bucket/_sum
                if labelkv:
                    lbl = ",".join(f'{k}="{v}"' for k, v in labelkv)
                    lines.append(f"{name}{{{lbl}}} {value}")
                else:
                    lines.append(f"{name} {value}")

        for m in sorted(metrics, key=lambda m: m.name):
            emit(m, m.name)
            alias = LEGACY_ALIASES.get(m.name)
            if alias:
                emit(m, alias)
        return "\n".join(lines) + "\n"


# current-generation family → legacy (v1alpha5) alias, both served from
# one store (reference ships both name generations side by side)
LEGACY_ALIASES = {
    "karpenter_nodeclaims_created": "karpenter_machines_created",
    "karpenter_nodeclaims_disrupted": "karpenter_machines_disrupted",
    "karpenter_nodeclaims_drifted": "karpenter_machines_drifted",
    "karpenter_nodeclaims_initialized": "karpenter_machines_initialized",
    "karpenter_nodeclaims_launched": "karpenter_machines_launched",
    "karpenter_nodeclaims_registered": "karpenter_machines_registered",
    "karpenter_nodeclaims_terminated": "karpenter_machines_terminated",
    "karpenter_disruption_actions_performed_total":
        "karpenter_deprovisioning_actions_performed",
    "karpenter_disruption_consolidation_timeouts_total":
        "karpenter_deprovisioning_consolidation_timeouts",
    "karpenter_disruption_eligible_nodes":
        "karpenter_deprovisioning_eligible_machines",
    "karpenter_disruption_evaluation_duration_seconds":
        "karpenter_deprovisioning_evaluation_duration_seconds",
    "karpenter_disruption_replacement_nodeclaim_initialized_seconds":
        "karpenter_deprovisioning_replacement_machine_initialized_seconds",
    "karpenter_disruption_replacement_nodeclaim_failures_total":
        "karpenter_deprovisioning_replacement_machine_launch_failure_counter",
    "karpenter_nodepool_limit": "karpenter_provisioner_limit",
    "karpenter_nodepool_usage": "karpenter_provisioner_usage",
}

# Process-default registry + the parity-named families used across the
# framework (names follow metrics.md; subsystem prefix karpenter_).
REGISTRY = Registry()


def scheduling_duration() -> Histogram:
    return REGISTRY.histogram(
        "karpenter_provisioner_scheduling_duration_seconds",
        "Duration of one scheduling solve.")


def simulation_duration() -> Histogram:
    return REGISTRY.histogram(
        "karpenter_provisioner_scheduling_simulation_duration_seconds",
        "Duration of one consolidation simulation solve.")


def batch_size() -> Histogram:
    return REGISTRY.histogram(
        "karpenter_cloudprovider_batcher_batch_size",
        "Requests per batch window.", labels=("batcher",),
        buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1000))


def batch_window_duration() -> Histogram:
    return REGISTRY.histogram(
        "karpenter_cloudprovider_batcher_batch_time_seconds",
        "Batch window open duration.", labels=("batcher",))


def interruption_actions() -> Counter:
    """Actions taken for interruption messages (reference
    karpenter_interruption_actions_performed,
    pkg/controllers/interruption/metrics.go:36-62)."""
    return REGISTRY.counter(
        "karpenter_interruption_actions_performed",
        "Actions performed in response to interruption messages.",
        labels=("action",))


def interruption_received() -> Counter:
    return REGISTRY.counter(
        "karpenter_interruption_received_messages",
        "Interruption queue messages received.", labels=("message_type",))


def interruption_deleted() -> Counter:
    return REGISTRY.counter(
        "karpenter_interruption_deleted_messages",
        "Interruption queue messages deleted.")


def interruption_message_latency() -> Histogram:
    return REGISTRY.histogram(
        "karpenter_interruption_message_latency_time_seconds",
        "Age of interruption messages at processing time.",
        buckets=(1, 5, 10, 30, 60, 120, 300, 600))


def instance_type_cpu() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_cloudprovider_instance_type_cpu_cores",
        "VCPUs per instance type.", labels=("instance_type",))


def instance_type_memory() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_cloudprovider_instance_type_memory_bytes",
        "Memory per instance type.", labels=("instance_type",))


def instance_price_estimate() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_cloudprovider_instance_type_price_estimate",
        "Hourly price estimate per offering.",
        labels=("instance_type", "capacity_type", "zone"))


def nodeclaims_created() -> Counter:
    return REGISTRY.counter(
        "karpenter_nodeclaims_created",
        "NodeClaims launched.", labels=("nodepool",))


def nodeclaims_terminated() -> Counter:
    return REGISTRY.counter(
        "karpenter_nodeclaims_terminated",
        "NodeClaims terminated.", labels=("nodepool", "reason"))


def disruption_actions() -> Counter:
    return REGISTRY.counter(
        "karpenter_disruption_actions_performed_total",
        "Disruption actions executed.", labels=("action", "method"))


def disruption_replacement_initialized() -> Histogram:
    """Launch→live latency of disruption replacement nodes (reference
    karpenter_disruption_replacement_nodeclaim_initialized_seconds).  In
    this substrate replacements go live at registration, so the observed
    span is create-call → registered — the same boundary the fake cloud's
    launch path owns."""
    return REGISTRY.histogram(
        "karpenter_disruption_replacement_nodeclaim_initialized_seconds",
        "Time to initialize a disruption replacement node.",
        buckets=(0.01, 0.05, 0.1, 0.5, 1, 5, 15, 30, 60, 120, 300))


def pods_unschedulable() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_provisioner_pods_unschedulable",
        "Pods the last solve could not place.")


def disruption_evaluation_duration() -> Histogram:
    """Consolidation/disruption decision timing
    (reference karpenter_disruption_evaluation_duration_seconds,
    website/.../reference/metrics.md:30-195)."""
    return REGISTRY.histogram(
        "karpenter_disruption_evaluation_duration_seconds",
        "Duration of one disruption reconcile evaluation.",
        labels=("method",))


def consolidation_timeouts() -> Counter:
    return REGISTRY.counter(
        "karpenter_disruption_consolidation_timeouts_total",
        "Disruption evaluations that exceeded the consolidation budget.",
        labels=("method",))


def disruption_replacement_failures() -> Counter:
    return REGISTRY.counter(
        "karpenter_disruption_replacement_nodeclaim_failures_total",
        "Replacement launches that failed during disruption.",
        labels=("method",))


def disruption_eligible_nodes() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_disruption_eligible_nodes",
        "Nodes eligible for disruption at last evaluation.",
        labels=("method",))


def disruption_sweep_duration() -> Histogram:
    """Wall time of one batched consolidation sweep (arena build included
    on a miss), split by phase: `prefix` (all-prefix delete probe) vs
    `single` (per-candidate replacement screen)."""
    return REGISTRY.histogram(
        "karpenter_disruption_sweep_duration_seconds",
        "Duration of one batched consolidation sweep phase.",
        labels=("phase",),
        buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 5, 15))


def disruption_sweep_probes() -> Gauge:
    """Aggregate device solves the last consolidation tick issued — the
    number the batched sweep holds at ≤3 where the sequential path paid
    ~log₂N + 2N."""
    return REGISTRY.gauge(
        "karpenter_disruption_sweep_device_calls",
        "Aggregate kernel calls in the last consolidation evaluation.")


def disruption_arena_requests() -> Counter:
    """Simulation-arena cache traffic: `hit` (fingerprint unchanged, tensors
    reused) vs `build` (cluster changed, re-tensorized)."""
    return REGISTRY.counter(
        "karpenter_disruption_arena_requests_total",
        "Simulation arena lookups by outcome.",
        labels=("outcome",))


def arena_epoch() -> Gauge:
    """Monotone delta counter of the persistent cluster arena
    (ops/arena.py) — one bump per applied delta; consumers key staleness
    checks on it instead of re-fingerprinting the object graph."""
    return REGISTRY.gauge(
        "karpenter_arena_epoch",
        "Current epoch (applied-delta count) of the cluster arena.")


def arena_slots() -> Gauge:
    """Slab occupancy of the cluster arena: `live` rows vs `tombstone`
    rows awaiting compaction."""
    return REGISTRY.gauge(
        "karpenter_arena_slots",
        "Cluster-arena slab slots by state.",
        labels=("state",))


def arena_deltas() -> Counter:
    """Typed deltas applied to the cluster arena (pod_bind, pod_unbind,
    pod_add, pod_remove, node_add, node_remove, touch, offering, compact,
    rebuild, invalidate)."""
    return REGISTRY.counter(
        "karpenter_arena_deltas_total",
        "Deltas applied to the cluster arena, by kind.",
        labels=("kind",))


def arena_compactions() -> Counter:
    """Slab compactions — tombstone count crossed the compaction
    threshold and live rows were densified."""
    return REGISTRY.counter(
        "karpenter_arena_compactions_total",
        "Cluster-arena slab compactions.")


def arena_gather() -> Counter:
    """Arena gather outcomes: `warm` (slab served the request) vs
    `fallback` (caller re-tensorized from scratch — extra axes, untracked
    node, or explicit invalidation)."""
    return REGISTRY.counter(
        "karpenter_arena_gather_total",
        "Cluster-arena gather requests by outcome.",
        labels=("outcome",))


def shard_solves() -> Counter:
    """Partitioned-solve routing: `sharded` (the mesh ran the solve),
    `fallback` (the planner refused — one compatibility group, or the
    straddling residual exceeded the budget — and the single-device path
    ran), `skipped` (gate on but the batch was too small or the mesh has
    one device)."""
    return REGISTRY.counter(
        "karpenter_shard_solves_total",
        "Sharded-solve attempts by caller path and outcome.",
        labels=("path", "outcome"))


def shard_count() -> Gauge:
    """Shards the last partitioned solve ran across (mesh device count)."""
    return REGISTRY.gauge(
        "karpenter_shard_count",
        "Device shards used by the last partitioned solve.")


def shard_imbalance() -> Gauge:
    """Partition balance: heaviest shard's pod count over the mean — the
    scan is lockstep, so wall clock is the heaviest shard and this ratio
    IS the parallel-efficiency ceiling."""
    return REGISTRY.gauge(
        "karpenter_shard_imbalance_ratio",
        "Max-over-mean per-shard pod load of the last partition plan.")


def shard_residual_pods() -> Gauge:
    """Pods whose requirements straddle partitions (re-solved host-side
    after the mesh pass). Large values mean the zone/nodepool structure
    the planner exploits is absent and sharding buys little."""
    return REGISTRY.gauge(
        "karpenter_shard_reconcile_residual_pods",
        "Pods re-solved by host reconciliation after the sharded pass.")


def shard_residual_ratio() -> Gauge:
    """Straddling residual as a fraction of the batch (the megafleet
    acceptance bound is <0.01)."""
    return REGISTRY.gauge(
        "karpenter_shard_reconcile_residual_ratio",
        "Residual pods over total pods in the last partitioned solve.")


def shard_solve_duration() -> Histogram:
    """Partitioned-solve phase latency: `partition` (host planner),
    `solve` (mesh kernel + decode), `reconcile` (residual re-solve)."""
    return REGISTRY.histogram(
        "karpenter_shard_solve_duration_seconds",
        "Partitioned-solve phase duration.",
        labels=("phase",),
        buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 5, 15))


def decode_solves() -> Counter:
    """DeviceDecode routing: `device` (the slab assembled the plan),
    `fallback` (slab assembly failed; the legacy host decoder rebuilt the
    plan from the same kernel output), `suppressed` (the DecodeHealth
    breaker is open — host assembly without trying), `floor` (batch below
    ops/decode.DEVICE_DECODE_FLOOR).  Paths: `classpack` (single-device
    solve) and `driver` (partitioned mesh solve)."""
    return REGISTRY.counter(
        "karpenter_decode_solves_total",
        "Device-decode attempts by caller path and outcome.",
        labels=("path", "outcome"))


def decode_duration() -> Histogram:
    """Device-decode phase latency: `kernel` (slab emission + transfer)
    and `assemble` (columnar host assembly) — the breakdown that proves
    the per-pod host loop left the critical path."""
    return REGISTRY.histogram(
        "karpenter_decode_duration_seconds",
        "Device-decode phase duration.",
        labels=("phase",),
        buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 5))


def decode_demoted() -> Gauge:
    """1 while the DecodeHealth breaker holds device decode demoted to
    host assembly, 0 otherwise."""
    return REGISTRY.gauge(
        "karpenter_decode_demoted",
        "Whether device decode is currently demoted to host assembly.")


def decode_transitions() -> Counter:
    """DecodeHealth breaker transitions: event `demoted` (reason `error`
    or `timeout`) and `recovered` (half-open probe succeeded)."""
    return REGISTRY.counter(
        "karpenter_decode_transitions_total",
        "Device-decode breaker transitions.",
        labels=("event", "reason"))


def trace_span_duration() -> Histogram:
    """Duration of every completed tracing span (utils/tracing.py), labeled
    by span name — the histogram the /debug/traces timeline feeds so
    Grafana needs no new scrape target."""
    return REGISTRY.histogram(
        "karpenter_trace_span_duration_seconds",
        "Duration of one completed tracing span.",
        labels=("span",),
        buckets=(0.0005, 0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 5))


def trace_slow_spans() -> Counter:
    """Spans that crossed the --trace-slow-ms WARN threshold, by name."""
    return REGISTRY.counter(
        "karpenter_trace_slow_spans_total",
        "Spans slower than the configured slow-span threshold.",
        labels=("span",))


def provenance_records() -> Counter:
    """Unschedulable-pod provenance records written, by the first failing
    constraint (instance-type / nodepool / zone / capacity-type /
    requirement / resource / capacity / no-offerings)."""
    return REGISTRY.counter(
        "karpenter_provenance_records_total",
        "Pod scheduling-provenance records, by first failing constraint.",
        labels=("constraint",))


def disruption_candidates_truncated() -> Counter:
    """Candidates dropped by the max_candidates discovery cap — nonzero
    means 'swept everything' is NOT true for this cluster (no-silent-caps)."""
    return REGISTRY.counter(
        "karpenter_disruption_candidates_truncated_total",
        "Disruption candidates dropped by the max_candidates cap.")


def nodepool_usage() -> Gauge:
    """Per-pool resource usage (karpenter_nodepool_usage)."""
    return REGISTRY.gauge(
        "karpenter_nodepool_usage",
        "Resources launched per nodepool.",
        labels=("nodepool", "resource_type"))


def nodepool_limit() -> Gauge:
    """Per-pool resource limits (karpenter_nodepool_limit)."""
    return REGISTRY.gauge(
        "karpenter_nodepool_limit",
        "Configured resource limits per nodepool.",
        labels=("nodepool", "resource_type"))


def nodes_total() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_nodes_total",
        "Nodes managed, by pool.", labels=("nodepool",))


def pods_bound_duration() -> Histogram:
    return REGISTRY.histogram(
        "karpenter_pods_bound_duration_seconds",
        "Time from pod arrival to binding.")


def cloud_errors_total() -> Counter:
    return REGISTRY.counter(
        "karpenter_cloudprovider_errors_total",
        "Cloud API errors by classification.",
        labels=("classification",))


def nodeclaim_registration_duration() -> Histogram:
    """launch → kubelet join latency (reference
    karpenter_nodeclaims_registration_duration_seconds family)."""
    return REGISTRY.histogram(
        "karpenter_nodeclaims_registration_duration_seconds",
        "Time from launch to node registration.",
        buckets=(1, 5, 15, 30, 60, 120, 300, 600, 900))


def nodeclaim_initialization_duration() -> Histogram:
    return REGISTRY.histogram(
        "karpenter_nodeclaims_initialization_duration_seconds",
        "Time from registration to node initialization.",
        buckets=(1, 5, 15, 30, 60, 120, 300, 600, 900))


def termination_duration() -> Histogram:
    """drain start → instance gone (reference
    karpenter_nodes_termination_time_seconds family)."""
    return REGISTRY.histogram(
        "karpenter_nodes_termination_time_seconds",
        "Time from drain request to instance termination.",
        buckets=(1, 5, 15, 30, 60, 120, 300, 600, 1800))


def nodeclaims_launched() -> Counter:
    """Cloud instance actually launched for a claim (reference
    karpenter_nodeclaims_launched; created counts the claim object)."""
    return REGISTRY.counter(
        "karpenter_nodeclaims_launched",
        "NodeClaims whose instance launched.", labels=("nodepool",))


def nodeclaims_registered() -> Counter:
    return REGISTRY.counter(
        "karpenter_nodeclaims_registered",
        "NodeClaims whose node joined the cluster.", labels=("nodepool",))


def nodeclaims_initialized() -> Counter:
    return REGISTRY.counter(
        "karpenter_nodeclaims_initialized",
        "NodeClaims whose node passed initialization.", labels=("nodepool",))


def nodeclaims_disrupted() -> Counter:
    """Per disruption-method claim churn (reference
    karpenter_nodeclaims_disrupted with type label)."""
    return REGISTRY.counter(
        "karpenter_nodeclaims_disrupted",
        "NodeClaims disrupted, by method.", labels=("type", "nodepool"))


def nodeclaims_drifted() -> Counter:
    """First-detection drift transitions, not per-tick re-observations."""
    return REGISTRY.counter(
        "karpenter_nodeclaims_drifted",
        "NodeClaims that drifted from their nodepool/nodeclass spec.",
        labels=("nodepool",))


def nodes_created() -> Counter:
    return REGISTRY.counter(
        "karpenter_nodes_created",
        "Nodes created from NodeClaims.", labels=("nodepool",))


def nodes_terminated() -> Counter:
    return REGISTRY.counter(
        "karpenter_nodes_terminated",
        "Nodes removed from the cluster.", labels=("nodepool",))


def consistency_errors() -> Counter:
    """Cloud/cluster state mismatches the GC repaired (reference
    karpenter_consistency_errors): leaked instances, orphaned nodes."""
    return REGISTRY.counter(
        "karpenter_consistency_errors",
        "State inconsistencies detected.", labels=("check",))


def cloudprovider_duration() -> Histogram:
    return REGISTRY.histogram(
        "karpenter_cloudprovider_duration_seconds",
        "Cloud API call latency by method.", labels=("method",),
        buckets=(.001, .005, .01, .05, .1, .5, 1, 5, 15, 60))


def pods_startup_time() -> Histogram:
    """Pod arrival → running on an initialized node (reference
    karpenter_pods_startup_time_seconds)."""
    return REGISTRY.histogram(
        "karpenter_pods_startup_time_seconds",
        "Time from pod arrival to running on a ready node.",
        buckets=(1, 5, 15, 30, 60, 120, 300, 600, 900))


def pods_state() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_pods_state",
        "Pods known to the scheduler, by phase.", labels=("phase",))


def nodes_allocatable() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_nodes_allocatable",
        "Allocatable capacity per node.",
        labels=("node_name", "nodepool", "resource_type"))


def nodes_pod_requests() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_nodes_total_pod_requests",
        "Sum of scheduled pod requests per node.",
        labels=("node_name", "nodepool", "resource_type"))


def nodes_pod_limits() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_nodes_total_pod_limits",
        "Sum of scheduled pod limits per node.",
        labels=("node_name", "nodepool", "resource_type"))


def nodes_daemon_requests() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_nodes_total_daemon_requests",
        "Sum of daemonset pod requests per node.",
        labels=("node_name", "nodepool", "resource_type"))


def nodes_daemon_limits() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_nodes_total_daemon_limits",
        "Sum of daemonset pod limits per node.",
        labels=("node_name", "nodepool", "resource_type"))


def nodes_system_overhead() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_nodes_system_overhead",
        "Capacity minus allocatable per node (kube/system reserved + "
        "eviction threshold).",
        labels=("node_name", "nodepool", "resource_type"))


def nodepool_usage_pct() -> Gauge:
    """Legacy karpenter_provisioner_usage_pct (v1alpha5): usage as a
    percentage of the pool's limit, computed where usage/limit are set."""
    return REGISTRY.gauge(
        "karpenter_provisioner_usage_pct",
        "Nodepool usage as a percentage of its limit (legacy alias).",
        labels=("nodepool", "resource_type"))


def controller_reconciles() -> Counter:
    return REGISTRY.counter(
        "controller_runtime_reconcile_total",
        "Reconciles per controller.", labels=("controller",))


def controller_reconcile_errors() -> Counter:
    return REGISTRY.counter(
        "controller_runtime_reconcile_errors_total",
        "Reconcile errors per controller.", labels=("controller",))


def controller_reconcile_time() -> Histogram:
    return REGISTRY.histogram(
        "controller_runtime_reconcile_time_seconds",
        "Reconcile latency per controller.", labels=("controller",))


def controller_active_workers() -> Gauge:
    return REGISTRY.gauge(
        "controller_runtime_active_workers",
        "Workers currently reconciling (singleton loops: 0 or 1).",
        labels=("controller",))


def controller_max_concurrent() -> Gauge:
    return REGISTRY.gauge(
        "controller_runtime_max_concurrent_reconciles",
        "Configured concurrency per controller (singleton loops: 1).",
        labels=("controller",))


def lpguide_requests() -> Counter:
    """Guide cache outcome per guided solve: path=warm (exact mix-cache
    hit), stale (rescaled old mix within the staleness window), cold
    (miss — greedy this tick, refinery enqueued, or the synchronous LP
    when no refinery is wired).  Hit ratio = (warm+stale) / total."""
    return REGISTRY.counter(
        "karpenter_lpguide_guide_requests",
        "Guided solves by mix-cache path (warm/stale/cold).",
        labels=("path",))


def lp_solves() -> Counter:
    """Device LP solves by outcome: converged (KKT score under tolerance),
    cap (iteration cap landed first — the instance's result is discarded
    and the caller re-solves on the fallback rung), demoted (a caller
    fell back to the HiGHS rung because the DeviceLP ladder was down).
    The outcome label is closed: {converged, cap, demoted}."""
    return REGISTRY.counter(
        "karpenter_lp_solves_total",
        "PDHG LP solves by outcome (converged/cap/demoted).",
        labels=("outcome",))


def lp_iterations() -> Histogram:
    return REGISTRY.histogram(
        "karpenter_lp_iterations",
        "PDHG iterations per LP instance at exit.",
        buckets=(32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 20000))


def lp_restarts() -> Histogram:
    return REGISTRY.histogram(
        "karpenter_lp_restarts",
        "PDHG average-iterate restarts per LP instance at exit.",
        buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128))


def lp_residuals() -> Gauge:
    """Worst relative KKT residual across the last batch, by kind
    (primal infeasibility / dual infeasibility / duality gap) — the
    convergence margin the ladder's demotion decisions key off."""
    return REGISTRY.gauge(
        "karpenter_lp_residual",
        "Relative KKT residuals at exit of the last LP batch.",
        labels=("kind",))


def lp_batch_size() -> Histogram:
    return REGISTRY.histogram(
        "karpenter_lp_batch_size",
        "Instances per batched LP dispatch (vmap axis width).",
        buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))


def refinery_queue_depth() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_lpguide_refinery_queue_depth",
        "Refine jobs queued or running in the LP-guide refinery.")


def refinery_refine_duration() -> Histogram:
    return REGISTRY.histogram(
        "karpenter_lpguide_refinery_refine_duration_seconds",
        "Wall time of one background mix refinement (colgen LP + greedy "
        "price probe).",
        buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30))


def refinery_cost_delta() -> Counter:
    """Cost improvement the refinery realized: Σ (greedy price − refined
    LP objective) over refinements whose saving cleared the upgrade
    threshold — the $/h the NEXT tick's guided solve recovers vs the
    greedy plan the cold tick shipped."""
    return REGISTRY.counter(
        "karpenter_lpguide_refinery_cost_delta_realized",
        "Aggregate $/h saving of refined mixes over the greedy baseline.")


def refinery_errors() -> Counter:
    return REGISTRY.counter(
        "karpenter_lpguide_refinery_errors",
        "Refinery degradations by reason (exception/queue_full).",
        labels=("reason",))


def make_cluster_collector(cluster, lock=None):
    """Scrape-time collector for per-node and pod-phase gauges: refreshes
    karpenter_nodes_{allocatable, system_overhead, total_pod_requests,
    total_pod_limits, total_daemon_requests, total_daemon_limits} and
    karpenter_pods_state from live cluster state, deleting series for
    nodes that have since terminated.

    `lock` is the tick loop's state lock (advisor r4: collectors run on
    /metrics HTTP threads, and sweeping cluster.pods/node.pods while a
    tick binds or removes raises mid-iteration); a private lock guards
    prev_keys against concurrent scrapes."""
    import contextlib
    prev_keys: set = set()
    my_lock = named_lock("metrics.collector")

    FAMS = {"a": nodes_allocatable, "o": nodes_system_overhead,
            "r": nodes_pod_requests, "l": nodes_pod_limits,
            "dr": nodes_daemon_requests, "dl": nodes_daemon_limits}

    def collect():
        nonlocal prev_keys
        gauges = {k: f() for k, f in FAMS.items()}
        state_g = pods_state()
        cur: set = set()
        with my_lock, (lock if lock is not None
                       else contextlib.nullcontext()):
            pending = bound = 0
            for p in cluster.pods.values():
                if p.node_name:
                    bound += 1
                else:
                    pending += 1
            state_g.set(pending, {"phase": "pending"})
            state_g.set(bound, {"phase": "running"})
            from ..api.resources import ResourceList as _RL

            def put(kind, base, rl):
                for res, qty in rl.items():
                    gauges[kind].set(qty, {**base, "resource_type": res})
                    cur.add((kind, base["node_name"], base["nodepool"], res))

            for n in list(cluster.nodes.values()):
                base = {"node_name": n.name, "nodepool": n.nodepool or ""}
                put("a", base, n.allocatable)
                put("o", base,
                    (n.capacity - n.allocatable).clamp_nonnegative()
                    if n.capacity else _RL())
                req, lim, dreq, dlim = _RL(), _RL(), _RL(), _RL()
                for p in n.pods:
                    req = req + p.requests
                    lim = lim + p.limits
                    if p.is_daemon:
                        dreq = dreq + p.requests
                        dlim = dlim + p.limits
                put("r", base, req)
                put("l", base, lim)
                put("dr", base, dreq)
                put("dl", base, dlim)
            # sorted: stale-series deletion order must not depend on set
            # hashing (graftlint DT003)
            for kind, name, pool, res in sorted(prev_keys - cur):
                gauges[kind].delete({"node_name": name, "nodepool": pool,
                                     "resource_type": res})
            prev_keys = cur

    return collect


def register_parity_families() -> None:
    """Touch every parity-named family so one scrape exposes the complete
    schema from process start (standard Prometheus-client practice: zero
    samples beat absent families for dashboards and alerts).  Called by
    the operator at startup; tests use it to assert the reference's
    metrics page is served in full."""
    import inspect
    import sys
    mod = sys.modules[__name__]
    for name, fn in vars(mod).items():
        if name in ("make_cluster_collector", "register_parity_families"):
            continue
        if not inspect.isfunction(fn):
            continue
        sig = inspect.signature(fn)
        if sig.parameters:
            continue
        ret = sig.return_annotation
        if ret in ("Counter", "Gauge", "Histogram", Counter, Gauge, Histogram):
            fn()


# ---------------------------------------------------------------------------
# Simulation families (sim/) — populated only by sim runs;
# zero-sample on a live operator like any other pre-registered family.
# ---------------------------------------------------------------------------

def sim_events_delivered() -> Counter:
    return REGISTRY.counter(
        "karpenter_sim_events_delivered_total",
        "Scenario events delivered by the simulation harness, by kind.",
        labels=("kind",))


def sim_virtual_time_speedup() -> Gauge:
    """Virtual seconds replayed per wall second in the most recent sim run
    — wall-clock derived, so it feeds metrics/bench output and never the
    deterministic report JSON."""
    return REGISTRY.gauge(
        "karpenter_sim_virtual_time_speedup",
        "Virtual seconds per wall second for the last simulation run.")


def sim_reclaim_warnings() -> Counter:
    return REGISTRY.counter(
        "karpenter_sim_reclaim_warnings_total",
        "Spot-interruption warnings delivered ahead of scheduled reclaims.")


def sim_reclaims() -> Counter:
    return REGISTRY.counter(
        "karpenter_sim_reclaims_total",
        "Scheduled spot reclaims fired, by whether the warning was honored "
        "(capacity already drained when the deadline hit).",
        labels=("honored",))


def sim_reclaim_honor_rate() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_sim_reclaim_warning_honor_rate",
        "Fraction of scheduled reclaims drained before their deadline in "
        "the last simulation run.")


# ---------------------------------------------------------------------------
# Forecast families (forecast/) — populated only with the
# Forecast gate on; zero-sample otherwise like any pre-registered family.
# ---------------------------------------------------------------------------

def forecast_demand_upper() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_forecast_demand_upper",
        "Upper confidence band of forecast demand (pod concurrency) over "
        "the headroom window, per pod class.",
        labels=("pod_class",))


def forecast_headroom_pods() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_forecast_headroom_pods",
        "Live headroom placeholder pods (pending + bound, unexpired).")


def forecast_placeholders() -> Counter:
    return REGISTRY.counter(
        "karpenter_forecast_placeholders_total",
        "Headroom placeholder lifecycle transitions, by outcome "
        "(issued | trimmed | expired | preempted).",
        labels=("outcome",))


def forecast_spot_risk() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_forecast_spot_risk",
        "Posterior spot reclaim rate (reclaims per spot node-hour) per "
        "nodepool, from the headroom controller's risk prior.",
        labels=("nodepool",))


def forecast_model_residual() -> Histogram:
    return REGISTRY.histogram(
        "karpenter_forecast_model_residual",
        "Absolute one-step forecast residual (pods) per reconcile, by "
        "model — the online goodness-of-fit signal.",
        labels=("model",),
        buckets=(0.5, 1, 2, 5, 10, 25, 50, 100))


def forecast_series_observations() -> Counter:
    return REGISTRY.counter(
        "karpenter_forecast_series_observations_total",
        "Demand-series observations ingested from the cluster observer "
        "hook, by kind (arrival | departure | bind).",
        labels=("kind",))


# --- robustness: supervision, watchdogs, degradation, chaos ----------------

def supervisor_state() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_supervisor_circuit_state",
        "Per-controller supervisor circuit: 0=closed, 1=half_open, 2=open.",
        labels=("controller",))


def supervisor_consecutive_failures() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_supervisor_consecutive_failures",
        "Consecutive reconcile failures per controller since last success.",
        labels=("controller",))


def supervisor_backoff_skips() -> Counter:
    return REGISTRY.counter(
        "karpenter_supervisor_backoff_skips_total",
        "Reconcile attempts skipped per controller while inside a "
        "crash-loop backoff or open-circuit window.",
        labels=("controller",))


def supervisor_quarantines() -> Counter:
    return REGISTRY.counter(
        "karpenter_supervisor_quarantines_total",
        "Circuit-open events per controller (crash loop crossed the "
        "consecutive-failure threshold).",
        labels=("controller",))


def watchdog_trips() -> Counter:
    return REGISTRY.counter(
        "karpenter_watchdog_trips_total",
        "Hard-deadline watchdog trips by guarded phase (the call was "
        "abandoned and the degradation ladder notified).",
        labels=("phase",))


def degradation_transitions() -> Counter:
    return REGISTRY.counter(
        "karpenter_degradation_transitions_total",
        "Solver degradation-ladder transitions: demotions "
        "(reason=timeout|error) and half-open recoveries "
        "(reason=recovered, from==to).",
        labels=("from", "to", "reason"))


def degradation_rung() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_degradation_active_rung",
        "Best currently-healthy solver rung as a ladder index "
        "(0=sharded, 1=jax, 2=native, 3=greedy).")


def cloud_retries() -> Counter:
    return REGISTRY.counter(
        "karpenter_cloudprovider_retries_total",
        "Cloud API retry attempts by method and outcome "
        "(retried | recovered | exhausted).",
        labels=("method", "outcome"))


def cloud_breaker_state() -> Gauge:
    return REGISTRY.gauge(
        "karpenter_cloudprovider_circuit_state",
        "Provider-level circuit breaker: 0=closed, 1=half_open, 2=open.")


def cloud_breaker_opens() -> Counter:
    return REGISTRY.counter(
        "karpenter_cloudprovider_circuit_opens_total",
        "Provider circuit-breaker open events (error storm detected; "
        "launches fast-fail into the ICE/backoff path for the cooldown).")


def chaos_injections() -> Counter:
    return REGISTRY.counter(
        "karpenter_chaos_injections_total",
        "Faults injected by the chaos harness, by point and action.",
        labels=("point", "action"))


# --- durability: state snapshots + ingestion batching ----------------------

def snapshot_writes() -> Counter:
    """State-snapshot write attempts (state/snapshot.py), by outcome:
    `ok` or `error` (serialization/IO failure — the previous snapshot
    file survives untouched because writes are tmp+rename atomic)."""
    return REGISTRY.counter(
        "karpenter_snapshot_writes_total",
        "Operator state-snapshot writes by outcome.",
        labels=("outcome",))


def snapshot_write_duration() -> Histogram:
    """Wall time of one snapshot write (serialize under the state lock +
    atomic file replace)."""
    return REGISTRY.histogram(
        "karpenter_snapshot_write_duration_seconds",
        "Duration of operator state-snapshot writes.")


def snapshot_size() -> Gauge:
    """Size of the last written snapshot file in bytes."""
    return REGISTRY.gauge(
        "karpenter_snapshot_size_bytes",
        "Bytes in the most recent operator state snapshot.")


def snapshot_restores() -> Counter:
    """Warm-restore attempts, by outcome: `restored` (warm resume), or a
    counted cold-fallback reason — `missing`, `bad_magic`, `bad_version`,
    `bad_checksum`, `epoch_mismatch`, `apply_error`."""
    return REGISTRY.counter(
        "karpenter_snapshot_restores_total",
        "Operator state-snapshot restore attempts by outcome.",
        labels=("outcome",))


def snapshot_age() -> Gauge:
    """Clock age of the restored snapshot at restore time (how much
    event history the warm resume had to catch up on)."""
    return REGISTRY.gauge(
        "karpenter_snapshot_age_seconds",
        "Age of the snapshot consumed by the last warm restore.")


def ingest_events() -> Counter:
    """Cluster events absorbed by the ingestion batcher (state/ingest.py)
    between ticks, by kind (node_add, node_remove, touch, pod_bind,
    pod_unbind, pod_add, pod_remove, offering)."""
    return REGISTRY.counter(
        "karpenter_ingest_events_total",
        "Events coalesced by the ingestion batcher, by kind.",
        labels=("kind",))


def ingest_flushes() -> Counter:
    """Batched flushes applied to the arena — the coalescing ratio is
    karpenter_ingest_events_total / karpenter_ingest_flushes_total."""
    return REGISTRY.counter(
        "karpenter_ingest_flushes_total",
        "Ingestion-batcher flushes applied to the cluster arena.")


def ingest_pending() -> Gauge:
    """Coalesced events pending in the batcher right now (drops to 0 at
    every flush)."""
    return REGISTRY.gauge(
        "karpenter_ingest_pending_events",
        "Events currently pending in the ingestion batcher.")


def ingest_overflows() -> Counter:
    """Backpressure degradations: pending events crossed the overflow cap
    and the batcher fell back to a full arena rebuild (events are folded
    into the rebuild, never dropped)."""
    return REGISTRY.counter(
        "karpenter_ingest_overflows_total",
        "Ingestion-batcher overflow degradations to full rebuild.")


# --- HA: fenced leadership + readiness lifecycle ---------------------------

def leader_transitions() -> Counter:
    """Leadership lifecycle events on this replica: `acquired` (won the
    lease with a bumped fencing epoch), `lost` (another holder's
    unexpired lease, or a lease-read failure deposed us), `released`
    (graceful SIGTERM handover expired our own lease)."""
    return REGISTRY.counter(
        "karpenter_leader_transitions_total",
        "Leader-election transitions on this replica, by event.",
        labels=("event",))


def leader_fence_epoch() -> Gauge:
    """The monotone fencing epoch this replica last acquired the lease
    with (0 = never led).  Strictly increases across failovers; every
    guarded snapshot/cloud write validates against it."""
    return REGISTRY.gauge(
        "karpenter_leader_fence_epoch",
        "Fencing epoch of this replica's last lease acquisition.")


def leader_fence_refusals() -> Counter:
    """Guarded mutations refused because the fencing epoch was stale, by
    operation (`snapshot` | `launch` | `terminate`).  Nonzero here is the
    split-brain invariant WORKING: a deposed writer attempted the
    mutation and was stopped."""
    return REGISTRY.counter(
        "karpenter_leader_fence_refusals_total",
        "Stale-fence refusals of guarded mutations, by operation.",
        labels=("op",))


def leader_lease_errors() -> Counter:
    """Lease I/O failures during acquire/renew (including injected
    `leader.lease` chaos).  Each one deposes the replica for that tick —
    an unreadable lease cannot prove leadership."""
    return REGISTRY.counter(
        "karpenter_leader_lease_errors_total",
        "Lease read/write failures treated as loss of leadership.")


def leader_midtick_aborts() -> Counter:
    """Ticks aborted before their mutating phase because the lease had
    less than zero remaining mid-tick — the guard that keeps a long tick
    from outliving its lease into a launch or snapshot."""
    return REGISTRY.counter(
        "karpenter_leader_midtick_aborts_total",
        "Ticks aborted mid-flight on an expired lease.")


def ready_state() -> Gauge:
    """Readiness state machine (operator/manager.py): 1 for the current
    phase, 0 for the rest.  Phases: STARTING, RESTORING, PROBING,
    LEADING, STANDBY, DRAINING."""
    return REGISTRY.gauge(
        "karpenter_ready_state",
        "Readiness lifecycle phase (1 = current), by phase.",
        labels=("phase",))


def ready_transitions() -> Counter:
    """Entries into each readiness phase; `LEADING` entries from
    `STANDBY` are promotions (a failover completing)."""
    return REGISTRY.counter(
        "karpenter_ready_transitions_total",
        "Readiness-phase entries, by target phase.",
        labels=("phase",))


def ready_probes() -> Counter:
    """Arena parity probes run during PROBING, by outcome: `ok` (restored
    gather is bit-identical to a cold tensorize on the sample),
    `mismatch` (arena invalidated, cold rebuild before serving), or
    `skipped` (no arena / nothing restored to prove)."""
    return REGISTRY.counter(
        "karpenter_ready_probes_total",
        "Readiness arena parity probes, by outcome.",
        labels=("outcome",))


# ---------------------------------------------------------------------------
# Flight-recorder families (docs/observability.md) — the recorder only
# touches these while the FlightRecorder gate is armed, so a gate-off
# process never materializes the series.
# ---------------------------------------------------------------------------

def incident_bundles() -> Counter:
    """Forensic bundles captured by the flight recorder, by incident
    kind (`obs/incidents.py INCIDENT_KINDS` — the label set is a closed
    registry, like chaos points and watchdog phases)."""
    return REGISTRY.counter(
        "karpenter_incident_bundles_total",
        "Forensic incident bundles captured, by kind.",
        labels=("kind",))


def incident_suppressed() -> Counter:
    """Trip-site publishes deduplicated inside the per-kind rate-limit
    window — a chaos storm re-tripping the same circuit every tick
    increments this, not the bundle counter."""
    return REGISTRY.counter(
        "karpenter_incident_suppressed_total",
        "Incident publishes suppressed by per-kind dedup, by kind.",
        labels=("kind",))


def incident_write_errors() -> Counter:
    """Bundle disk writes that failed (capture degraded to memory-only;
    the incident record survives in-process, durability was lost)."""
    return REGISTRY.counter(
        "karpenter_incident_write_errors_total",
        "Incident bundle disk-write failures (memory-only fallback).")


def obs_ring_samples() -> Counter:
    """Metric-history ring samples actually taken (cadence gate passed)."""
    return REGISTRY.counter(
        "karpenter_obs_ring_samples_total",
        "Metric time-series ring samples taken.")


def obs_ring_entries() -> Gauge:
    """Samples currently held in the bounded history ring (saturates at
    the configured slot count in steady state)."""
    return REGISTRY.gauge(
        "karpenter_obs_ring_entries",
        "Samples currently held in the metric history ring.")


# ---------------------------------------------------------------------------
# SLO-engine + cost-ledger families (docs/observability.md) — only touched
# while the SLOEngine gate is armed, so a gate-off process never
# materializes the series.  All label sets are closed registries: SLI
# names from obs/slo.py DEFAULT_SLIS, window strings from
# BURN_WINDOW_PAIRS, decision sources from obs/ledger.py
# DECISION_SOURCES.
# ---------------------------------------------------------------------------

def slo_budget_remaining() -> Gauge:
    """Fraction of each SLO's error budget still unspent (1.0 = clean,
    negative = objective blown), by SLI name."""
    return REGISTRY.gauge(
        "karpenter_slo_error_budget_remaining",
        "Unspent error-budget fraction per SLO.",
        labels=("slo",))


def slo_burn_rate() -> Gauge:
    """Burn rate per SLO per evaluation window (1.0 = spending exactly
    the sustainable budget; the 5m/1h alert pair trips at 14.4x)."""
    return REGISTRY.gauge(
        "karpenter_slo_burn_rate",
        "Error-budget burn rate per SLO and window.",
        labels=("slo", "window"))


def slo_evaluations() -> Counter:
    """SLO recording-rule evaluation passes over the metric ring."""
    return REGISTRY.counter(
        "karpenter_slo_evaluations_total",
        "SLO engine evaluation passes.")


def slo_burn_alerts() -> Counter:
    """Multi-window burn-alert activations (the edge that publishes an
    `slo_burn` incident), by SLI name."""
    return REGISTRY.counter(
        "karpenter_slo_burn_alerts_total",
        "Burn-rate alert activations per SLO.",
        labels=("slo",))


def ledger_entries() -> Counter:
    """Cost-ledger entries appended, by decision source (provisioning,
    consolidation, interruption, spot_reclaim, headroom, …)."""
    return REGISTRY.counter(
        "karpenter_ledger_entries_total",
        "Cost-ledger entries appended, by decision source.",
        labels=("decision_source",))


def ledger_open_entries() -> Gauge:
    """Ledger entries still open — instances running with their $·h
    accrual unsettled."""
    return REGISTRY.gauge(
        "karpenter_ledger_open_entries",
        "Cost-ledger entries currently open.")


def ledger_drift_alerts() -> Counter:
    """Expected-vs-realized $·h drift detector activations (the edge
    that publishes a `cost_drift` incident), by nodepool."""
    return REGISTRY.counter(
        "karpenter_ledger_drift_alerts_total",
        "Cost-drift detector activations, by nodepool.",
        labels=("nodepool",))


def gang_admissions() -> Counter:
    """Gangs admitted whole (every member bound in one solve within one
    topology domain), by priority tier (GangScheduling, ops/gang.py)."""
    return REGISTRY.counter(
        "karpenter_gang_admissions_total",
        "Gangs admitted all-or-nothing, by priority tier.",
        labels=("tier",))


def gang_rejections() -> Counter:
    """Gang admission rejections, by reason (`incomplete` — fewer members
    arrived than declared, `partial` — some members unplaceable,
    `straddle` — placement crossed topology domains).  A trip family
    (graftlint OB006): every increment publishes a `gang_rejected`
    incident in the same function."""
    return REGISTRY.counter(
        "karpenter_gang_rejections_total",
        "Gang admission rejections, by reason.",
        labels=("reason",))


def gang_partial_placeable() -> Gauge:
    """Gangs whose last solve placed some but not all members — the
    capacity shortfall signal preemption and operators act on."""
    return REGISTRY.gauge(
        "karpenter_gang_partial_placeable",
        "Gangs currently partially placeable (some members fit).")


def gang_preemptions() -> Counter:
    """Pods evicted on behalf of a waiting higher-tier gang, by the
    VICTIM's tier (always strictly below the gang's)."""
    return REGISTRY.counter(
        "karpenter_gang_preemptions_total",
        "Pods preempted for higher-tier gangs, by victim tier.",
        labels=("tier",))


def gang_solve_duration() -> Histogram:
    """Wall time of the post-solve gang admission funnel (audit + strip +
    preemption planning) per solve."""
    return REGISTRY.histogram(
        "karpenter_gang_solve_duration_seconds",
        "Gang admission audit duration per solve.",
        buckets=(.0005, .002, .01, .05, .2, 1.0))
