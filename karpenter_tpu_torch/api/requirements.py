"""Set-based scheduling requirements.

Re-implements the semantics of karpenter-core's `scheduling.Requirements`
(the contract visible at karpenter:pkg/cloudprovider/cloudprovider.go:260-265
and karpenter:pkg/providers/instancetype/types.go:77-155): a map of
label key → set-valued requirement supporting In/NotIn/Exists/DoesNotExist/
Gt/Lt, with `intersect` and `compatible` set operations.

Requirements are the *host-side* constraint language.  The tensorization
layer (karpenter_tpu_torch.ops.tensorize) lowers a pod's requirements against
a catalog into a dense boolean `C×O` compatibility mask once per batch, so no
per-pod set algebra happens inside the device kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Mapping, Optional, Sequence, Set, Tuple

# Operators (K8s NodeSelectorOperator surface).
IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"
GT = "Gt"
LT = "Lt"


class Requirement:
    """One key's requirement as a (possibly complemented) value set plus an
    optional numeric window — the same representation karpenter-core uses so
    that all six operators reduce to set algebra."""

    __slots__ = ("key", "complement", "values", "greater_than", "less_than", "min_values")

    def __init__(self, key: str, operator: str = EXISTS,
                 values: Iterable[str] = (), min_values: Optional[int] = None):
        self.key = key
        self.greater_than: Optional[int] = None
        self.less_than: Optional[int] = None
        self.min_values = min_values
        vals = [str(v) for v in values]
        if operator == IN:
            self.complement, self.values = False, set(vals)
        elif operator == NOT_IN:
            self.complement, self.values = True, set(vals)
        elif operator == EXISTS:
            self.complement, self.values = True, set()
        elif operator == DOES_NOT_EXIST:
            self.complement, self.values = False, set()
        elif operator == GT:
            self.complement, self.values = True, set()
            self.greater_than = int(vals[0])
        elif operator == LT:
            self.complement, self.values = True, set()
            self.less_than = int(vals[0])
        else:
            raise ValueError(f"unknown operator {operator!r}")

    # ---- constructors ----
    @classmethod
    def raw(cls, key: str, complement: bool, values: Set[str],
            greater_than=None, less_than=None, min_values=None) -> "Requirement":
        r = cls.__new__(cls)
        r.key, r.complement, r.values = key, complement, set(values)
        r.greater_than, r.less_than, r.min_values = greater_than, less_than, min_values
        return r

    # ---- numeric window ----
    def _in_window(self, v: str) -> bool:
        if self.greater_than is not None or self.less_than is not None:
            try:
                n = int(v)
            except ValueError:
                return False
            if self.greater_than is not None and not n > self.greater_than:
                return False
            if self.less_than is not None and not n < self.less_than:
                return False
        return True

    def has(self, value: str) -> bool:
        value = str(value)
        base = (value not in self.values) if self.complement else (value in self.values)
        return base and self._in_window(value)

    def allows_anything(self) -> bool:
        return (self.complement and not self.values
                and self.greater_than is None and self.less_than is None)

    def intersect(self, other: "Requirement") -> "Requirement":
        gt = max((x for x in (self.greater_than, other.greater_than) if x is not None), default=None)
        lt = min((x for x in (self.less_than, other.less_than) if x is not None), default=None)
        if self.complement and other.complement:
            out = Requirement.raw(self.key, True, self.values | other.values, gt, lt)
        elif self.complement:
            out = Requirement.raw(self.key, False, {v for v in other.values if v not in self.values}, gt, lt)
        elif other.complement:
            out = Requirement.raw(self.key, False, {v for v in self.values if v not in other.values}, gt, lt)
        else:
            out = Requirement.raw(self.key, False, self.values & other.values, gt, lt)
        if not out.complement:  # prune values outside the numeric window
            out.values = {v for v in out.values if out._in_window(v)}
            out.greater_than = out.less_than = None
        out.min_values = max((x for x in (self.min_values, other.min_values) if x is not None), default=None)
        return out

    def intersects(self, other: "Requirement") -> bool:
        r = self.intersect(other)
        if r.complement:
            return True  # complement sets are infinite
        return bool(r.values)

    def any(self) -> Optional[str]:
        """A representative allowed value (None if complemented/empty)."""
        if self.complement:
            return None
        return min(self.values) if self.values else None

    def __repr__(self):
        if self.allows_anything():
            return f"{self.key} Exists"
        op = "NotIn" if self.complement else "In"
        win = ""
        if self.greater_than is not None:
            win += f" >{self.greater_than}"
        if self.less_than is not None:
            win += f" <{self.less_than}"
        return f"{self.key} {op} {sorted(self.values)}{win}"

    def __eq__(self, other):
        return (isinstance(other, Requirement) and self.key == other.key
                and self.complement == other.complement and self.values == other.values
                and self.greater_than == other.greater_than and self.less_than == other.less_than)

    def __hash__(self):
        return hash((self.key, self.complement, frozenset(self.values),
                     self.greater_than, self.less_than))


class Requirements(dict):
    """key → Requirement with karpenter-core's set operations."""

    @classmethod
    def of(cls, *reqs: Requirement) -> "Requirements":
        out = cls()
        out.add(*reqs)
        return out

    @classmethod
    def from_labels(cls, labels: Mapping[str, str]) -> "Requirements":
        return cls.of(*(Requirement(k, IN, [v]) for k, v in labels.items()))

    @classmethod
    def from_node_selector_terms(cls, terms: Sequence[Mapping]) -> "Requirements":
        """Flattens a list of {key, operator, values} dicts (one AND-term)."""
        return cls.of(*(Requirement(t["key"], t.get("operator", IN),
                                    t.get("values", []), t.get("minValues"))
                        for t in terms))

    def add(self, *reqs: Requirement) -> None:
        for r in reqs:
            self[r.key] = self[r.key].intersect(r) if r.key in self else r

    def union(self, other: "Requirements") -> "Requirements":
        out = Requirements(self)
        for r in other.values():
            out.add(r)
        return out

    def compatible(self, provided: "Requirements",
                   allow_undefined: Iterable[str] = ()) -> bool:
        """True iff every requirement here intersects what `provided` offers.

        Matches the filter at karpenter:pkg/cloudprovider/cloudprovider.go:261-263
        (`itCompatible := reqs.Compatible(i.Requirements, ...)`): keys absent
        from `provided` fail unless complemented (NotIn/DoesNotExist tolerate
        absence) or listed in `allow_undefined` (the reference's
        AllowUndefinedWellKnownLabels for user-defined labels).
        """
        allow = set(allow_undefined)
        for key, want in self.items():
            have = provided.get(key)
            if have is None:
                if key in allow or want.complement:
                    continue
                return False
            if not want.intersects(have):
                return False
        return True

    def labels(self) -> Dict[str, str]:
        """Single-valued requirements rendered as node labels."""
        out = {}
        for k, r in self.items():
            if not r.complement and len(r.values) == 1:
                out[k] = next(iter(r.values))
        return out

    def get_values(self, key: str) -> Optional[Set[str]]:
        r = self.get(key)
        if r is None or r.complement:
            return None
        return set(r.values)
