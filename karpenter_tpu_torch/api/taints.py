"""Taints and tolerations (standard K8s semantics the reference's scheduler
honors; see karpenter:website/content/en/docs/concepts/scheduling.md
taints section)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"


@dataclass(frozen=True)
class Taint:
    key: str
    effect: str = NO_SCHEDULE
    value: str = ""


@dataclass(frozen=True)
class Toleration:
    key: str = ""          # empty key + Exists tolerates everything
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""       # empty matches all effects

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return not self.key or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


def tolerates_all(tolerations: Iterable[Toleration], taints: Iterable[Taint]) -> bool:
    """True iff every NoSchedule/NoExecute taint is tolerated
    (PreferNoSchedule is soft and never blocks)."""
    tolerations = list(tolerations)
    for t in taints:
        if t.effect == PREFER_NO_SCHEDULE:
            continue
        if not any(tol.tolerates(t) for tol in tolerations):
            return False
    return True
