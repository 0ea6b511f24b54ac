"""Headroom placeholder markers, as the disruption controller reads them.

A copy of the two readers in the JAX package's `forecast/headroom.py`
(`is_headroom`, `headroom_expiry`) and the constants they read.  The
HeadroomController that writes placeholders is not ported yet: the
consolidation decision only has to recognise its pods, which block the
sweep while their TTL is live and neither block nor reschedule once it
lapses.
"""

from __future__ import annotations

from typing import Optional

# identity + protection markers on placeholder pods
HEADROOM_LABEL = "karpenter.sh/headroom"
HEADROOM_EXPIRY_ANNOTATION = "karpenter.sh/headroom-expiry"


def is_headroom(pod) -> bool:
    return pod.labels.get(HEADROOM_LABEL, "") == "true"


def headroom_expiry(pod) -> Optional[float]:
    """TTL deadline of a placeholder (virtual-time float), None for real
    pods or malformed annotations."""
    raw = pod.annotations.get(HEADROOM_EXPIRY_ANNOTATION)
    if raw is None:
        return None
    try:
        return float(raw)
    except (TypeError, ValueError):
        return None
