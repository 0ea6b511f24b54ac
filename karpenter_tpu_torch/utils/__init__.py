"""Host utilities of the port: the event recorder, scheduling provenance,
the solve watchdog, the chaos injector, the HA fencing token, the metric
registry and the tracer; and the JAX package's two helpers of
`utils/__init__.py` (karpenter:pkg/utils/utils.go)."""

from __future__ import annotations

import re
from typing import Dict, Optional

# providerID format `<cloud>:///<zone>/<instance-id>` — the parse analog of
# karpenter:pkg/utils/utils.go:33-56 (aws:///$zone/$id regex).
_PROVIDER_ID_RE = re.compile(r"^[a-z-]+:///(?P<zone>[^/]+)/(?P<id>[^/]+)$")


def parse_instance_id(provider_id: str) -> Optional[str]:
    """Extract the instance id from a providerID URI; bare ids pass through
    (utils.go ParseInstanceID)."""
    m = _PROVIDER_ID_RE.match(provider_id)
    if m:
        return m.group("id")
    if provider_id.startswith("i-"):
        return provider_id
    return None


def merge_tags(*tag_maps: Dict[str, str]) -> Dict[str, str]:
    """Later maps win (utils.go MergeTags)."""
    out: Dict[str, str] = {}
    for m in tag_maps:
        out.update(m or {})
    return out
