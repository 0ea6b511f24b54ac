"""Forensic bundle files: atomic writes, bounded retention, tolerant reads.

A copy of the JAX package's `obs/bundle.py`.

One bundle is one JSON file named `incident-<id>.json` where `<id>` is
`<t_ms>-<kind>-<seq>` — millisecond injectable-clock time (virtual in
sim, so ids are deterministic), the incident kind, and a monotone
per-process sequence number that breaks ties when several kinds trip in
the same tick.  Writes follow the repo's snapshot discipline: serialize
to `<name>.tmp`, then `os.replace` — a crash mid-write leaves the
previous bundle set intact, never a half-file under the final name.

Read-back is forensic-grade paranoid: a truncated or corrupted file (the
very crash the recorder exists to explain may have interrupted the
write) comes back as `{"id": ..., "corrupt": true, "error": ...}` rather
than an exception, so one bad bundle never hides its siblings from
`/debug/incidents` or `tools/incident_report.py`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

_PREFIX = "incident-"
_SUFFIX = ".json"


def bundle_id(t: float, kind: str, seq: int) -> str:
    return f"{int(round(t * 1000.0)):013d}-{kind}-{seq:04d}"


def bundle_path(dirpath: str, bid: str) -> str:
    return os.path.join(dirpath, f"{_PREFIX}{bid}{_SUFFIX}")


def write_bundle(dirpath: str, bundle: Dict) -> str:
    """Atomically persist one bundle; returns the final path."""
    os.makedirs(dirpath, exist_ok=True)
    path = bundle_path(dirpath, bundle["id"])
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(json.dumps(bundle, sort_keys=True, indent=2,
                            default=str) + "\n")
    os.replace(tmp, path)
    return path


def list_bundle_ids(dirpath: str) -> List[str]:
    """Bundle ids on disk, oldest first (ids sort chronologically)."""
    try:
        names = os.listdir(dirpath)
    except OSError:
        return []
    out = [n[len(_PREFIX):-len(_SUFFIX)] for n in names
           if n.startswith(_PREFIX) and n.endswith(_SUFFIX)]
    return sorted(out)


def read_bundle(dirpath: str, bid: str) -> Optional[Dict]:
    """One bundle by id; `None` if absent, a `corrupt` stub if unreadable."""
    path = bundle_path(dirpath, bid)
    try:
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    except OSError:
        return None
    except ValueError as e:
        return {"id": bid, "corrupt": True, "error": str(e)}
    if not isinstance(doc, dict):
        return {"id": bid, "corrupt": True,
                "error": f"expected object, got {type(doc).__name__}"}
    return doc


def prune(dirpath: str, retention: int) -> List[str]:
    """Delete the oldest bundles past `retention`; returns deleted ids."""
    ids = list_bundle_ids(dirpath)
    doomed = ids[:-retention] if retention > 0 else ids
    deleted = []
    for bid in doomed:
        try:
            os.remove(bundle_path(dirpath, bid))
            deleted.append(bid)
        except OSError:
            pass
    return deleted
