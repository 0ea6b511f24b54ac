"""Carry a solve's inputs across from the JAX package: build the port's
`Problem` and existing-node state from plain numpy arrays.

The reference's `Problem` (or any object or dict with the same field names)
is read as numpy arrays and plain values only — never as a JAX-package type —
so the port and the reference can be held against each other on exactly the
same inputs:

    prob_t = problem_from_arrays(ref_problem)
    ea, eu, ec = slot_state_from_arrays(dict(alloc=..., used=..., compat=...))
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import numpy as np

from .api.resources import DEFAULT_SCALES
from .ops.tensorize import GangInfo, LaunchOption, Problem


def _get(src: Any, name: str, default=None):
    if isinstance(src, Mapping):
        return src.get(name, default)
    return getattr(src, name, default)


def _arr(src: Any, name: str, dtype) -> Optional[np.ndarray]:
    v = _get(src, name)
    return None if v is None else np.array(v, dtype=dtype, copy=True)


def _option(o) -> LaunchOption:
    """A LaunchOption from a tuple in field order, a mapping, or any object
    with the same attribute names."""
    if isinstance(o, (tuple, list)):
        return LaunchOption(*o)
    names = ("pool", "instance_type", "zone", "capacity_type", "price",
             "type_index", "pool_index", "weight_rank")
    return LaunchOption(**{n: _get(o, n) for n in names})


def problem_from_arrays(src: Any) -> Problem:
    """The port's Problem from `src`'s fields: axes, scales,
    class_requests/counts/compat/node_cap/members, option_alloc/price/
    rank/zone/captype, zones, options (tuples in LaunchOption field order,
    or objects with those attributes), and optionally class_gang/gangs.
    Arrays are copied with the reference's dtypes."""
    options = [_option(o) for o in _get(src, "options")]
    gangs = [GangInfo(*g) if isinstance(g, (tuple, list)) else
             GangInfo(name=_get(g, "name"), size=_get(g, "size"),
                      tier=_get(g, "tier"), topology=_get(g, "topology"))
             for g in (_get(src, "gangs") or [])]
    return Problem(
        axes=tuple(_get(src, "axes")),
        class_requests=_arr(src, "class_requests", np.float32),
        class_counts=_arr(src, "class_counts", np.int32),
        class_compat=_arr(src, "class_compat", bool),
        class_members=[np.array(m, dtype=np.int64, copy=True)
                       for m in _get(src, "class_members")],
        options=options,
        option_alloc=_arr(src, "option_alloc", np.float32),
        option_price=_arr(src, "option_price", np.float32),
        option_rank=_arr(src, "option_rank", np.int32),
        class_node_cap=_arr(src, "class_node_cap", np.int32),
        option_zone=_arr(src, "option_zone", np.int32),
        option_captype=_arr(src, "option_captype", np.int32),
        zones=list(_get(src, "zones") or []),
        class_gang=_arr(src, "class_gang", np.int32),
        gangs=gangs,
        scales=dict(_get(src, "scales") or DEFAULT_SCALES),
    )


def slot_state_from_arrays(src: Any) -> Tuple[np.ndarray, np.ndarray,
                                               Optional[np.ndarray]]:
    """(existing_alloc E×R f32, existing_used E×R f32, existing_compat C×E
    bool or None) from `src`'s `alloc`, `used` and `compat` — the
    existing-node columns `solve_classpack` takes."""
    alloc = _arr(src, "alloc", np.float32)
    used = _arr(src, "used", np.float32)
    if used is None:
        used = np.zeros_like(alloc)
    return alloc, used, _arr(src, "compat", bool)
