"""Test-time lock-order recorder.

A copy of the JAX package's `analysis/lockorder.py` with a recorder of
its own: the port's components build their locks through this module's
`named_lock`, and tests/torch_lockorder.py enables this `RECORDER`.

The static checker (analysis/locks.py) proves writes happen under the
right lock; it cannot prove locks are taken in a consistent *order*
across threads — the refinery daemon, batcher flushers, manager HTTP
workers, and metrics scrapes all interleave.  This module records the
order at runtime and fails the suite on observed inversions.

Design: components create their locks through `named_lock("role")`.
When the recorder is inactive (production, and any test that doesn't
opt in) that returns a plain `threading.Lock` — zero overhead.  A test
module that enables `RECORDER` first (tests/torch_lockorder.py does,
unless KARPENTER_TPU_LOCK_ORDER=0) gets recording proxies instead: each
acquire records `held-lock → new-lock` edges in a process-wide order
graph keyed by role name (instances share a role; ordering discipline
is a property of roles, not objects).  Self-edges are ignored
(re-entrant RLock roles and sibling instances of one role).  A cycle in
the graph — most commonly A→B on one thread and B→A on another — is a
potential deadlock even if the run never actually deadlocked.

`RECORDER.inversions()` returns the offending cycles with the
stack-free witness edges (role names + thread names) so the failure
message names the two code paths to reconcile.  The port's recorder also
keeps the roles it saw acquired (`roles()`), which chip_smoke.py prints
beside the edges.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Set, Tuple


class LockOrderRecorder:
    def __init__(self) -> None:
        self.enabled = False
        self._meta = threading.Lock()
        # (held, acquired) -> witness "thread=... count=N"
        self._edges: Dict[Tuple[str, str], str] = {}
        self._roles: Set[str] = set()
        self._held = threading.local()

    # ---- lifecycle ----
    def enable(self) -> None:
        self.enabled = True

    def reset(self) -> None:
        with self._meta:
            self._edges.clear()
            self._roles.clear()

    # ---- recording (called by _RecordingLock) ----
    def _stack(self) -> List[str]:
        st = getattr(self._held, "stack", None)
        if st is None:
            st = self._held.stack = []
        return st

    def note_acquire(self, name: str) -> None:
        if name not in self._roles:
            with self._meta:
                self._roles.add(name)
        st = self._stack()
        if st:
            tname = threading.current_thread().name
            with self._meta:
                for held in st:   # setdefault dedups repeated holds
                    if held != name:
                        self._edges.setdefault(
                            (held, name), f"thread={tname}")
        st.append(name)

    def note_release(self, name: str) -> None:
        st = self._stack()
        # release order may differ from acquire order (nested `with`
        # blocks always match, but remove the right entry regardless)
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                break

    # ---- analysis ----
    def roles(self) -> Set[str]:
        """Every role acquired since the last reset."""
        with self._meta:
            return set(self._roles)

    def edges(self) -> Dict[Tuple[str, str], str]:
        with self._meta:
            return dict(self._edges)

    def inversions(self) -> List[str]:
        """Cycles in the observed order graph, rendered as messages.
        Pairwise inversions (A→B and B→A) and longer cycles both count."""
        edges = self.edges()
        graph: Dict[str, Set[str]] = {}
        for (a, b) in edges:
            graph.setdefault(a, set()).add(b)
        out: List[str] = []
        seen_pairs: Set[Tuple[str, str]] = set()
        for (a, b), witness in sorted(edges.items()):
            if (b, a) in edges and (b, a) not in seen_pairs:
                seen_pairs.add((a, b))
                out.append(
                    f"lock-order inversion: {a!r} -> {b!r} ({witness}) "
                    f"but also {b!r} -> {a!r} ({edges[(b, a)]})")
        # longer cycles: DFS with a path stack
        state: Dict[str, int] = {}   # 0=visiting, 1=done

        def dfs(node: str, path: List[str]) -> None:
            state[node] = 0
            path.append(node)
            for nxt in sorted(graph.get(node, ())):
                if state.get(nxt) == 0:
                    cycle = path[path.index(nxt):] + [nxt]
                    if len(cycle) > 3:   # pairs already reported above
                        out.append("lock-order cycle: " +
                                   " -> ".join(repr(c) for c in cycle))
                elif nxt not in state:
                    dfs(nxt, path)
            path.pop()
            state[node] = 1

        for node in sorted(graph):
            if node not in state:
                dfs(node, [])
        return out


RECORDER = LockOrderRecorder()


class _RecordingLock:
    """Wraps a real lock, reporting acquires/releases to the recorder."""

    def __init__(self, lock, name: str, recorder: LockOrderRecorder):
        self._lock = lock
        self._name = name
        self._recorder = recorder

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._recorder.note_acquire(self._name)
        return got

    def release(self) -> None:
        self._lock.release()
        self._recorder.note_release(self._name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __repr__(self) -> str:
        return f"<RecordingLock {self._name} {self._lock!r}>"


def named_lock(name: str,
               factory: Callable[[], object] = threading.Lock):
    """A lock participating in test-time order recording under `name`.

    Inactive recorder (the default) → the factory's plain lock, no
    wrapper, no overhead.  The decision is made at construction: enable
    the recorder before building the components under test."""
    lock = factory()
    if RECORDER.enabled:
        return _RecordingLock(lock, name, RECORDER)
    return lock
