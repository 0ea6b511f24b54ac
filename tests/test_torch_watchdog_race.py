"""The race between a watchdog worker the caller abandoned
(utils/watchdog.py `run_with_deadline`) and the caller's next solve, shown
deterministically on the port's two shared tables:

  * tensorize's class-id intern table: two threads that each meet a new
    class key both read "absent" (a dict whose `get` waits at a two-party
    barrier, and whose `len` waits too, so both read the same size before
    either writes).  The ids must still differ: equal ids would merge two
    classes without a word;
  * the same table's reset: a worker's tensorize that finds the table
    full and resets it while the caller's call is halfway through its
    pods.  The caller's classes must come out as without the worker: one
    id per key for the whole call, so no class is split or merged;
  * the DisruptionController's filtered-catalog memo: two threads that
    both miss must both be handed the same list, the one the memo keeps,
    so a late worker never replaces the list the tick is using.

No JAX; the port alone.
"""

import threading

from helpers import small_catalog
from karpenter_tpu_torch import convert
from karpenter_tpu_torch.api.objects import NodePool, Pod
from karpenter_tpu_torch.api.resources import CPU, MEMORY, ResourceList
from karpenter_tpu_torch.cloud import CloudProvider, FakeCloud
from karpenter_tpu_torch.controllers.disruption import DisruptionController
from karpenter_tpu_torch.ops import tensorize as tz
from karpenter_tpu_torch.state import Cluster


class _Lockstep(dict):
    """A dict whose misses meet at a barrier: `get` and `len` each wait
    until the other thread has made the same call."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.at_get = threading.Barrier(2, timeout=10)
        self.at_len = threading.Barrier(2, timeout=10)

    def get(self, key, default=None):
        hit = super().get(key, default)
        self.at_get.wait()
        return hit

    def __len__(self):
        n = super().__len__()
        self.at_len.wait()
        return n


def _in_two_threads(fn, args):
    out, errors = [None, None], []

    def run(i):
        try:
            out[i] = fn(args[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors, errors
    return out


def test_two_new_class_keys_never_share_an_id(monkeypatch):
    table, gen = _Lockstep(), next(tz._CLASS_GENS)
    pods = [Pod(requests=ResourceList({CPU: cpu, MEMORY: 2**30}))
            for cpu in (1234, 4321)]
    ids = _in_two_threads(lambda p: tz._class_id(p, table, gen), pods)
    assert ids[0] != ids[1], f"two class keys interned to one id {ids[0]}"
    assert sorted(dict.values(table)) == sorted(ids)
    # each pod keeps its own id on the next call
    assert [tz._class_id(p, table, gen) for p in pods] == ids


def test_a_reset_by_another_thread_mid_call_splits_no_class(monkeypatch):
    catalog = convert.catalog_from_objects(small_catalog())
    pools = [NodePool()]
    # classes A, B, A, B: the worker resets the full table just before the
    # caller interns its third pod
    pods = [Pod(requests=ResourceList({CPU: cpu, MEMORY: 2**30}))
            for cpu in (1234, 4321, 1234, 4321)]
    monkeypatch.setattr(tz, "_CLASS_IDS_MAX", 2)
    caller, key, seen = threading.get_ident(), tz._class_key, [0]

    def class_key(pod):
        if threading.get_ident() == caller:
            seen[0] += 1
            if seen[0] == 3:
                worker = threading.Thread(target=tz.tensorize, args=(
                    [Pod(requests=ResourceList({CPU: 777, MEMORY: 2**30}))],
                    catalog, pools))
                worker.start()
                worker.join(30)
        return key(pod)
    monkeypatch.setattr(tz, "_class_key", class_key)
    prob = tz.tensorize(pods, catalog, pools)
    assert seen[0] >= 3, "the worker never ran"
    assert [sorted(m.tolist()) for m in prob.class_members] == [[0, 2],
                                                               [1, 3]]
    assert prob.class_counts.tolist() == [2, 2]


def test_racing_filtered_catalog_misses_share_one_list():
    provider = CloudProvider(FakeCloud(),
                             convert.catalog_from_objects(small_catalog()))
    ctrl = DisruptionController(provider, Cluster(), [NodePool()],
                                device="cpu")
    memo = _Lockstep()
    memo.at_len = threading.Barrier(1)      # `len` need not meet here
    ctrl._filtcat_memo = (provider.get_instance_types(), memo)
    got = _in_two_threads(ctrl._filtered_catalog, [0.5, 0.5])
    assert got[0] is got[1], "a racing miss replaced the memo's list"
    assert memo[0.5] is got[0]
    assert [it.name for it in got[0]] == ["a.small", "a.medium", "a.large"]
