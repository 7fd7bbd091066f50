"""The port's host scheduler (``corpus/scheduler.py``) against the JAX
package's: host shard plans, reducer letter ranges, the balance reports
and the steal queue's lease/ack contract.  Given the same
``MRI_STEAL_SHUFFLE_SEED``, both queues hand out the same leases in the
same order, and recover a dead worker's windows the same way."""

import threading
import time

import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.corpus import (
    manifest as jman,
    scheduler as jsch,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    scheduler as tsch,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.utils import envknobs


def _manifests(sizes):
    paths = tuple(f"f{i}" for i in range(len(sizes)))
    return (tman.Manifest(paths=paths, sizes=tuple(sizes)),
            jman.Manifest(paths=paths, sizes=tuple(sizes)))


@pytest.mark.parametrize("sizes,shards", [
    ([100, 10, 90, 20, 80, 30], 3),   # LPT covers every file once
    ([50] * 8, 4),                    # perfectly balanced
    ([5, 5], 5),                      # more shards than files: empty shards
    ([], 2),
])
def test_host_shard_plan_equals_jax(sizes, shards):
    tm, jm = _manifests(sizes)
    plan = tsch.plan_host_shards(tm, shards)
    assert plan.shards == jsch.plan_host_shards(jm, shards).shards
    assert plan.num_shards == shards
    assert sorted(i for s in plan.shards for i in s) == list(range(len(sizes)))
    assert tsch.shard_balance_stats(tm, plan) == jsch.shard_balance_stats(
        jm, jsch.plan_host_shards(jm, shards))
    if sizes == [50] * 8:
        assert tsch.shard_balance_stats(tm, plan)["max_over_mean"] == 1.0


@pytest.mark.parametrize("num_reducers", [1, 2, 3, 4, 13, 26, 27, 30, 100])
def test_letter_ranges_equal_jax(num_reducers):
    ranges = tsch.plan_letter_ranges(num_reducers)
    assert ranges == jsch.plan_letter_ranges(num_reducers)
    covered = [letter for lo, hi in ranges for letter in range(lo, hi)]
    assert covered == list(range(26))  # a partition at any M
    if num_reducers > 26:  # the reference's degenerate arithmetic
        assert all(lo == hi for lo, hi in ranges[:-1]) and ranges[-1] == (0, 26)


@pytest.mark.parametrize("loads", [[5, 5, 5], [90, 3, 3, 3, 1], [], [0, 0]])
def test_term_shard_balance_equals_jax(loads):
    assert tsch.term_shard_balance(loads) == jsch.term_shard_balance(loads)


def _drain(q, worker=None, ack=False):
    out = []
    while (item := q.pop_window(worker=worker)) is not None:
        out.append(item)
        if ack:
            q.ack(item[0], worker=worker)
    return out


@pytest.mark.parametrize("seed", [None, "1", "7", "20260805"])
def test_steal_queue_lease_sequence_equals_jax(seed, monkeypatch):
    """The knob as both packages read it gives the same hand-out order,
    every window once with its global plan index."""
    if seed is not None:
        monkeypatch.setenv("MRI_STEAL_SHUFFLE_SEED", seed)
    s = envknobs.get("MRI_STEAL_SHUFFLE_SEED")
    windows = [(i, i + 1) for i in range(40)]
    got = _drain(tsch.StealQueue(windows, shuffle_seed=s))
    assert got == _drain(jsch.StealQueue(windows, shuffle_seed=s))
    assert sorted(got) == [(i + 1, (i, i + 1)) for i in range(40)]
    assert (got == sorted(got)) is (seed is None)


def test_steal_queue_recovery_sequence_equals_jax():
    """Leases, acks, a worker death with its requeue, the blacklist and
    a late ack: the same answers at every step in both packages."""
    trace = []
    for mod in (tsch, jsch):
        q = mod.StealQueue([(i, i + 2) for i in range(0, 20, 2)], shuffle_seed=3)
        steps = [q.pop_window(worker=0), q.pop_window(worker=1), q.pop_window(worker=0)]
        q.ack(steps[0][0], worker=0)
        steps.append(q.fail_worker(0))
        steps.append(q.pop_window(worker=0))          # blacklisted
        q.ack(steps[2][0], worker=0)                  # late ack, dropped
        steps.append(_drain(q, worker=1, ack=True))
        q.ack(steps[1][0], worker=1)
        steps += [q.outstanding(), len(q)]
        trace.append(steps)
    assert trace[0] == trace[1]
    assert trace[0][4] is None and trace[0][-2:] == [0, 0]


def test_steal_queue_lease_requeue_and_blacklist():
    q = tsch.StealQueue([(0, 2), (2, 5), (5, 6)])
    assert q.pop_window(worker=0) == (1, (0, 2))
    assert q.pop_window(worker=1) == (2, (2, 5))
    q.ack(1, worker=0)
    assert q.fail_worker(0) == [1]  # a completed window comes back too
    assert q.pop_window(worker=0) is None
    assert sorted(i for i, _ in _drain(q, worker=1, ack=True)) == [1, 3]
    q.ack(2, worker=1)
    assert q.outstanding() == 0


def test_steal_queue_leased_windows_requeue_on_failure():
    q = tsch.StealQueue([(i, i + 1) for i in range(4)])
    for _ in range(3):
        q.pop_window(worker=2)
    assert q.fail_worker(2) == [1, 2, 3]
    assert len(q) == 4 and q.outstanding() == 0


def test_steal_queue_expired_workers_watchdog():
    q = tsch.StealQueue([(0, 1), (1, 2)])
    q.pop_window(worker=0)
    q.pop_window(worker=1)
    q.ack(2, worker=1)
    time.sleep(0.05)
    assert q.expired_workers(0.01) == {0}
    assert q.expired_workers(10.0) == set()


def test_steal_queue_concurrent_drain_no_loss_no_dup():
    q = tsch.StealQueue([(i, i + 1) for i in range(200)])
    taken = [[] for _ in range(4)]
    threads = [threading.Thread(target=lambda w=w: taken[w].extend(_drain(q))) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(x for part in taken for x in part) == [(i + 1, (i, i + 1)) for i in range(200)]
