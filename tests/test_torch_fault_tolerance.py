"""The port's fleet-health helpers (``repro_torch.train.fault_tolerance``)
and synthetic data pipeline (``repro_torch.data.pipeline``) against the
reference's, on the same inputs: every output equal (the straggler medians
are the same numpy calls; the token batches bitwise).
"""
import itertools

import numpy as np
import pytest

from repro.data import pipeline as jdata
from repro.train import fault_tolerance as jft
from repro_torch.data import DataConfig, SyntheticTokens, prefetch
from repro_torch.train import fault_tolerance as tft


def _both(name, *args, **kwargs):
    return getattr(tft, name)(*args, **kwargs), getattr(jft, name)(*args, **kwargs)


# -- HeartbeatMonitor ------------------------------------------------------------

def test_heartbeat_dead_hosts_equal_reference():
    # A fixed clock reading, not time.monotonic(): host 5 beats exactly one
    # deadline before the probe at now + 16, and whether (now + 16) - (now +
    # 6) rounds to 10.0 or just above it depends on the reading's low bits
    # (4194297.80329046 rounds it above, making host 5 dead).  At 1000.0
    # every time below is exact, so the boundary is decided by the strict
    # ``>`` of both monitors, as written.
    now = 1000.0
    mons = [tft.HeartbeatMonitor([0, 1, 2], deadline_s=10.0),
            jft.HeartbeatMonitor([0, 1, 2], deadline_s=10.0)]
    schedule = [(0, now + 1), (1, now + 5), (5, now + 6), (0, now + 14), (2, now + 3)]
    for host, t in schedule:
        for m in mons:
            m.beat(host, now=t)
    for probe in (now + 2, now + 12, now + 16, now + 30):
        got, want = (m.dead_hosts(now=probe) for m in mons)
        assert got == want
    assert mons[0].dead_hosts(now=now + 16) == [1, 2]


def test_heartbeat_registers_unknown_hosts_lazily():
    m = tft.HeartbeatMonitor(hosts=[], deadline_s=1e9)
    m.beat(7)
    assert 7 in m._last and m.dead_hosts() == []


# -- StragglerTracker ------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stragglers_equal_reference(seed):
    rng = np.random.default_rng(seed)
    got = tft.StragglerTracker([0, 1, 2, 3], window=16, k=3.0)
    want = jft.StragglerTracker([0, 1, 2, 3], window=16, k=3.0)
    slow = int(rng.integers(0, 4))
    for i in range(40):
        for host in range(4):
            t = float(rng.normal(1.0, 0.02)) + (0.5 if host == slow and i > 10 else 0.0)
            got.record(host, t)
            want.record(host, t)
        if i % 4 == 3:
            got.record_chunk(5, 8.0 + i, 8)
            want.record_chunk(5, 8.0 + i, 8)
        assert got.stragglers() == want.stragglers()
        assert got._times == want._times
    assert slow in got.stragglers()


def test_straggler_needs_two_hosts_with_eight_samples():
    tr = tft.StragglerTracker([0, 1])
    for _ in range(8):
        tr.record(0, 1.0)
    assert tr.stragglers() == []


def test_record_chunk_averages_per_step():
    tr = tft.StragglerTracker([0])
    tr.record_chunk(0, 8.0, 16)
    assert tr._times[0] == [0.5]
    with pytest.raises(ValueError, match="n_steps"):
        tr.record_chunk(0, 1.0, 0)


def test_window_keeps_the_latest_samples():
    tr = tft.StragglerTracker([0], window=3)
    for t in range(5):
        tr.record(0, float(t))
    assert tr._times[0] == [2.0, 3.0, 4.0]


# -- recovery_plan ---------------------------------------------------------------

@pytest.mark.parametrize("mesh,per_pod,dead,step", [
    ((4, 8, 2), 2, [3], 120),
    ((4, 8, 2), 2, [0, 1, 7], 0),
    ((2, 8, 2), 4, [5, 6], 7),
    ((8, 2), 1, [], 7),
    ((3, 1, 1), 1, [], 11),
])
def test_recovery_plan_equals_reference(mesh, per_pod, dead, step):
    got, want = _both("recovery_plan", mesh, per_pod, dead, step)
    assert (got.new_mesh_shape, got.resume_step, got.dropped_hosts) == (
        want.new_mesh_shape, want.resume_step, want.dropped_hosts)


@pytest.mark.parametrize("mesh,per_pod,dead,exc", [
    ((2, 4, 1), 2, [4], ValueError),
    ((2, 4, 1), 2, [-1], ValueError),
    ((2, 4, 1), 2, [0, 2], RuntimeError),
])
def test_recovery_plan_raises_as_the_reference(mesh, per_pod, dead, exc):
    for module in (tft, jft):
        with pytest.raises(exc):
            module.recovery_plan(mesh, per_pod, dead, 0)


# -- data pipeline ---------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(global_batch=4, seq_len=16, vocab=1000),
    dict(global_batch=8, seq_len=5, vocab=7, seed=3, num_hosts=2, host_id=1),
    dict(global_batch=6, seq_len=32, vocab=50257, seed=12345, num_hosts=3, host_id=2),
])
def test_batch_at_is_bitwise_the_reference(cfg):
    got = SyntheticTokens(DataConfig(**cfg))
    want = jdata.SyntheticTokens(jdata.DataConfig(**cfg))
    assert got.local_batch == want.local_batch
    for step in (0, 1, 17, 1000):
        a, b = got.batch_at(step), want.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_iteration_and_prefetch_replay_batch_at():
    src = SyntheticTokens(DataConfig(global_batch=2, seq_len=4, vocab=11))
    it = iter(src)
    first = [next(it) for _ in range(3)]
    fetched = list(enumerate(prefetch(itertools.islice(iter(src), 3), depth=2)))
    for step, (batch, (_, pre)) in enumerate(zip(first, fetched)):
        want = src.batch_at(step)
        assert all(np.array_equal(batch[k], want[k]) and np.array_equal(pre[k], want[k])
                   for k in want)


def test_prefetch_ends_with_its_source_and_passes_errors_on():
    assert list(prefetch(iter(range(5)), depth=2)) == [0, 1, 2, 3, 4]

    def broken():
        yield 1
        raise OSError("disk gone")

    out = prefetch(broken())
    assert next(out) == 1
    with pytest.raises(OSError, match="disk gone"):
        next(out)


def test_host_sharding_must_divide_the_batch():
    with pytest.raises(ValueError, match="num_hosts"):
        SyntheticTokens(DataConfig(global_batch=5, seq_len=4, vocab=9, num_hosts=2))
