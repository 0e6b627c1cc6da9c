"""The port's conflict heat tracker held against the reference's, exactly.

The same seeded sequence of sample_load, record_conflict and decay calls
goes to foundationdb_tpu's ConflictHeatTracker and to the port's copy,
with tables small enough (table_max 16) that the halving past the bound
runs many times.  Every table (ranges, tenants, tags and the per-range
breakdowns), the totals, and every query (split_load, top_conflicts,
feed_rows, to_status) must be equal; all the data is integers and bytes,
so the tolerance is 0.  The order of the tables' keys is compared too:
it decides the split keys and the top-K rows.
"""

import numpy as np
import pytest

from foundationdb_tpu.conflict.heat import ConflictHeatTracker as RefHeat
from foundationdb_tpu_torch.conflict.heat import ConflictHeatTracker

TAGS = ["", "t/a", "t/b", "batch", "t/c"]
TABLES = ("ranges", "tenants", "tags", "range_tags", "range_tenants")


def key(rng, n_keys: int) -> bytes:
    return b"k%05d" % int(rng.integers(0, n_keys))


def drive(trackers, seed: int, steps: int, n_keys: int) -> None:
    """`steps` seeded calls into every tracker in `trackers`; the return
    values of sample_load must agree call by call."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        op = rng.random()
        b = key(rng, n_keys)
        e = b + b"\x00" if rng.random() < 0.7 else key(rng, n_keys) + b"\xff"
        if op < 0.6:
            got = [t.sample_load(b, e) for t in trackers]
            assert len(set(got)) == 1, got
        elif op < 0.97:
            tenant = int(rng.integers(-1, 4))
            tag = TAGS[int(rng.integers(0, len(TAGS)))]
            weight = int(rng.integers(1, 4))
            for t in trackers:
                t.record_conflict(b, e, tenant_id=tenant, tag=tag,
                                  weight=weight)
        else:
            for t in trackers:
                t.decay()


def state(t) -> tuple:
    """Every table with its key order, and the totals."""
    return tuple(list(getattr(t, name).items()) for name in TABLES) + (
        t.total_conflicts, t.total_load, t._tick)


def queries(t, n_keys: int) -> tuple:
    lo, hi = b"k%05d" % (n_keys // 4), b"k%05d" % (3 * n_keys // 4)
    return (t.split_load(b"", b"\xff"), t.split_load(lo, hi),
            t.top_conflicts(1), t.top_conflicts(8), t.top_conflicts(10 ** 6),
            t.feed_rows(5), t.feed_rows(10 ** 6), t.to_status(),
            t.to_status(3))


@pytest.mark.parametrize("seed,table_max,sample_every,n_keys", [
    (0, 16, 8, 40), (1, 16, 1, 40), (2, 16, 3, 200), (3, 64, 8, 100),
    (4, 4096, 8, 500), (5, 4, 2, 30)])
def test_heat_tracker_matches_reference(seed, table_max, sample_every,
                                        n_keys):
    ref = RefHeat(sample_every=sample_every, table_max=table_max)
    port = ConflictHeatTracker(sample_every=sample_every,
                               table_max=table_max)
    assert (port.sample_every, port.table_max) == \
        (ref.sample_every, ref.table_max)
    for chunk in range(5):
        drive((ref, port), seed * 100 + chunk, 400, n_keys)
        assert state(port) == state(ref), chunk
        assert queries(port, n_keys) == queries(ref, n_keys), chunk
    if table_max <= 16:
        # The bound held: the halving ran.
        assert len(port.ranges) <= max(16, table_max) + 1
        assert port.total_load > len(port.ranges)


def test_heat_tracker_empty_and_ties():
    """An empty table answers alike; equal counts order by key in both."""
    ref, port = RefHeat(), ConflictHeatTracker()
    assert queries(port, 10) == queries(ref, 10)
    for t in (ref, port):
        for k in (b"c", b"a", b"b"):
            t.record_conflict(k, k + b"\x00", tenant_id=7, tag="t/x")
    assert port.top_conflicts(8) == ref.top_conflicts(8)
    assert [r[0] for r in port.top_conflicts(8)] == [b"a", b"b", b"c"]
    assert queries(port, 10) == queries(ref, 10)
    assert state(port) == state(ref)
