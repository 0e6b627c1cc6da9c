"""The range probes' staged search tree, and the probes on an unsorted tier.

The kernels of history_probe and window_query (csrc/common.cuh probe_max)
walk the first levels of each binary search in shared memory, staged in
the order search_top below gives (it mirrors csrc/common.cuh top_mid), then
go on from the search's own (lo, hi).  That is path-exact when the staged rows are exactly the
midpoints the reference's search (foundationdb_tpu/ops/digest.py
_searchsorted; the port's _searchsorted_plain) reads in its first levels,
in the tree's breadth-first order, whatever the table holds.  These tests
pin that on the CPU:

  * the tree, enumerated here from the reference's loop by intervals,
    equals search_top for cap = 2^1 .. 2^12 at every depth;
  * every midpoint _searchsorted_plain reads, at every level whose
    intervals are all non-empty (any staged depth, the kernels' 8
    included), is the row of the node its path has reached, on seeded sorted and
    unsorted tables, both tie sides, queries at MAX, at lanes
    0x7FFFFFFF / 0x80000000 and equal to staged rows (which reach every
    node of a sorted table's tree);
  * history_probe and window_query (plain, CPU) equal the JAX package's
    searchsorted_interval + range_max and window_query on the unsorted
    tier the reference leaves after an empty range at a live boundary
    (tests/test_torch_insert.py empty_at_row).

Integer data: tolerance 0.  The JAX package is imported only by the
reference test, so the `cuda` tests (tests/test_torch_kernels.py) take
search_top from here on a machine without JAX.
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch.conflict import window as tw
from foundationdb_tpu_torch.ops import digest as td
from foundationdb_tpu_torch.ops.rangemax import build_sparse_table

from test_torch_insert import keys, make_case, run_port

CAPS = [1 << n for n in range(1, 13)]
EDGE = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                dtype=np.uint32)


def search_top(cap: int, levels: int) -> list:
    """The rows the first `levels` levels of the reference's search over a
    cap-row table read, breadth first: node t (1-based) is the midpoint
    (lo + hi) >> 1 after the path given by the bits of t below its leading
    one (0: hi = mid, 1: lo = mid + 1), from [0, cap).  It mirrors
    csrc/common.cuh top_mid, the rule the kernels stage their rows by."""
    nbits = cap.bit_length() - 1
    assert cap == 1 << nbits and 0 <= levels <= nbits
    out = []
    for t in range(1, 1 << levels):
        lo, hi = 0, cap
        for bit in range(t.bit_length() - 2, -1, -1):
            mid = (lo + hi) >> 1
            if (t >> bit) & 1:
                lo = mid + 1
            else:
                hi = mid
        out.append((lo + hi) >> 1)
    return out


def reference_tree(cap: int, levels: int) -> list:
    """The midpoints of the reference's loop, level by level, over every
    interval its first `levels` iterations can hold: from [0, cap), a
    step to the left gives [lo, mid) and one to the right [mid + 1, hi)."""
    out, level = [], [(0, cap)]
    for _ in range(levels):
        nxt = []
        for lo, hi in level:
            assert lo < hi, "an empty interval inside the staged levels"
            mid = (lo + hi) >> 1
            out.append(mid)
            nxt += [(lo, mid), (mid + 1, hi)]
        level = nxt
    return out


@pytest.mark.parametrize("cap", CAPS)
def test_search_top_is_the_reference_tree(cap):
    nbits = cap.bit_length() - 1
    for levels in range(nbits + 1):
        assert search_top(cap, levels) == reference_tree(cap, levels)
    # Level nbits is the last whose every interval is non-empty.
    with pytest.raises(AssertionError):
        reference_tree(cap, nbits + 1)


class Recorder:
    """A row table that records the indices _searchsorted_plain gathers."""

    def __init__(self, t: torch.Tensor):
        self.t, self.shape, self.device = t, t.shape, t.device
        self.seen = []

    def __getitem__(self, idx):
        self.seen.append(idx.clone())
        return self.t[idx]


def probe_rows(rng, cap: int, sorted_: bool) -> torch.Tensor:
    """A cap-row table: row 0 the zero digest, then digests with lanes 0-5
    from EDGE and random lanes 6-7.  Sorted: cap distinct rows, no
    padding; unsorted: a random live size in random order, MAX rows past
    it."""
    n = cap if sorted_ else int(rng.integers(1, cap + 1))
    d = EDGE[rng.integers(0, EDGE.size, size=(8, n))]
    d[6:] = rng.integers(0, 1 << 32, size=(2, n), dtype=np.uint64)
    d[:, 0] = 0
    if sorted_:
        s = np.unique(td.planar_to_s24(d))
        assert s.size == n
        d = s.view(np.uint8).reshape(-1, 32).view(">u4").astype(np.uint32).T
    planar = td.max_digest_block(cap)
    planar[:, :d.shape[1]] = d
    return torch.from_numpy(td.planar_to_rows(planar))


@pytest.mark.parametrize("cap", CAPS)
def test_plain_search_reads_the_staged_tree(cap):
    rng = np.random.default_rng(cap)
    levels = cap.bit_length() - 1  # every level with no empty interval
    top = search_top(cap, levels)
    for sorted_ in (True, False):
        table = probe_rows(rng, cap, sorted_)
        staged = table[torch.tensor(top, dtype=torch.long)]
        edge = torch.from_numpy(td.planar_to_rows(
            EDGE[rng.integers(0, EDGE.size, size=(8, 64))]))
        queries = torch.cat([staged, staged + (staged == 0).int(),
                             table[torch.from_numpy(
                                 rng.integers(0, cap, 64)).long()],
                             edge, torch.full((2, 8), -1, dtype=torch.int32)])
        nq = queries.shape[0]
        side = torch.from_numpy(rng.random(nq) < 0.5)
        for side_left in (True, False, side):
            rec = Recorder(table)
            got = td._searchsorted_plain(rec, queries, side_left)
            assert torch.equal(got, td._searchsorted_plain(table, queries,
                                                           side_left))
            seen = torch.stack(rec.seen)          # [levels + 1, nq]
            assert seen.shape[0] == levels + 1
            node = np.ones(nq, dtype=np.int64)
            for lvl in range(levels):
                mids = seen[lvl].numpy()
                want = np.asarray(top)[node - 1]
                np.testing.assert_array_equal(mids, want)
                # The next midpoint lies right of this one iff the search
                # went right (lo = mid + 1).
                node = 2 * node + (seen[lvl + 1].numpy() > mids)
            if sorted_:
                # On distinct sorted rows each staged row, searched for on
                # either side, is read at its own node: the first levels
                # of these searches read every node of the tree.
                first = seen[:levels, :len(top)].numpy()
                assert set(first.ravel()) == set(top)


def jax_probe(bk, bv, dk, dv, ub, ue):
    """The reference's history probe (conflict/fused.py:351-355)."""
    import jax.numpy as jnp
    from foundationdb_tpu.ops import digest as jd
    from foundationdb_tpu.ops.rangemax import build_sparse_table as jax_table
    from foundationdb_tpu.ops.rangemax import range_max as jax_range_max
    pb, hb = jd.searchsorted_interval(jnp.asarray(bk), jnp.asarray(ub),
                                      jnp.asarray(ue))
    pd, hd = jd.searchsorted_interval(jnp.asarray(dk), jnp.asarray(ub),
                                      jnp.asarray(ue))
    return np.maximum(
        np.asarray(jax_range_max(jax_table(jnp.asarray(bv)), pb - 1, hb)),
        np.asarray(jax_range_max(jax_table(jnp.asarray(dv)), pd - 1, hd)))


def unsorted_tier():
    """The window tier after empty_at_row: an empty range at a live
    boundary leaves a MAX row at NEG_INF inside the live prefix."""
    st = run_port(make_case("window", "empty_at_row"))
    bk, size = st["bk"], st["size"]
    s24 = td.planar_to_s24(bk[:, :size])
    assert (s24[1:] < s24[:-1]).any(), "the tier is sorted"
    return bk, st["bv"]


def probe_queries(rng, n: int):
    """Point ranges and short ranges over the cases' key ids (10..400),
    the keys around the collision (k(20)) included; planar begins, ends."""
    ids = np.concatenate([[19, 20, 21, 400, 0], rng.integers(0, 420, n - 5)])
    span = np.where(rng.random(n) < 0.5, 0, rng.integers(1, 40, n))
    b = keys(ids)
    e = keys(ids + span)
    point = span == 0
    e[7, point] = b[7, point] + 1
    return b, e


def test_probes_match_reference_on_unsorted_tier():
    import jax.numpy as jnp
    from foundationdb_tpu.conflict import window as jw
    rng = np.random.default_rng(21)
    bk, bv = unsorted_tier()
    dcase = make_case("window", "present_end")
    dk, dv = dcase["bk"], dcase["bv"]
    ub, ue = probe_queries(rng, 300)
    want = jax_probe(bk, bv, dk, dv, ub, ue)
    rows = lambda p: torch.from_numpy(td.planar_to_rows(p))
    t = lambda v: torch.from_numpy(np.asarray(v, dtype=np.int32))
    tb, tdt = build_sparse_table(t(bv)), build_sparse_table(t(dv))
    got = td.history_probe(rows(bk), tb, rows(dk), tdt, rows(ub), rows(ue))
    np.testing.assert_array_equal(got.numpy(), want)
    # The same with the tiers swapped, and with an owned quarter.
    own = (rng.random(300) < 0.25).astype(np.int32)
    got = td.history_probe(rows(dk), tdt, rows(bk), tb, rows(ub), rows(ue),
                           own=t(own))
    want = np.where(own != 0, jax_probe(dk, dv, bk, bv, ub, ue),
                    np.int32(-(1 << 31) + 1))
    np.testing.assert_array_equal(got.numpy(), want)
    # window_query on the unsorted tier, snapshots around its versions.
    snap = rng.integers(0, 9500, 300).astype(np.int32)
    valid = rng.random(300) < 0.8
    want = np.asarray(jw.window_query(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(ub), jnp.asarray(ue),
        jnp.asarray(snap), jnp.asarray(valid)))
    got = tw.window_query(rows(bk), t(bv), rows(ub), rows(ue), t(snap),
                          t(valid))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert 0 < int(got.sum()) < int(valid.sum())
