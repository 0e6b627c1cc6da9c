"""The port's conflict/window.py against foundationdb_tpu/conflict/window.py:
window_query, _union_ranges, window_insert (including an overflow, which
keeps the old state) and window_gc (including the rebase's int32 wrap),
on the same seeded inputs in both packages.  Integer data: tolerance 0.

Ranges are [key(a), key(a + s)) over 15-byte b"k%014d" keys, with
duplicates, overlapping and touching ranges and invalid rows; the union
test adds empty ranges (b == e), which EncodedBatch drops before an
insert ever sees them.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.conflict import window as jw
from foundationdb_tpu.ops import digest as jd
from foundationdb_tpu_torch.conflict import window as tw
from foundationdb_tpu_torch.ops.digest import planar_to_rows, rows_to_planar
from foundationdb_tpu_torch.ops.rangemax import NEG_INF

from test_torch_backend import key_matrix

CAP = 1 << 10
W = 64
Q = 256
KEYSPACE = 3000


def digests(ids) -> np.ndarray:
    return jd.encode_fixed(key_matrix(np.asarray(ids))[:, :15])


def write_ranges(rng, n: int = W, empty: bool = False):
    """Planar begin/end uint32[8, n] and a validity mask."""
    a = rng.integers(0, KEYSPACE - 60, size=n)
    s = rng.integers(0 if empty else 1, 30, size=n)
    s[:4] = 1                                    # point-like ranges
    a[4:8] = a[0:4]                              # duplicate begins
    s[4:6] = s[0:2]                              # duplicate ranges
    a[8], s[8] = a[9] + s[9], 5                  # touching ranges
    valid = rng.random(n) < 0.85
    return digests(a), digests(a + s), valid


def rows(planar) -> torch.Tensor:
    return torch.from_numpy(planar_to_rows(np.asarray(planar)))


def port_state(st) -> tw.WindowState:
    return tw.window_state_from_numpy(*st, device="cpu")


def assert_state(got: tw.WindowState, want, name=""):
    bk, bv, size = tw.window_state_to_numpy(got)
    np.testing.assert_array_equal(bk, np.asarray(want[0]), err_msg=name)
    np.testing.assert_array_equal(bv, np.asarray(want[1]), err_msg=name)
    assert int(size) == int(want[2]), name


@lru_cache(maxsize=None)
def jax_union():
    return jax.jit(jw._union_ranges)


@pytest.mark.parametrize("seed,empty", [(0, False), (1, True), (2, True)])
def test_union_ranges_matches_reference(seed, empty):
    b, e, valid = write_ranges(np.random.default_rng(seed), empty=empty)
    mb, me, m_valid = jax_union()(jnp.asarray(b), jnp.asarray(e),
                                  jnp.asarray(valid))
    got_b, got_e, m_incl = tw._union_ranges(
        rows(b), rows(e), torch.from_numpy(valid.astype(np.int32)))
    np.testing.assert_array_equal(rows_to_planar(got_b), np.asarray(mb))
    np.testing.assert_array_equal(rows_to_planar(got_e), np.asarray(me))
    m_count = int(m_incl[-1])
    np.testing.assert_array_equal(np.arange(W) < m_count, np.asarray(m_valid))
    assert 0 < m_count < int(valid.sum())       # some ranges merged


def insert_chain(seed: int, cap: int, n_batches: int):
    """Both packages insert the same batches into a fresh window; yields
    (batch, jax state, port state, jax overflow, port overflow)."""
    rng = np.random.default_rng(seed)
    j = jw.make_window_state(cap, 0)
    p = tw.make_window_state(cap, 0, "cpu")
    for i in range(n_batches):
        b, e, valid = write_ranges(rng)
        now = 1000 * (i + 1)
        j, j_ovf = jw.window_insert(j, jnp.asarray(b), jnp.asarray(e),
                                    jnp.asarray(valid), jnp.int32(now))
        p, p_ovf = tw.window_insert(p, rows(b), rows(e),
                                    torch.from_numpy(valid.astype(np.int32)),
                                    now)
        yield i, j, p, bool(j_ovf), int(p_ovf[0])


@pytest.mark.parametrize("cap,n_batches", [(CAP, 5), (128, 4)])
def test_window_insert_matches_reference(cap, n_batches):
    """A chain of inserts; with cap 128 a later insert overflows, keeps
    the old state and reports the overflow."""
    overflows = []
    for i, j, p, j_ovf, p_ovf in insert_chain(cap, cap, n_batches):
        assert_state(p, j, f"batch {i}")
        assert p_ovf == int(j_ovf)
        overflows.append(j_ovf)
    assert any(overflows) == (cap == 128)


def test_window_insert_flag_and_tail():
    """With a flag the overflow is OR'd into it, and the tail gets flag,
    new size and bsize (the general step's verdict tail)."""
    b, e, valid = write_ranges(np.random.default_rng(5))
    st = tw.make_window_state(CAP, 0, "cpu")
    flag = torch.tensor([1], dtype=torch.int32)
    tail = torch.zeros(3, dtype=torch.int32)
    _, ovf = tw.window_insert(st, rows(b), rows(e),
                              torch.from_numpy(valid.astype(np.int32)),
                              torch.tensor([7], dtype=torch.int32), flag=flag,
                              bsize=torch.tensor([42], dtype=torch.int32),
                              tail=tail)
    assert ovf is flag and int(flag[0]) == 1
    assert tail.tolist() == [1, int(st.size[0]), 42]


def query_inputs(rng, now: int):
    a = rng.integers(0, KEYSPACE - 60, size=Q)
    s = rng.integers(1, 50, size=Q)
    snap = rng.integers(0, now + 500, size=Q).astype(np.int32)
    valid = rng.random(Q) < 0.9
    return digests(a), digests(a + s), snap, valid


def test_window_query_matches_reference():
    rng = np.random.default_rng(6)
    for i, j, p, _, _ in insert_chain(7, CAP, 4):
        qb, qe, snap, valid = query_inputs(rng, 1000 * (i + 1))
        want = jw.window_query(j.bk, j.bv, jnp.asarray(qb), jnp.asarray(qe),
                               jnp.asarray(snap), jnp.asarray(valid))
        got = tw.window_query(p.bk, p.bv, rows(qb), rows(qe),
                              torch.from_numpy(snap),
                              torch.from_numpy(valid.astype(np.int32)))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int32))
    assert 0 < int(got.sum()) < Q


@pytest.mark.parametrize("floor,rebase", [(0, 0), (2500, 1500),
                                          (-(1 << 31) + 2, 100)])
def test_window_gc_matches_reference(floor, rebase):
    """removeBefore and the rebase; the last case puts a segment just above
    NEG_INF, which wraps to a huge version in both packages (the
    subtraction comes before the clamp)."""
    *_, (_, j, _, _, _) = insert_chain(8, CAP, 4)
    bk, bv, size = (np.asarray(x) for x in j)
    bv = bv.copy()
    if floor < 0:
        bv[0] = NEG_INF + 5
    want = jw.window_gc(jw.WindowState(jnp.asarray(bk), jnp.asarray(bv),
                                       jnp.asarray(size)),
                        jnp.int32(floor), jnp.int32(rebase))
    p = port_state((bk, bv, size))
    got = tw.window_gc(p, floor, rebase)
    assert got is p
    assert_state(got, want, "gc")
    if floor < 0:
        assert int(got.bv[0]) == (1 << 31) - 94
    elif floor > 0:
        assert int(got.size[0]) < int(size)
