"""The port's ops/sort.py sort_rows against jax.lax.sort with the same
num_keys, as the JAX package sorts at conflict/fused.py:524 (8 lanes),
conflict/window.py:105 (8 lanes + an int32 tie, with a payload) and :184
(8 lanes, with a payload).

Rows are drawn from a small set of lane values including 0x7FFFFFFF,
0x80000000 and MAX, with duplicate rows and MAX padding rows; where keys
repeat, the payloads are equal (the condition under which an unstable and
a stable sort agree, see ops/sort.py).  Integer data: tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu_torch.ops.digest import planar_to_rows, rows_to_planar
from foundationdb_tpu_torch.ops.sort import sort_rows

LANES = np.array([0, 1, 5, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                 dtype=np.uint32)


def edge_planar(rng, n: int, n_max: int) -> np.ndarray:
    """uint32[8, n]: lanes from LANES (a few lanes vary, the rest are
    shared), some rows repeated, n_max all-MAX rows."""
    d = np.broadcast_to(LANES[rng.integers(0, LANES.size, size=(8, 1))],
                        (8, n)).copy()
    for lane in rng.choice(8, size=3, replace=False):
        d[lane] = LANES[rng.integers(0, LANES.size, size=n)]
    d[:, rng.integers(0, n, size=n // 4)] = d[:, rng.integers(0, n,
                                                              size=n // 4)]
    d[:, rng.choice(n, size=n_max, replace=False)] = 0xFFFFFFFF
    return d


def payload_of(planar: np.ndarray, tie=None) -> np.ndarray:
    """A payload that depends only on the key (equal keys, equal payload)."""
    h = np.zeros(planar.shape[1], dtype=np.int64)
    for lane in range(8):
        h = (h * 1_000_003 + planar[lane].astype(np.int64)) % (1 << 31)
    if tie is not None:
        h = (h * 7 + tie) % (1 << 31)
    return (h - (1 << 30)).astype(np.int32)


@pytest.mark.parametrize("n,with_tie,with_payload", [
    (1, False, False), (257, False, False), (1000, True, True),
    (4096 + 3, False, True), (9000, True, True)])
def test_sort_rows_matches_lax_sort(n, with_tie, with_payload):
    rng = np.random.default_rng(n)
    planar = edge_planar(rng, n, max(n // 10, 1) if n > 1 else 0)
    tie = rng.integers(0, 2, size=n).astype(np.int32) if with_tie else None
    pay = payload_of(planar, tie) if with_payload else None
    ops = [jnp.asarray(planar[lane]) for lane in range(8)]
    if with_tie:
        ops.append(jnp.asarray(tie))
    if with_payload:
        ops.append(jnp.asarray(pay))
    want = jax.lax.sort(ops, num_keys=8 + int(with_tie))
    got_rows, got_pay = sort_rows(
        torch.from_numpy(planar_to_rows(planar)),
        tie=None if tie is None else torch.from_numpy(tie),
        payload=None if pay is None else torch.from_numpy(pay))
    np.testing.assert_array_equal(rows_to_planar(got_rows),
                                  np.stack([np.asarray(x) for x in want[:8]]))
    if with_payload:
        np.testing.assert_array_equal(got_pay.numpy(), np.asarray(want[-1]))
    else:
        assert got_pay is None


def test_sort_rows_is_stable_and_writes_out():
    """Equal keys keep their input order (the payload is the index), and
    `out` may be the head of a larger buffer."""
    rows = torch.tensor([[0, 0, 0, 0, 0, 0, 0, 2]] * 3
                        + [[0, 0, 0, 0, 0, 0, 0, 1]] * 2, dtype=torch.int32)
    buf = torch.full((8, 8), -1, dtype=torch.int32)
    got, pay = sort_rows(rows, payload=torch.arange(5, dtype=torch.int32),
                         out=buf[:5])
    assert got.data_ptr() == buf.data_ptr()
    assert pay.tolist() == [3, 4, 0, 1, 2]
    assert (buf[5:] == -1).all()


@pytest.mark.parametrize("prefix_lanes", [0, 2])
@pytest.mark.parametrize("with_tie,with_payload", [
    (False, False), (False, True), (True, False), (True, True)])
def test_sort_rows_random_lanes_match_lax_sort(prefix_lanes, with_tie,
                                               with_payload):
    """Every lane random (hashed keys: all 32 digest bytes live), or the
    first two lanes shared by every row (an 8-byte tuple-layer prefix),
    with a few rows repeated and a few MAX rows."""
    n = 3000
    rng = np.random.default_rng(17 + prefix_lanes)
    planar = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64).astype(
        np.uint32)
    planar[:prefix_lanes] = rng.integers(0, 1 << 32, size=(prefix_lanes, 1),
                                         dtype=np.uint64).astype(np.uint32)
    planar[:, rng.integers(0, n, size=n // 10)] = planar[
        :, rng.integers(0, n, size=n // 10)]
    planar[:, rng.choice(n, size=n // 20, replace=False)] = 0xFFFFFFFF
    tie = rng.integers(-2, 2, size=n).astype(np.int32) if with_tie else None
    pay = payload_of(planar, tie) if with_payload else None
    ops = [jnp.asarray(planar[lane]) for lane in range(8)]
    if with_tie:
        ops.append(jnp.asarray(tie))
    if with_payload:
        ops.append(jnp.asarray(pay))
    want = jax.lax.sort(ops, num_keys=8 + int(with_tie))
    got_rows, got_pay = sort_rows(
        torch.from_numpy(planar_to_rows(planar)),
        tie=None if tie is None else torch.from_numpy(tie),
        payload=None if pay is None else torch.from_numpy(pay))
    np.testing.assert_array_equal(rows_to_planar(got_rows),
                                  np.stack([np.asarray(x) for x in want[:8]]))
    if with_payload:
        np.testing.assert_array_equal(got_pay.numpy(), np.asarray(want[-1]))
    else:
        assert got_pay is None


def test_sort_rounds_and_scratch():
    """The kernel's launches a call depend on n alone: one tile sort, then
    a partition and a merge per doubling of the tile that n needs."""
    from foundationdb_tpu_torch.ops.sort import (SORT_TILE, sort_rounds,
                                                 sort_scratch_ints)
    assert [sort_rounds(n) for n in (1, SORT_TILE - 1, SORT_TILE,
                                     SORT_TILE + 1, 2 * SORT_TILE + 1,
                                     1_179_648, 1 << 21)
            ] == [0, 0, 0, 1, 2, 9, 9]
    assert sort_scratch_ints(1000) == 11 * 1000 + 1
    assert sort_scratch_ints(4097) == 11 * 4097 + 5
