"""ShardedTorchConflictSet against the JAX ShardedTpuConflictSet, exactly.

The port's mesh is make_conflict_mesh(["cpu"] * 8) (kr=4, q=2), the
reference's the conftest's 8 virtual CPU devices (kr=4, q=2).  Both
backends resolve the same seeded batches; after EVERY batch the verdict
codes and every per-shard state array (stacked as the reference holds
them: bk uint32[D, 8, CAP] planar, bv, table, size, dk, dv, dtable, dsize,
flag) must be equal, and the codes must equal the oracle's.  The streams
cover compact point batches over keys spread across the shards, general
batches whose reads and writes straddle the splits, equi-depth custom
splits, merges with floor advances and rebases, a delta growth and its
shrink back, and the sticky overflow flag raising in both at the same
batch.  Capacities (1 << 10 per shard, delta 1 << 9) and batch buckets
(t_cap = r_cap = w_cap = 256) are the reference tests' own
(tests/test_sharded_resolver.py).  Integer data: tolerance 0.
"""

import numpy as np
import pytest

from foundationdb_tpu import txn as jt
from foundationdb_tpu.core.error import FdbError as JaxError
from foundationdb_tpu.parallel.sharded_resolver import ShardedTpuConflictSet
from foundationdb_tpu.parallel.sharded_window import \
    make_conflict_mesh as jax_mesh
from foundationdb_tpu.parallel.sharded_window import \
    splits_from_sample as jax_splits_from_sample
from foundationdb_tpu_torch.conflict.api import new_conflict_set
from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet
from foundationdb_tpu_torch.conflict.supervisor import SupervisedConflictSet
from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
from foundationdb_tpu_torch.core.error import FdbError
from foundationdb_tpu_torch.ops.digest import encode_keys
from foundationdb_tpu_torch.parallel import (ShardedTorchConflictSet,
                                             make_conflict_mesh,
                                             sharded_state_from_numpy,
                                             sharded_state_to_numpy,
                                             splits_from_sample)
from foundationdb_tpu_torch.txn import types as pt

CAP = 1 << 10
DCAP = 1 << 9
STATE_KEYS = ("bk", "bv", "table", "size", "dk", "dv", "dtable", "dsize",
              "flag")


@pytest.fixture(scope="module")
def meshes():
    return jax_mesh(n_devices=8), make_conflict_mesh(["cpu"] * 8)


def point_key(lead: int, i: int) -> bytes:
    """A 6-byte key whose lead byte picks its shard under even splits."""
    return bytes([lead]) + b"k%04d" % i


def key(i: int) -> bytes:
    """A 15-byte key of the bench's shape: every key shares b"k000..."."""
    return b"k%014d" % i


KEYS = 500


def txns(mod, shapes):
    """CommitTransactionRef objects of `mod` (either package's txn types)
    from (reads, writes, snapshot) byte-range shapes."""
    return [mod.CommitTransactionRef(
        read_conflict_ranges=[mod.KeyRange(b, e) for b, e in r],
        write_conflict_ranges=[mod.KeyRange(b, e) for b, e in w],
        read_snapshot=s) for r, w, s in shapes]


def snapshot(rng, now):
    return int(max(now - rng.integers(0, 3_000_000), 0))


def point_shapes(rng, n, now):
    """Point txns of 0-2 reads and 0-2 writes."""
    def pts(k):
        return [(key(i), key(i) + b"\x00")
                for i in rng.integers(0, KEYS, size=int(k))]

    return [(pts(rng.integers(0, 3)), pts(rng.integers(0, 3)),
             snapshot(rng, now)) for _ in range(n)]


def range_shapes(rng, n, now):
    """Reads and writes over [key(a), key(b)) of up to 200 keys, mixed with
    points: many ranges straddle a split."""
    def ranges(k):
        out = []
        for _ in range(int(k)):
            a = int(rng.integers(0, KEYS))
            b = a + int(rng.integers(0, 200))
            out.append((key(a), key(b) if b > a else key(a) + b"\x00"))
        return out

    return [(ranges(rng.integers(0, 4)), ranges(rng.integers(0, 3)),
             snapshot(rng, now)) for _ in range(n)]


def write_shapes(rng, n, now):
    """n txns, each writing one distinct key and reading nothing."""
    return [([], [(key(i), key(i) + b"\x00")], now)
            for i in rng.choice(KEYS, size=n, replace=False)]


SHAPES = {"point": point_shapes, "range": range_shapes,
          "writes": write_shapes}


def equi_depth_splits():
    """Equi-depth cuts from a sample of the keys (equal to the
    reference's): they fall inside the shared b"k000..." prefix, where
    even lane-0 cuts would put every key on one shard."""
    sample = encode_keys([key(i * 37 % KEYS) for i in range(KEYS)])
    splits = splits_from_sample(sample, 4)
    np.testing.assert_array_equal(splits, jax_splits_from_sample(sample, 4))
    assert (splits[1:] != splits[:-1]).any(axis=1).all(), "degenerate cuts"
    return splits


def assert_same_sharded_state(ref: ShardedTpuConflictSet,
                              port: ShardedTorchConflictSet):
    got = sharded_state_to_numpy(port)
    for k in STATE_KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(ref, k)),
                                      err_msg=k)
    for k in ("version_base", "oldest_version", "d_cap"):
        assert got[k] == getattr(ref, k), k
    assert port._delta_bound == ref._delta_bound
    assert port._batches_since_merge == ref._batches_since_merge


def write_shapes(rng, n, now):
    """Point txns of one write each and no read, over keys on every
    shard."""
    return [([], [(k, k + b"\x00")], now) for k in
            (point_key(int(rng.integers(0, 256)), int(rng.integers(0, 40)))
             for _ in range(n))]


SHAPES = {"point": point_shapes, "range": range_shapes,
          "writes": write_shapes}


def run_pair(meshes, plan, seed, splits=None, gc_interval=3, extra=None,
             capacity=CAP, delta_capacity=DCAP):
    """Drive the reference, the port and the oracle over `plan` (a list of
    (kind, n_txns), kind a key of SHAPES); compare after every batch.
    `extra(i, ref, followers)` runs after batch i and may add port
    backends to `followers`, which resolve every later batch too and are
    compared in the same way."""
    jm, pm = meshes
    rng = np.random.default_rng(seed)
    kw = dict(capacity=capacity, delta_capacity=delta_capacity,
              gc_interval_batches=gc_interval, splits=splits)
    ref = ShardedTpuConflictSet(jm, 0, **kw)
    port = ShardedTorchConflictSet(pm, 0, **kw)
    oracle = OracleConflictSet(0)
    now, followers = 0, []
    for i, (kind, n) in enumerate(plan):
        now += int(rng.integers(1_000_000, 3_000_000))
        shapes = SHAPES[kind](rng, n, now)
        floor = now - 5_000_000 if rng.random() < 0.5 else None
        want = [int(v) for v in ref.resolve(txns(jt, shapes), now, floor)]
        got = [int(v) for v in port.resolve(txns(pt, shapes), now, floor)]
        assert got == want, f"codes differ at batch {i}"
        assert got == [int(v) for v in oracle.resolve(txns(pt, shapes), now,
                                                      floor)]
        assert_same_sharded_state(ref, port)
        for f in followers:
            assert [int(v) for v in f.resolve(txns(pt, shapes), now,
                                              floor)] == want
            assert_same_sharded_state(ref, f)
        if extra is not None:
            extra(i, ref, followers)
    return ref, port, followers


def test_stream_matches_reference(meshes):
    """Compact point batches and general batches whose ranges straddle the
    equi-depth splits, merging every 3 batches with floor advances and
    rebases.  A batch of 256 writes (514 delta slots, past the 512-slot
    delta) grows every shard's delta, and the merge three batches later
    shrinks it back.  Midway the reference's state is loaded into a fresh
    port backend, which then keeps in step too."""
    splits = equi_depth_splits()
    d_caps = []

    def extra(i, ref, followers):
        d_caps.append(ref.d_cap)
        if i == 3:
            fresh = ShardedTorchConflictSet(meshes[1], 0, capacity=CAP,
                                            delta_capacity=DCAP,
                                            gc_interval_batches=3,
                                            splits=splits)
            state = {k: np.asarray(getattr(ref, k)) for k in STATE_KEYS}
            state.update(version_base=ref.version_base,
                         oldest_version=ref.oldest_version, d_cap=ref.d_cap,
                         delta_bound=ref._delta_bound,
                         batches_since_merge=ref._batches_since_merge)
            sharded_state_from_numpy(fresh, state)
            assert_same_sharded_state(ref, fresh)
            followers.append(fresh)

    plan = [("point", 24), ("range", 10), ("point", 40), ("range", 12),
            ("point", 24), ("writes", 256), ("point", 20), ("point", 30),
            ("point", 24), ("range", 10), ("point", 30), ("range", 8)]
    ref, port, followers = run_pair(meshes, plan, seed=11, splits=splits,
                                    extra=extra)
    assert port.profile["compact_batches"] >= 6
    assert port.profile["general_batches"] >= 3
    assert port.profile["merges"] >= 3 and port.version_base > 0
    assert 2 * DCAP in d_caps and d_caps[-1] == DCAP, d_caps
    sizes = port.shard_sizes()
    assert sum(1 for s in sizes if s > 1) == 4, sizes
    assert sizes == [int(x) for x in np.asarray(ref.size)]
    assert len(followers) == 1


def test_overflow_flag_raises_in_step(meshes):
    """Pinned floor, tiny per-shard capacity, every key on one shard under
    even splits: that shard's base overflows and the sticky flag
    (combined by max over the shards) raises at the same batch in both
    backends."""
    jm, pm = meshes
    kw = dict(capacity=256, delta_capacity=256)
    ref = ShardedTpuConflictSet(jm, 0, **kw)
    port = ShardedTorchConflictSet(pm, 0, **kw)
    now = 0
    for i in range(60):
        now += 1_000
        keys = [point_key(1, i * 10 + j) for j in range(10)]
        shapes = [([], [(k, k + b"\x00")], 0) for k in keys]
        outcome = []
        for cs, mod, err in ((ref, jt, JaxError), (port, pt, FdbError)):
            try:
                outcome.append([int(v) for v in cs.resolve(txns(mod, shapes),
                                                           now)])
            except err as e:
                assert "capacity exceeded" in str(e)
                outcome.append("raised")
        assert outcome[0] == outcome[1], f"batch {i}: {outcome}"
        if outcome[0] == "raised":
            break
    else:
        raise AssertionError("the overflow flag never raised")
    flags = sharded_state_to_numpy(port)["flag"]
    np.testing.assert_array_equal(flags, np.asarray(ref.flag))
    assert flags.tolist() == [1, 0, 0, 0]


@pytest.mark.parametrize("seed", [5, 6])
def test_matches_one_device_backend_and_oracle(seed):
    """Shard count is invisible: the sharded backend, the one-device
    backend and the oracle agree verdict for verdict (port only)."""
    rng = np.random.default_rng(seed)
    mesh = make_conflict_mesh(["cpu"] * 4)
    assert mesh.shape == {"kr": 4, "q": 1}
    sharded = new_conflict_set("sharded", mesh=mesh, capacity=CAP,
                               delta_capacity=DCAP, gc_interval_batches=2,
                               splits=equi_depth_splits())
    # The factory's "sharded" is supervised, as the reference's is.
    assert isinstance(sharded, SupervisedConflictSet)
    assert isinstance(sharded.device, ShardedTorchConflictSet)
    single = TorchConflictSet(0, capacity=4 * CAP, device="cpu")
    oracle = OracleConflictSet(0)
    now = 0
    for i in range(8):
        now += 1_000_000
        shapes = (point_shapes(rng, 30, now) if i % 2
                  else range_shapes(rng, 12, now))
        floor = now - 5_000_000
        got = [int(v) for v in sharded.resolve(txns(pt, shapes), now, floor)]
        assert got == [int(v) for v in single.resolve(txns(pt, shapes), now,
                                                      floor)]
        assert got == [int(v) for v in oracle.resolve(txns(pt, shapes), now,
                                                      floor)]
    assert sharded.device.segment_count() >= 4
    assert min(sharded.device.shard_sizes()) > 1
    st = sharded.status()
    assert (st["device_batches"], st["fallback_batches"],
            st["rechecked_batches"]) == (8, 0, 0)
