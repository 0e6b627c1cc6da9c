"""The port's ShardedWindow against the JAX ShardedWindow, exactly.

Both run at kr=4, q=2: the reference on the conftest's 8 virtual CPU
devices, the port on make_conflict_mesh(["cpu"] * 8).  The same seeded
batches go through both; after every step the conflict bits, the overflow
flag and every shard's state (bk uint32[D, 8, CAP] planar, bv, size) must
be equal, through a skewed batch that overflows one shard (the insert is
all-or-nothing across the mesh, so every shard keeps its state) and a gc
with rebase.  The host helpers (default_mesh_axes, digest_splits,
splits_from_sample) equal the reference's.  Integer data: tolerance 0.
"""

import numpy as np
import pytest

from foundationdb_tpu.parallel import sharded_window as jsw
from foundationdb_tpu_torch.ops.digest import KEY_LANES, encode_keys
from foundationdb_tpu_torch.parallel import sharded_window as tsw

R, W = 64, 32
CAP = 1 << 7


def rand_ranges(rng, n, lead=None):
    """n ranges [a, b) of random 1-11 byte keys; with `lead`, n point
    ranges [k, k + b"\x00") of keys starting with that byte, which puts
    every range on one shard under even splits."""
    begins, ends = [], []
    for _ in range(n):
        a, b = (bytes(rng.integers(0, 256, size=int(rng.integers(1, 12)),
                                   dtype=np.uint8)) for _ in range(2))
        if lead is not None:
            a = b = bytes([lead]) + a
        a, b = min(a, b), max(a, b)
        begins.append(a)
        ends.append(b if b != a else a + b"\x00")
    return encode_keys(begins), encode_keys(ends, round_up=True)


def batch(rng, version, lead=None):
    qb, qe = rand_ranges(rng, R)
    snap = rng.integers(0, max(version, 1), size=R).astype(np.int32)
    qvalid = rng.random(R) < 0.9
    wb, we = rand_ranges(rng, W, lead)
    wvalid = rng.random(W) < 0.95
    return qb, qe, snap, qvalid, wb, we, wvalid


def assert_same_state(ref, port):
    bk, bv, size = port.state_to_numpy()
    np.testing.assert_array_equal(bk, np.asarray(ref.bk))
    np.testing.assert_array_equal(bv, np.asarray(ref.bv))
    np.testing.assert_array_equal(size, np.asarray(ref.size))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 16])
def test_mesh_axes_and_splits_match_reference(n):
    assert tsw.default_mesh_axes(n) == jsw.default_mesh_axes(n)
    np.testing.assert_array_equal(tsw.digest_splits(n),
                                  jsw.digest_splits(n))
    rng = np.random.default_rng(n)
    keys = [b"k%014d" % int(i) for i in rng.integers(0, 10**6, size=300)]
    sample = encode_keys(keys)
    np.testing.assert_array_equal(tsw.splits_from_sample(sample, n),
                                  jsw.splits_from_sample(sample, n))


def test_make_conflict_mesh_shapes():
    mesh = tsw.make_conflict_mesh(["cpu"] * 8)
    assert mesh.shape == {"kr": 4, "q": 2}
    assert mesh.shape == dict(jsw.make_conflict_mesh(n_devices=8).shape)
    assert tsw.make_conflict_mesh(["cpu"] * 8, n_devices=4).shape == \
        {"kr": 4, "q": 1}
    assert mesh.lead == mesh.devices[1][1] == mesh.devices[0][0]


def test_sharded_window_matches_reference():
    """Spread batches, then skewed ones (every write on shard 0) until one
    overflows that shard: both leave every shard unchanged and report the
    overflow; a gc with rebase frees the window and the same skewed step
    then commits, in both."""
    run_against_reference(["cpu"] * 8)


def test_sharded_window_split_rows_match_reference():
    """The same with each mesh row over two distinct devices ("cpu" and
    "cpu:0" compare unequal), so every shard's queries run in two spans
    and its partial is joined on the lead before the combine."""
    mesh = tsw.make_conflict_mesh(["cpu", "cpu:0"] * 4)
    assert all(len(tsw.ShardedWindow(mesh, capacity=CAP)._spans(d, R // 2))
               == 2 for d in range(4))
    run_against_reference(["cpu", "cpu:0"] * 4)


def run_against_reference(devices):
    rng = np.random.default_rng(7)
    ref = jsw.ShardedWindow(jsw.make_conflict_mesh(), capacity=CAP)
    port = tsw.ShardedWindow(tsw.make_conflict_mesh(devices), capacity=CAP)
    assert port.n_shards == 4 and port.mesh.shape["q"] == 2
    assert_same_state(ref, port)
    version, overflowed = 0, None

    def step(args, now):
        want_bits, want_ovf = ref.resolve_step(*args, now)
        got_bits, got_ovf = port.resolve_step(*args, now)
        np.testing.assert_array_equal(got_bits.numpy(),
                                      np.asarray(want_bits))
        assert int(got_ovf[0]) == int(bool(want_ovf))
        assert_same_state(ref, port)
        return bool(want_ovf)

    for i in range(12):
        version += 100
        args = batch(rng, version, lead=None if i < 3 else 0x01)
        before = port.state_to_numpy()
        if step(args, version):
            overflowed = args
            after = port.state_to_numpy()
            for a, b in zip(before, after):
                np.testing.assert_array_equal(a, b)
            break
    assert overflowed is not None, "no skewed batch overflowed shard 0"
    sizes = port.shard_sizes()
    assert sizes[0] > max(sizes[1:]), sizes
    version += 100
    for sw in (ref, port):
        sw.gc(version, version // 2)
    assert_same_state(ref, port)
    assert not step(overflowed, version - version // 2 + 1)


def test_resolve_step_takes_device_rows():
    """Tensors of digest rows in, as the card's callers pass them, give the
    same bits and state as the reference's planar numpy layout."""
    import torch
    from foundationdb_tpu_torch.ops.digest import planar_to_rows
    rng = np.random.default_rng(9)
    mesh = tsw.make_conflict_mesh(["cpu"] * 8)
    a, b = tsw.ShardedWindow(mesh, capacity=CAP), tsw.ShardedWindow(
        mesh, capacity=CAP)
    for version in (100, 200):
        args = batch(rng, version)
        rows = [torch.from_numpy(planar_to_rows(x)) if x.shape[0] ==
                KEY_LANES and x.ndim == 2 else torch.from_numpy(x)
                for x in args]
        bits_a, ovf_a = a.resolve_step(*args, version)
        bits_b, ovf_b = b.resolve_step(*rows, version)
        assert torch.equal(bits_a, bits_b) and torch.equal(ovf_a, ovf_b)
        for x, y in zip(a.state_to_numpy(), b.state_to_numpy()):
            np.testing.assert_array_equal(x, y)
