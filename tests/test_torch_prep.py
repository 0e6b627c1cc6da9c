"""compact_prep, the compact step's unpacking, on its edge cases on the CPU.

compact_prep (conflict/fused.py) widens a packed batch's unique keys to
rows, marks the too-old txns and counts the ranks that rebuild each read's
and write's txn.  Its plain version is held against the JAX block it
replaces (foundationdb_tpu/conflict/fused.py:300-330, written out below
with the reference's rank_count) on: a first txn that starts after read 0
(the reads before it belong to txn -1), unsorted starts with negative
values, values at and past the pads and duplicates, txns at and past n_t
with n_t at 0 and at t_cap, u_n at 0 and at u_pad, and lw 16, 7 (not a
multiple of 4) and 32 (lane 7 all 0xFF bytes, so the end's +1 wraps).

`rank_scan_model` is a numpy model of the kernel's counting (csrc/
intra_batch.cu ib_unpack): the histograms of the starts and their
per-tile totals, then the scan's tiles, each the sum of its segment's
earlier tiles' totals plus a scan of its own counts.  It is held equal to
the plain rank counts at tile sizes 1, 3, 8 and 64, with each segment's
end inside a tile and at a tile's edge (at tile 1 every end is an edge),
as test_torch_union.py's `sweep_model` is held to the union's plain
version.  The model is checked against the plain version only; the cuda
cases in test_torch_kernels.py test the kernel, on these cases and at the
tiles' edges.

The sharded step unpacks a compact batch once per device and its shards
share the result; a seeded config-5-shaped stream (four shards on one
device, two point reads and one point write a txn, equi-depth splits)
crossing merges gives the same codes and state as unpacking once per
shard.

The cases are built without JAX (the cuda tests reuse them); JAX is
imported inside the tests that call the reference.  Integer data:
tolerance 0.
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch.conflict import fused
from foundationdb_tpu_torch.ops import digest

PREP_CASES = ["sorted", "unsorted", "n_t_zero", "n_t_full", "u_n_zero",
              "u_n_full", "lw_7", "lw_32"]
INPUTS = ("ub", "r_start", "w_start", "t_snap", "t_flags", "scal")


def prep_case(name: str, seed: int = 0, t_cap: int = 64, r_pad: int = 203,
              w_pad: int = 101, u_pad: int = 37) -> dict:
    """compact_prep's inputs (numpy) for one named case and its shapes
    under "shape": (t_cap, r_pad, w_pad, u_pad, lw).  Every case has
    padding txns past n_t (but n_t_full), too-old txns, t_flags with bits
    above bit 0, and reads 0-2 before txn 0's first (but unsorted)."""
    rng = np.random.default_rng(seed)
    lw = {"lw_7": 7, "lw_32": 32}.get(name, 16)
    n_t = {"n_t_zero": 0, "n_t_full": t_cap}.get(name, t_cap - 5)
    u_n = {"u_n_zero": 0, "u_n_full": u_pad}.get(name, u_pad - 4)
    ub = rng.integers(0, 256, size=u_pad * lw + 5, dtype=np.uint8)
    if name == "lw_32":
        ub[:2 * lw] = 0xFF                   # lane 7 of rows 0, 1: MAX
    if name == "unsorted":
        r_start = rng.integers(-5, r_pad + 6, size=t_cap).astype(np.int32)
        w_start = rng.integers(-5, w_pad + 6, size=t_cap).astype(np.int32)
        r_start[1::7] = r_start[0::7][:r_start[1::7].size]  # duplicates
        if t_cap >= 8:
            r_start[2], r_start[3], w_start[4] = r_pad, r_pad + 1, w_pad
            r_start[5], w_start[6] = -3, -1
            assert (np.diff(r_start) < 0).any() and (r_start < 0).any()
    else:
        first = min(3, r_pad)
        r_start = np.sort(rng.integers(first, r_pad + 1,
                                       size=t_cap)).astype(np.int32)
        r_start[:1] = first
        w_start = np.sort(rng.integers(0, w_pad + 1,
                                       size=t_cap)).astype(np.int32)
    oldest = 1000
    t_snap = rng.integers(oldest - 300, oldest + 700,
                          size=t_cap).astype(np.int32)
    t_flags = rng.integers(0, 4, size=t_cap).astype(np.uint8)
    scal = np.array([u_n, r_pad - 7, w_pad - 3, n_t, oldest + 700, oldest],
                    np.int32)
    return {"ub": ub, "r_start": r_start, "w_start": w_start,
            "t_snap": t_snap, "t_flags": t_flags, "scal": scal,
            "shape": (t_cap, r_pad, w_pad, u_pad, lw)}


def prep_port(c: dict, device="cpu", impl=None, n_hist: int = 1,
              offset: int = 0) -> dict:
    """compact_prep on prep_case's inputs; with `offset`, every input is a
    view that many elements into its buffer (no 16-byte loads)."""
    t = {}
    for k in INPUTS:
        x = torch.from_numpy(c[k])
        buf = torch.zeros((offset + x.shape[0],), dtype=x.dtype)
        buf[offset:] = x
        t[k] = buf.to(device)[offset:]
    t_cap, r_pad, w_pad, u_pad, lw = c["shape"]
    return fused.compact_prep(*(t[k] for k in INPUTS), lw, u_pad, r_pad,
                              w_pad, n_hist, impl)


def prep_reference(c: dict) -> dict:
    """foundationdb_tpu/conflict/fused.py:300-330 on the case: u_b, u_e as
    planar uint32[8, u_pad], too_old, and the two rank counts."""
    import jax.numpy as jnp
    from foundationdb_tpu.ops.digest import (KEY_LANES, MAX_DIGEST,
                                             PREFIX_BYTES, rank_count)
    t_cap, r_pad, w_pad, u_pad, lw = c["shape"]
    u_n, _, _, n_t, _, oldest_rel = (int(x) for x in c["scal"])
    L = lw - 1
    ub32 = jnp.asarray(c["ub"][:u_pad * lw].reshape(u_pad, lw)).astype(
        jnp.uint32)
    lanes = []
    for lane in range(KEY_LANES):
        acc = jnp.zeros((u_pad,), jnp.uint32)
        for bi in range(4):
            pos = 4 * lane + bi
            acc = acc * 256
            if pos < L:
                acc = acc + ub32[:, pos]
            elif pos == PREFIX_BYTES:
                acc = acc + ub32[:, L]
        lanes.append(acc)
    pad_u = jnp.arange(u_pad, dtype=jnp.int32) >= u_n
    u_b = jnp.where(pad_u[None, :], jnp.asarray(MAX_DIGEST)[:, None],
                    jnp.stack(lanes))
    u_e = u_b.at[KEY_LANES - 1].add(jnp.where(pad_u, 0, 1).astype(
        jnp.uint32))
    t_valid = jnp.arange(t_cap, dtype=jnp.int32) < n_t
    t_has_reads = (jnp.asarray(c["t_flags"]) & 1) != 0
    too_old = t_valid & t_has_reads & (jnp.asarray(c["t_snap"]) < oldest_rel)
    r_cnt = rank_count(jnp.where(t_valid, jnp.asarray(c["r_start"]), r_pad),
                       r_pad)
    w_cnt = rank_count(jnp.where(t_valid, jnp.asarray(c["w_start"]), w_pad),
                       w_pad)
    return {"u_b": np.asarray(u_b), "u_e": np.asarray(u_e),
            "too_old": np.asarray(too_old).astype(np.int32),
            "r_cnt": np.asarray(r_cnt), "w_cnt": np.asarray(w_cnt)}


@pytest.mark.parametrize("name", PREP_CASES)
def test_compact_prep_matches_reference(name):
    """The plain compact_prep against the reference's block, element for
    element, and its hists zeroed int32[t_cap] buffers."""
    c = prep_case(name)
    want = prep_reference(c)
    got = prep_port(c, n_hist=3)
    for k in ("u_b", "u_e"):
        np.testing.assert_array_equal(digest.rows_to_planar(got[k]), want[k],
                                      err_msg=k)
    for k in ("too_old", "r_cnt", "w_cnt"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    t_cap = c["shape"][0]
    assert len(got["hists"]) == 3
    for h in got["hists"]:
        assert h.dtype == torch.int32 and h.shape == (t_cap,)
        assert not h.any()
    assert want["too_old"].any() or name == "n_t_zero"
    if name == "sorted":                     # reads 0-2 are txn -1's
        assert (want["r_cnt"][:3] == 0).all() and want["r_cnt"][3] >= 1
    if name == "lw_32":                      # the end's +1 wraps
        assert (want["u_e"][7, :2] == 0).all()


def rank_scan_model(c: dict, tile: int):
    """ib_unpack's counting and its scan's tiles in numpy: (r_cnt, w_cnt)
    from the case's starts.  A model of the design, held to the
    plain version only."""
    t_cap, r_pad, w_pad = c["shape"][:3]
    valid = np.arange(t_cap) < int(c["scal"][3])
    segs = []
    for starts, pad in ((c["r_start"], r_pad), (c["w_start"], w_pad)):
        p = np.where(valid, np.clip(starts, 0, pad), pad)
        p = p[p < pad]                       # padding txns count nowhere
        tiles = -(-pad // tile)
        segs.append((np.bincount(p, minlength=pad),
                     np.bincount(p // tile, minlength=tiles), pad, tiles))
    outs = [np.zeros(r_pad, np.int64), np.zeros(w_pad, np.int64)]
    tiles_r = segs[0][3]
    for b in range(max(1, tiles_r + segs[1][3])):
        s = 0 if b < tiles_r else 1
        j = b - (0 if s == 0 else tiles_r)
        hist, tot, pad, _ = segs[s]
        lo, hi = j * tile, min((j + 1) * tile, pad)
        outs[s][lo:hi] = int(tot[:j].sum()) + np.cumsum(hist[lo:hi])
    return tuple(o.astype(np.int32) for o in outs)


@pytest.mark.parametrize("edge", [True, False])
@pytest.mark.parametrize("tile", [1, 3, 8, 64])
@pytest.mark.parametrize("name", PREP_CASES)
def test_rank_scan_model_equals_plain(name, tile, edge):
    """The kernel's counting by tile totals and local scans gives the
    plain rank counts at every tile size, each segment ending at a tile's
    edge (edge) or inside a tile."""
    r_pad = 5 * tile + (0 if edge else tile // 2 + 1)
    w_pad = 3 * tile + (0 if edge else tile - 1)
    c = prep_case(name, seed=tile, r_pad=r_pad, w_pad=w_pad)
    got = rank_scan_model(c, tile)
    want = prep_port(c)
    np.testing.assert_array_equal(got[0], want["r_cnt"].numpy())
    np.testing.assert_array_equal(got[1], want["w_cnt"].numpy())


def test_read_write_prep_writes_into_given_hist():
    """read_write_prep(hist=...) fills the zeroed buffer it is handed (one
    of compact_prep's hists) and equals the call that makes its own."""
    from test_torch_union import rw_case, rw_port
    c = rw_case(3)
    want = rw_port(c)
    t = {k: torch.from_numpy(c[k]) for k in
         ("r_uid", "w_uid", "r_cnt", "w_cnt", "too_old", "t_snap", "scal",
          "vmax_u")}
    hist = torch.zeros((c["shape"][0],), dtype=torch.int32)
    got = fused.read_write_prep(t["r_uid"], t["w_uid"], t["r_cnt"],
                                t["w_cnt"], t["too_old"], t["t_snap"],
                                t["scal"], t["vmax_u"], c["shape"][3],
                                hist=hist)
    assert got["hist"] is hist and hist.any()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    with pytest.raises(ValueError):
        fused.read_write_prep(t["r_uid"], t["w_uid"], t["r_cnt"],
                              t["w_cnt"], t["too_old"], t["t_snap"],
                              t["scal"], t["vmax_u"], c["shape"][3],
                              hist=hist[1:])


class PerShardStep(fused.CompactStep):
    """The compact step with one unpack a shard: `unpack` only carries the
    buffer, and each shard's `probe` unpacks it again."""

    def unpack(self, buf, n_hist=1):
        return {"buf": buf, "hists": [None] * n_hist}

    def probe(self, u, bk, table, dk, dtable, bounds, hist):
        own = fused.CompactStep.unpack(self, u["buf"])
        return fused.CompactStep.probe(self, own, bk, table, dk, dtable,
                                       bounds, own["hists"][0])


def test_sharded_shared_unpack_equals_per_shard(monkeypatch):
    """Four shards on one device share one compact_prep a batch; codes and
    every shard's state equal those of unpacking once per shard, batch
    for batch, over a config-5-shaped stream crossing merges."""
    from foundationdb_tpu_torch.parallel import (ShardedTorchConflictSet,
                                                 make_conflict_mesh,
                                                 sharded_state_to_numpy,
                                                 splits_from_sample)
    from foundationdb_tpu_torch.txn import types as pt
    keys = [b"k%014d" % i for i in range(2000)]
    splits = splits_from_sample(digest.encode_keys(keys[::7]), 4)
    kw = dict(capacity=1 << 10, delta_capacity=1 << 9,
              gc_interval_batches=2, splits=splits)
    mesh = make_conflict_mesh(["cpu"] * 4)
    shared = ShardedTorchConflictSet(mesh, 0, **kw)
    per_shard = ShardedTorchConflictSet(mesh, 0, **kw)
    calls = []
    real_prep = fused.compact_prep
    monkeypatch.setattr(fused, "compact_prep",
                        lambda *a, **k: calls.append(1) or real_prep(*a, **k))
    rng = np.random.default_rng(55)
    now = 0
    for _ in range(6):
        now += 1_000_000
        n = 60
        kid = rng.integers(0, len(keys), size=3 * n)
        snaps = np.maximum(now - rng.integers(0, 3_000_000, size=n), 0)
        def point(k):
            return pt.KeyRange(keys[k], keys[k] + b"\x00")

        batch = [pt.CommitTransactionRef(
            read_conflict_ranges=[point(k) for k in kid[2 * t:2 * t + 2]],
            write_conflict_ranges=[point(kid[2 * n + t])],
            read_snapshot=int(snaps[t])) for t in range(n)]
        floor = now - 4_000_000
        calls.clear()
        got = [int(v) for v in shared.resolve(batch, now, floor)]
        assert len(calls) == 1
        with monkeypatch.context() as m:
            m.setattr(fused, "make_resolve_step_compact",
                      lambda *a, **k: PerShardStep(*a, **k))
            calls.clear()
            want = [int(v) for v in per_shard.resolve(batch, now, floor)]
            assert len(calls) == 4
        assert got == want
        a, b = sharded_state_to_numpy(shared), sharded_state_to_numpy(
            per_shard)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
    assert shared.profile["merges"] >= 1
    assert min(shared.shard_sizes()) > 1
    assert {0, 2} <= set(got)
