"""Every CUDA kernel of the port against its plain-torch version, on the card.

Marked `cuda`: each test asks for the `dev` fixture, which skips when no
CUDA device is present (this file runs on a GPU machine, where
JAX is not installed, so it imports only numpy, torch and the port).  All
data is integer, so every comparison is exact (tolerance 0).

Run on the card: python -m pytest -m cuda tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch import kernels as K
from foundationdb_tpu_torch.conflict import fused
from foundationdb_tpu_torch.conflict.encoded import EncodedBatch
from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet
from foundationdb_tpu_torch.conflict.torch_backend import (TorchConflictSet,
                                                           state_to_numpy)
from foundationdb_tpu_torch.ops import digest, rangemax, scan
from foundationdb_tpu_torch.ops.rangemax import NEG_INF
from foundationdb_tpu_torch.ops.sort import SORT_TILE
from foundationdb_tpu_torch.txn.types import CommitTransactionRef, KeyRange

from test_torch_codes import (CODES_CASES, GPREP_CASES, codes_case,
                              codes_port, gprep_case, gprep_port)
from test_torch_gc import (GC_CASES, GCODES_CASES, gc_case, gc_port,
                           gc_state, gcodes_case, gcodes_port, runs_mask)
from test_torch_insert import CASES as INSERT_CASES, make_case, run_port
from test_torch_prep import PREP_CASES, prep_case, prep_port
from test_torch_probe import search_top
from test_torch_union import (UNION_CASES, rw_case, rw_port,
                              union_case)

pytestmark = pytest.mark.cuda

KEYSPACE = 6000


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    K.build()
    return torch.device("cuda")


def same(got, want):
    if isinstance(got, (tuple, list)):
        for g, w in zip(got, want):
            same(g, w)
        return
    if isinstance(got, dict):
        for k in got:
            same(got[k], want[k])
        return
    assert got.shape == want.shape
    assert torch.equal(got.cpu().long(), want.cpu().long())


def key_digests(kids) -> np.ndarray:
    kids = np.asarray(kids, dtype=np.int64)
    mat = np.empty((kids.size, 15), dtype=np.uint8)
    mat[:, 0] = ord("k")
    x = kids.copy()
    for d in range(14):
        mat[:, 14 - d] = 48 + x % 10
        x //= 10
    return digest.encode_fixed(mat)


def sorted_rows(rng, n: int, cap: int, edge=False) -> torch.Tensor:
    """All-keys boundary + n distinct point boundaries, MAX-padded rows."""
    if edge:
        lanes = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                          0xFFFFFFFF], np.uint32)
        d = lanes[rng.integers(0, lanes.size, size=(8, n))]
    else:
        d = key_digests(rng.choice(KEYSPACE, size=n, replace=False))
        d[7] += rng.integers(0, 2, size=n).astype(np.uint32)
    s = np.unique(digest.planar_to_s24(d))[:cap - 1]
    planar = s.view(np.uint8).reshape(-1, 32).view(">u4").astype(np.uint32).T
    out = digest.max_digest_block(cap)
    out[:, 0] = 0
    out[:, 1:1 + planar.shape[1]] = planar
    return torch.from_numpy(digest.planar_to_rows(out)), 1 + planar.shape[1]


def make_state(dev, seed=1, cap=1 << 12, d_cap=1 << 10, live_b=2000,
               live_d=300, flag=0) -> dict:
    rng = np.random.default_rng(seed)
    bk, size = sorted_rows(rng, live_b, cap)
    dk, dsize = sorted_rows(rng, live_d, d_cap)
    bv = torch.full((cap,), NEG_INF, dtype=torch.int32)
    bv[:size] = torch.from_numpy(rng.integers(0, 4000, size=size,
                                              dtype=np.int32))
    dv = torch.full((d_cap,), NEG_INF, dtype=torch.int32)
    dv[1:dsize] = torch.from_numpy(rng.integers(4000, 6000, size=dsize - 1,
                                                dtype=np.int32))
    st = {"bk": bk, "bv": bv, "size": torch.tensor([size], dtype=torch.int32),
          "dk": dk, "dv": dv,
          "dsize": torch.tensor([dsize], dtype=torch.int32),
          "flag": torch.tensor([flag], dtype=torch.int32)}
    st["table"] = rangemax.build_sparse_table(bv)
    st["dtable"] = rangemax.build_sparse_table(dv)
    return {k: v.to(dev) for k, v in st.items()}


def copy(st):
    return {k: v.clone() for k, v in st.items()}


def packed_batch(seed, n_txns=3000, now=7000, oldest=2500):
    """A point batch over the state's keyspace, packed and stamped."""
    rng = np.random.default_rng(seed)
    kids = rng.zipf(1.2, size=3 * n_txns) % KEYSPACE
    d = key_digests(kids)
    e = d.copy()
    e[7] += 1
    nr = 2 * n_txns
    enc = EncodedBatch(
        n_txns=n_txns,
        t_snap=rng.integers(oldest - 500, now, size=n_txns).astype(np.int64),
        t_has_reads=np.ones(n_txns, bool),
        r_txn=np.arange(nr, dtype=np.int32) // 2, r_begin=d[:, :nr],
        r_end=e[:, :nr], w_txn=np.arange(n_txns, dtype=np.int32),
        w_begin=d[:, nr:], w_end=e[:, nr:], all_point=True)
    packed = TorchConflictSet._pack_compact(enc)
    meta = packed["meta"]
    meta[packed["snap_off"]:packed["snap_off"] + n_txns] = enc.t_snap
    meta[packed["scalar_off"]:packed["scalar_off"] + 2] = (now, oldest)
    return packed


def step_inputs(dev, packed):
    t_cap, r_pad, w_pad, u_pad, lw = packed["shapes"]
    lay = fused.compact_layout(t_cap, r_pad, w_pad, u_pad, lw)
    buf = torch.from_numpy(packed["buf"]).to(dev)
    b32 = buf.view(torch.int32)

    def i32(name, n):
        return b32[lay[name] // 4:lay[name] // 4 + n]

    return {"buf": buf, "ub": buf[:u_pad * lw], "r_uid": i32("r_uid", r_pad),
            "w_uid": i32("w_uid", w_pad), "r_start": i32("r_start", t_cap),
            "w_start": i32("w_start", t_cap), "t_snap": i32("t_snap", t_cap),
            "t_flags": buf[lay["t_flags"]:lay["t_flags"] + t_cap],
            "scal": i32("scalars", fused.COMPACT_SCALARS),
            "shapes": packed["shapes"]}


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 3 << 20])
def test_inclusive_scan(dev, n):
    x = torch.randint(-3, 4, (n,), dtype=torch.int32, device=dev)
    same(scan.inclusive_scan(x), scan.inclusive_scan(x, impl="plain"))


SCAN_TILE = scan.SCAN_TILE


@pytest.mark.parametrize("values", ["ones", "mask", "wrap"])
@pytest.mark.parametrize("n", [0, 1, SCAN_TILE - 1, SCAN_TILE, SCAN_TILE + 1,
                               3 << 20, (1 << 24) + SCAN_TILE + 1])
def test_inclusive_scan_single_pass(dev, n, values):
    """The single-pass scan at tile edges, at the merge's 3 * 2^20 and
    above the two-level scan's old 2^24 limit: bit-equal to the plain
    version, one launch per call.  "wrap" sums past 2^31 and wraps in
    int32 as torch.cumsum does."""
    g = torch.Generator(device=dev).manual_seed(n)
    if values == "ones":
        x = torch.ones((n,), dtype=torch.int32, device=dev)
    elif values == "mask":
        x = (torch.rand((n,), generator=g, device=dev) < 0.5).to(torch.int32)
    else:
        x = torch.randint(1 << 28, 1 << 30, (n,), generator=g,
                          dtype=torch.int32, device=dev)
    K.reset_counts()
    got = scan.inclusive_scan(x)
    assert K.LAUNCHES["inclusive_scan"] == 1
    same(got, scan.inclusive_scan(x, impl="plain"))
    if values == "wrap" and n > 8:
        assert int(got.min()) < 0


def test_inclusive_scan_unaligned(dev):
    """A view that starts off a 16-byte boundary takes the scalar loads."""
    x = torch.randint(-5, 6, (3 * SCAN_TILE + 7,), dtype=torch.int32,
                      device=dev)[3:]
    same(scan.inclusive_scan(x), scan.inclusive_scan(x, impl="plain"))


def test_rank_count(dev):
    """rank_count has no kernel (only plain versions call it): its kernel
    route raises on the card, and its plain version runs there."""
    pos = torch.randint(-5, 70000, (200000,), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="no kernel"):
        digest.rank_count(pos, 1000)
    got = digest.rank_count(pos, 1000, impl="plain")
    want = torch.searchsorted(torch.sort(pos.cpu()).values,
                              torch.arange(1000, dtype=torch.int32),
                              right=True).to(torch.int32)
    same(got, want)


@pytest.mark.parametrize("rebase", [None, 0, 100, -(1 << 31) + 5])
def test_compact_rows(dev, rebase):
    n = 100000
    keep = (torch.rand(n, device=dev) < 0.6).to(torch.int32)
    incl = scan.inclusive_scan(keep)
    rows = torch.randint(-(1 << 31), (1 << 31) - 1, (n, 8),
                         dtype=torch.int32, device=dev)
    vals = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), dtype=torch.int32,
                         device=dev)
    vals[:10] = NEG_INF
    outs = []
    for impl in (None, "plain"):
        dr = torch.full((n // 2, 8), -1, dtype=torch.int32, device=dev)
        dv = torch.full((n // 2,), 7, dtype=torch.int32, device=dev)
        scan.compact_rows(keep, incl, rows, vals, dr, dv, rebase=rebase,
                          impl=impl)
        outs.append((dr, dv))
    same(outs[0], outs[1])


def table_values(dev, cap: int, seed: int) -> torch.Tensor:
    """Random int32 values with NEG_INF, -2^31 (below NEG_INF: a max with
    the fill past the end must raise it), 2^31 - 1 and, at the last
    position, -2^31 again."""
    g = torch.Generator().manual_seed(seed)
    v = torch.randint(-(1 << 31), (1 << 31) - 1, (cap,), dtype=torch.int32,
                      generator=g)
    pick = torch.randint(0, 4, (cap,), generator=g)
    v[pick == 0] = NEG_INF
    v[pick == 1] = -(1 << 31)
    v[(pick == 2) & (torch.rand(cap, generator=g) < 0.1)] = (1 << 31) - 1
    v[-1] = -(1 << 31)
    return v.to(dev)


@pytest.mark.parametrize("cap", [1 << k for k in range(22)])
def test_build_sparse_table(dev, cap):
    """Every power of two to 2^21: equal to the plain version, written in
    place into an existing table when `out` is given, in at most two
    launches (one up to the tile)."""
    v = table_values(dev, cap, cap)
    want = rangemax.build_sparse_table(v, impl="plain")
    K.reset_counts()
    same(rangemax.build_sparse_table(v), want)
    assert K.LAUNCHES["build_sparse_table"] == (
        1 if cap <= 1 << rangemax.tile_log(cap) else 2)
    out = torch.full_like(want, 7)
    assert rangemax.build_sparse_table(v, out=out) is out
    same(out, want)


@pytest.mark.parametrize("cap", [3, 5, 6, 7, 100, 4095, 4097, 12_289,
                                 (1 << 20) + 3, (1 << 21) - 4])
def test_build_sparse_table_any_cap(dev, cap):
    """CAPs that are not powers of two (single-int loads and stores where
    CAP % 4 != 0, a ragged last tile and residue class)."""
    v = table_values(dev, cap, cap)
    same(rangemax.build_sparse_table(v),
         rangemax.build_sparse_table(v, impl="plain"))


@pytest.mark.parametrize("edge", [False, True])
def test_searchsorted_and_history(dev, edge):
    rng = np.random.default_rng(3)
    bk, _ = sorted_rows(rng, 2000, 4096, edge)
    dk, _ = sorted_rows(rng, 300, 1024, edge)
    bk, dk = bk.to(dev), dk.to(dev)
    q = torch.cat([bk[torch.randint(0, 4096, (3000,))],
                   dk[torch.randint(0, 1024, (1000,))],
                   torch.randint(-(1 << 31), (1 << 31) - 1, (500, 8),
                                 dtype=torch.int32).to(dev)])
    for left in (True, False):
        for table in (bk, dk):
            same(digest.searchsorted(table, q, left),
                 digest.searchsorted(table, q, left, impl="plain"))
    qe = q.clone()
    qe[:, 7] += 1
    bv = torch.randint(-100, 5000, (4096,), dtype=torch.int32, device=dev)
    dv = torch.randint(-100, 5000, (1024,), dtype=torch.int32, device=dev)
    bt, dt = rangemax.build_sparse_table(bv), rangemax.build_sparse_table(dv)
    same(digest.history_probe(bk, bt, dk, dt, q, qe),
         digest.history_probe(bk, bt, dk, dt, q, qe, impl="plain"))


EDGE_LANES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                       0xFFFFFFFF], np.uint32)


def search_table(rng, cap: int, live: int, kind: str) -> torch.Tensor:
    """A searchsorted table int32[cap, 8]: "sorted" (up to `live` unique
    rows with lanes at the uint32 edges, then MAX padding) or "unsorted"
    (random rows: the search is path-exact, so any table gives the plain
    version's answer)."""
    d = rng.integers(0, 1 << 32, size=(live, 8), dtype=np.uint64).astype(
        np.uint32)
    edge = rng.random((live, 8)) < 0.3
    d[edge] = EDGE_LANES[rng.integers(0, EDGE_LANES.size, size=edge.sum())]
    d[:, 0] = EDGE_LANES[rng.integers(0, 4, size=live)]  # shared lane 0
    if kind == "unsorted":
        return torch.from_numpy(d.view(np.int32))
    s = np.unique(digest.planar_to_s24(np.ascontiguousarray(d.T)))[:cap]
    planar = s.view(np.uint8).reshape(-1, 32).view(">u4").astype(np.uint32).T
    out = digest.max_digest_block(cap)
    out[:, :planar.shape[1]] = planar
    return torch.from_numpy(digest.planar_to_rows(out))


@pytest.mark.parametrize("cap,live,nq,kind", [
    (1, 1, 3, "sorted"), (2, 1, 5, "sorted"), (256, 200, 9, "sorted"),
    (1 << 10, 1 << 10, 1023, "sorted"), (1 << 12, 3000, 1, "sorted"),
    (1 << 12, 3000, 4097, "sorted"), (1 << 12, 1 << 12, 4093, "unsorted"),
    (1 << 21, 910_000, 1_179_651, "sorted")])
def test_searchsorted_staged(dev, cap, live, nq, kind):
    """ds_search against its plain version on both sides: tables below,
    at and above the staged depth, the general step's 2^21 universe with
    more queries than the card holds threads, query counts that are odd
    and not a multiple of the chains a thread; queries that are rows of
    the table (ties), rows with lanes at 0, 0x7FFFFFFF, 0x80000000 and
    0xFFFFFFFF, MAX rows and zero rows; one launch a call."""
    rng = np.random.default_rng(cap + nq)
    table = search_table(rng, cap, live, kind)
    q = table[rng.integers(0, cap, size=nq)].clone()
    edge = torch.from_numpy(rng.random(nq) < 0.3)
    q[edge] = torch.from_numpy(EDGE_LANES[rng.integers(
        0, EDGE_LANES.size, size=(int(edge.sum()), 8))].view(np.int32))
    q[rng.integers(0, nq, size=max(nq // 5, 1))] = -1
    q[rng.integers(0, nq, size=max(nq // 50, 1))] = 0
    table, q = table.to(dev), q.to(dev)
    for left in (True, False):
        K.reset_counts()
        got = digest.searchsorted(table, q, left)
        assert K.LAUNCHES["searchsorted"] == 1
        same(got, digest.searchsorted(table, q, left, impl="plain"))


def combine_views(rng, dev, d: int, n: int):
    """d int32[n] partials as views at odd offsets of one buffer, and
    their values stacked [d, n]."""
    parts = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(d, n),
                                          dtype=np.int64).astype(np.int32))
    parts[:, 0] = 0x7FFFFFFF
    flat = torch.zeros((d * (n + 9) + 3,), dtype=torch.int32, device=dev)
    views = [flat[3 + k * (n + 9) + k:][:n] for k in range(d)]
    for v, p in zip(views, parts):
        v.copy_(p)
    return views, parts.to(dev)


@pytest.mark.parametrize("d", [1, 4, 8])
def test_shard_combine_in_place(dev, d):
    """sh_combine over partials read in place (views at odd offsets, none
    16-byte aligned; compact_prep's hists in its scratch) against the
    plain version and the [D, n] form: one launch a call, no partial
    written; more than eight partials raise on the card."""
    from foundationdb_tpu_torch.ops import shard
    rng = np.random.default_rng(d)
    n = 65_539
    views, parts = combine_views(rng, dev, d, n)
    for n_max in (None, 0, 2, n):
        K.reset_counts()
        got = shard.shard_combine(views, n_max)
        assert K.LAUNCHES["shard_combine"] == 1
        same(got, shard.shard_combine(views, n_max, impl="plain"))
        same(got, shard.shard_combine(parts, n_max))
    same(torch.stack(views), parts)
    x = step_inputs(dev, packed_batch(4))
    t_cap, r_pad, w_pad, u_pad, lw = x["shapes"]
    hists = fused.compact_prep(x["ub"], x["r_start"], x["w_start"],
                               x["t_snap"], x["t_flags"], x["scal"], lw,
                               u_pad, r_pad, w_pad, n_hist=d)["hists"]
    for h in hists:
        h.copy_(torch.randint(0, 2, (t_cap,), dtype=torch.int32,
                              device=dev))
    same(shard.shard_combine(hists), shard.shard_combine(hists,
                                                         impl="plain"))
    with pytest.raises(ValueError):
        shard.shard_combine(combine_views(rng, dev, 9, 5)[0])


def test_step_blocks(dev):
    """compact_prep (one launch a call and no fill), read_write_prep (one
    launch, into compact_prep's hist), the fixpoint alone and the fixpoint
    with the codes (one launch), each on the plain version's inputs."""
    st = make_state(dev)
    x = step_inputs(dev, packed_batch(4))
    t_cap, r_pad, w_pad, u_pad, lw = x["shapes"]
    P = "plain"
    args = (x["ub"], x["scal"], lw, u_pad)
    prep_in = (x["ub"], x["r_start"], x["w_start"], x["t_snap"],
               x["t_flags"], x["scal"], lw, u_pad, r_pad, w_pad)
    prep = fused.compact_prep(*prep_in, impl=P)
    same((prep["u_b"], prep["u_e"]), digest.widen_unique(*args, impl=P))
    K.reset_counts()
    got = fused.compact_prep(*prep_in)
    assert K.LAUNCHES["compact_prep"] == 1
    assert sum(K.LAUNCHES.values()) == 1
    same(got, prep)
    too_old, r_cnt, w_cnt = prep["too_old"], prep["r_cnt"], prep["w_cnt"]
    vmax = digest.history_probe(st["bk"], st["table"], st["dk"],
                                st["dtable"], prep["u_b"], prep["u_e"], P)
    rw = fused.read_write_prep(x["r_uid"], x["w_uid"], r_cnt, w_cnt, too_old,
                               x["t_snap"], x["scal"], vmax, u_pad, P)
    K.reset_counts()
    hist = got["hists"][0]
    same(fused.read_write_prep(x["r_uid"], x["w_uid"], r_cnt, w_cnt,
                               too_old, x["t_snap"], x["scal"], vmax, u_pad,
                               hist=hist),
         rw)
    assert K.LAUNCHES["read_write_prep"] == 1
    same(hist, rw["hist"])
    args = (rw["hist"], rw["r_txn"], rw["r_live"], rw["r_slot"], rw["w_txn"],
            rw["w_ok"], rw["w_slot"], u_pad)
    conf, rounds = fused.intra_batch_fixpoint(*args, impl=P)
    got, got_rounds = fused.intra_batch_fixpoint(*args)
    same(got, conf)
    assert int(got_rounds[0]) == int(rounds[0]) >= 2
    codes = [torch.empty((t_cap,), dtype=torch.int8, device=dev)
             for _ in range(2)]
    want = fused.intra_batch_fixpoint(*args, impl=P, codes_out=codes[0],
                                      scal=x["scal"], too_old=too_old)
    w_ins = fused.batch_codes(x["scal"], too_old, conf, rw["w_txn"],
                              torch.empty_like(codes[0]), P)
    same(want, (conf, rounds, w_ins))
    K.reset_counts()
    same(fused.intra_batch_fixpoint(*args, codes_out=codes[1], scal=x["scal"],
                                    too_old=too_old), want)
    assert K.LAUNCHES["intra_batch_fixpoint"] == 1
    assert sum(K.LAUNCHES.values()) == 1
    same(codes[1], codes[0])
    assert {0, 1, 2} <= set(codes[0][:3000].tolist())


def chain_fixpoint_inputs(dev, depth: int, t_cap: int, seed: int = 0):
    """Fixpoint inputs of a batch whose first `depth` txns form a chain
    (txn i reads the key txn i - 1 writes), the rest of its t_cap txns
    reading and writing keys of their own: the Jacobi rounds equal the
    depth.  One read and one write a txn, then padding."""
    rng = np.random.default_rng(seed)
    u_pad = 2 * t_cap
    t = np.arange(t_cap, dtype=np.int32)
    r_slot = np.where(t < depth, t - 1, t_cap + t).astype(np.int32)
    r_slot[0] = u_pad - 1
    w_slot = t.copy()
    w_slot[depth:] = rng.permutation(t_cap - depth) + depth
    pad = 256
    cols = {"hist": np.zeros(t_cap, np.int32),
            "r_txn": np.concatenate([t, np.full(pad, t_cap, np.int32)]),
            "r_live": np.concatenate([np.ones(t_cap, np.int32),
                                      np.zeros(pad, np.int32)]),
            "r_slot": np.concatenate([r_slot, np.zeros(pad, np.int32)]),
            "w_txn": t, "w_ok": np.ones(t_cap, np.int32), "w_slot": w_slot}
    return [torch.from_numpy(cols[k]).to(dev) for k in
            ("hist", "r_txn", "r_live", "r_slot", "w_txn", "w_ok",
             "w_slot")], u_pad


@pytest.mark.parametrize("depth,t_cap", [(300, 512), (300, 1 << 17),
                                         (1, 1 << 17)])
def test_intra_batch_fixpoint_deep_chain(dev, depth, t_cap):
    """Hundreds of Jacobi rounds, each three grid-wide barriers, at a
    small width and at config 2's t_cap (every SM busy): conf and rounds
    equal the plain version's, and the rounds equal the chain's depth."""
    args, u_pad = chain_fixpoint_inputs(dev, depth, t_cap)
    K.reset_counts()
    got, got_rounds = fused.intra_batch_fixpoint(*args, u_pad)
    assert K.LAUNCHES["intra_batch_fixpoint"] == 1
    conf, rounds = fused.intra_batch_fixpoint(*args, u_pad, impl="plain")
    same(got, conf)
    assert int(got_rounds[0]) == int(rounds[0]) == max(depth, 1)
    want = np.zeros(t_cap, np.int32)
    want[1:depth:2] = 1            # the chain alternates from txn 0
    assert np.array_equal(got.cpu().numpy(), want)


def check_fixpoint_codes(dev, c):
    """The fixpoint with the codes (tests/test_torch_codes.py codes_port),
    kernel against plain: one launch a call and no other wrapper's."""
    K.reset_counts()
    got = codes_port(c, dev)
    assert K.LAUNCHES["intra_batch_fixpoint"] == 1
    assert sum(K.LAUNCHES.values()) == 1
    same(got, codes_port(c, dev, impl="plain"))
    return got


@pytest.mark.parametrize("name", CODES_CASES)
def test_fixpoint_codes_cases(dev, name):
    """tests/test_torch_codes.py's cases (n_t and n_w at 0 and at the
    pads, t_cap 1, txn -1 reads and writes, too-old writers, every txn
    conflicted, t_cap above and below w_pad, a chain), kernel against
    plain."""
    check_fixpoint_codes(dev, codes_case(name))


# (t_cap, r_pad, w_pad, u_pad) of the compact step's resolve.
FIX_CODES_SHAPES = {
    "config2": (131_072, 212_992, 114_688, 49_152),
    "config5": (65_536, 131_072, 65_536, 196_608),
    "t_cap_gt_w_pad": (5_003, 9_001, 1_003, 700),
    "t_cap_lt_w_pad": (1_003, 9_001, 5_003, 700),
}


@pytest.mark.parametrize("shape", list(FIX_CODES_SHAPES))
@pytest.mark.parametrize("name", ["mixed", "txn_minus_1", "all_conflicted"])
def test_fixpoint_codes_shapes(dev, shape, name):
    """The fused fixpoint and codes at config 2's and a config-5 batch's
    shapes and with t_cap on either side of w_pad (the codes phase covers
    both from the fixpoint's grid), kernel against plain."""
    t_cap, r_pad, w_pad, u_pad = FIX_CODES_SHAPES[shape]
    got = check_fixpoint_codes(dev, codes_case(name, t_cap=t_cap,
                                               r_pad=r_pad, w_pad=w_pad,
                                               u_pad=u_pad))
    assert {-1, 1, 0 if name == "all_conflicted" else 2} <= set(
        got["codes"].unique().tolist())


def test_fixpoint_codes_deep_chain(dev):
    """The 300-deep chain at config 2's t_cap with the codes: conf, rounds,
    codes and the insert mask equal the plain version's, one launch."""
    args, u_pad = chain_fixpoint_inputs(dev, 300, 1 << 17)
    t_cap, r_pad, w_pad = args[0].shape[0], args[1].shape[0], args[4].shape[0]
    rng = np.random.default_rng(3)
    too_old = torch.from_numpy(
        (rng.random(t_cap) < 0.1).astype(np.int32)).to(dev)
    scal = torch.tensor([u_pad, r_pad, w_pad - 17, t_cap - 9, 0, 0],
                        dtype=torch.int32, device=dev)
    outs = []
    for impl in (None, "plain"):
        codes = torch.full((t_cap,), 77, dtype=torch.int8, device=dev)
        K.reset_counts()
        outs.append((*fused.intra_batch_fixpoint(
            *args, u_pad, impl, codes_out=codes, scal=scal, too_old=too_old),
            codes))
        assert K.LAUNCHES["intra_batch_fixpoint"] == (1 if impl is None
                                                     else 0)
    same(outs[0], outs[1])
    assert int(outs[0][1][0]) == 300


def test_batch_codes_plain_only_raises_on_the_card(dev):
    """batch_codes has no kernel of its own (the fixpoint's launch writes
    the codes): on a CUDA tensor without impl="plain" it raises."""
    c = {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v
         for k, v in codes_case("mixed").items()}
    codes = torch.empty((c["shape"][0],), dtype=torch.int8, device=dev)
    with pytest.raises(RuntimeError):
        fused.batch_codes(c["scal"], c["too_old"], c["hist"], c["w_txn"],
                          codes)
    fused.batch_codes(c["scal"], c["too_old"], c["hist"], c["w_txn"], codes,
                      impl="plain")


def check_general_prep(dev, c, offset=0):
    """general_prep kernel against plain: one launch a call (ig_prep) and
    no other wrapper's."""
    K.reset_counts()
    got = gprep_port(c, dev, offset=offset)
    assert K.LAUNCHES["general_prep"] == 1
    assert sum(K.LAUNCHES.values()) == 1
    same(got, gprep_port(c, dev, impl="plain"))
    return got


@pytest.mark.parametrize("layout", ["aligned", "unaligned"])
@pytest.mark.parametrize("name", GPREP_CASES)
def test_general_prep_cases(dev, name, layout):
    """tests/test_torch_codes.py's general_prep cases (n_t, n_r and n_w at
    0 and at the caps, t_cap 1, txn -1 reads and writes, too-old writers,
    writes and no reads, snapshots at the floor, every read a hit), with
    the metadata block 16-byte aligned or one int32 off (no quad loads)."""
    check_general_prep(dev, gprep_case(name),
                       offset=1 if layout == "unaligned" else 0)


@pytest.mark.parametrize("name", ["mixed", "txn_minus_1", "too_old_writers",
                                  "all_conflicted"])
def test_general_prep_config3(dev, name):
    """general_prep at config 3's caps (65,536 txns, 524,288 reads, 65,536
    writes), kernel against plain, one launch."""
    got = check_general_prep(dev, gprep_case(name, t_cap=1 << 16,
                                             r_cap=1 << 19, w_cap=1 << 16))
    assert got["hist"].any() and got["r_live"].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_intra_batch_fixpoint_high_contention(dev, seed):
    """Random reads and writes of a few hundred keys by 2^14 txns, some
    history conflicts, some dead reads and writes: conf and rounds equal
    the plain version's."""
    rng = np.random.default_rng(seed)
    t_cap, r_pad, w_pad, u_pad = 1 << 14, 1 << 15, 1 << 14, 512
    n_r, n_w = 30000, 16000
    r_txn = np.full(r_pad, t_cap, np.int32)
    r_txn[:n_r] = np.sort(rng.integers(0, t_cap, size=n_r))
    w_txn = np.full(w_pad, t_cap, np.int32)
    w_txn[:n_w] = np.sort(rng.integers(0, t_cap, size=n_w))
    cols = [(rng.random(t_cap) < 0.05).astype(np.int32), r_txn,
            (np.arange(r_pad) < n_r) & (rng.random(r_pad) < 0.95),
            rng.integers(0, 300, size=r_pad), w_txn,
            (np.arange(w_pad) < n_w) & (rng.random(w_pad) < 0.95),
            rng.integers(0, 300, size=w_pad)]
    args = [torch.from_numpy(np.asarray(c, np.int32)).to(dev) for c in cols]
    got, got_rounds = fused.intra_batch_fixpoint(*args, u_pad)
    conf, rounds = fused.intra_batch_fixpoint(*args, u_pad, impl="plain")
    same(got, conf)
    assert int(got_rounds[0]) == int(rounds[0]) >= 2


@pytest.mark.parametrize("d_cap,live_d,flag", [(1 << 10, 300, 0),
                                               (1 << 10, 1000, 0),
                                               (1 << 12, 300, 1)])
def test_resolve_step_program(dev, d_cap, live_d, flag):
    """The whole per-batch program, kernel against plain, on state copies;
    the second case overflows the delta (old delta kept, flag set)."""
    st = make_state(dev, d_cap=d_cap, live_d=live_d, flag=flag)
    packed = packed_batch(5)
    outs = []
    for impl in (None, "plain"):
        s = copy(st)
        step = fused.make_resolve_step_compact(1 << 12, d_cap,
                                               *packed["shapes"], impl=impl)
        buf = torch.from_numpy(packed["buf"]).to(dev)
        outs.append(step(s["bk"], s["bv"], s["table"], s["size"], s["dk"],
                         s["dv"], s["dtable"], s["dsize"], s["flag"], buf))
    same(outs[0], outs[1])
    assert int(outs[0][3][0]) == (1 if flag or live_d == 1000 else 0)


@pytest.mark.parametrize("floor,rebase,live_b", [(0, 0, 2000),
                                                 (3500, 1500, 2000),
                                                 (-(1 << 31) + 2, 100, 2000),
                                                 (0, 0, 4000)])
def test_merge_program(dev, floor, rebase, live_b):
    """The merge, kernel against plain: GC, rebase (at the wrap edge in
    the third case) and base overflow (the fourth)."""
    st = make_state(dev, live_b=live_b)
    st["bv"][0] = NEG_INF + 5
    outs = []
    for impl in (None, "plain"):
        s = copy(st)
        m = fused.make_merge_step(1 << 12, 1 << 10, impl=impl)
        outs.append(m(s["bk"], s["bv"], s["table"], s["size"], s["dk"],
                      s["dv"], s["dsize"], s["flag"], (floor, rebase)))
    same(outs[0], outs[1])
    assert int(outs[0][7][0]) == (live_b == 4000)


def test_backend_stream_kernels_equal_plain_and_oracle(dev):
    """TorchConflictSet on the card, kernels against impl="plain" at state
    level and against the oracle, over a stream that crosses merges, a
    delta growth and a clear()."""
    rng = np.random.default_rng(8)
    kw = dict(capacity=1 << 14, delta_capacity=1 << 10, gc_interval_batches=3,
              device=dev)
    kern, plain = TorchConflictSet(0, **kw), TorchConflictSet(0, impl="plain",
                                                               **kw)
    oracle = OracleConflictSet(0)
    version = 1000
    for i, n in enumerate([400, 400, 600, 400, 0, 400, 400]):
        if n == 0:
            for cs in (kern, plain, oracle):
                cs.clear(version)
            continue
        prev, version = version, version + 1000
        kids = rng.zipf(1.2, size=2 * n) % 5000
        keys = [b"k%014d" % int(k) for k in kids]
        snaps = np.maximum(prev - rng.integers(0, 2000, size=n), 0)
        txns = [CommitTransactionRef(
            read_conflict_ranges=[KeyRange(keys[t], keys[t] + b"\x00")],
            write_conflict_ranges=[KeyRange(keys[n + t], keys[n + t] + b"\0")],
            read_snapshot=int(snaps[t])) for t in range(n)]
        floor = max(version - 5000, 0)
        a = [int(v) for v in kern.resolve(txns, version, floor)]
        b = [int(v) for v in plain.resolve(txns, version, floor)]
        c = [int(v) for v in oracle.resolve(txns, version, floor)]
        assert a == b == c, i
        sa, sb = state_to_numpy(kern), state_to_numpy(plain)
        for k in sa:
            assert np.array_equal(np.asarray(sa[k]), np.asarray(sb[k])), k
    assert kern.profile["merges"] >= 2


# ---------------------------------------------------------------------------
# the general interval path and the window programs
# ---------------------------------------------------------------------------

def range_rows(rng, n: int, span: int = 30, keyspace: int = KEYSPACE):
    """Begin / end rows of n ranges [key(a), key(a + s)) over the
    15-byte keys."""
    a = rng.integers(0, keyspace, size=n)
    s = rng.integers(1, span, size=n)
    return (torch.from_numpy(digest.planar_to_rows(key_digests(a))),
            torch.from_numpy(digest.planar_to_rows(key_digests(a + s))))


@pytest.mark.parametrize("n,with_tie,edge", [(1, False, False),
                                             (5000, True, True),
                                             (100000, False, True),
                                             (1 << 21, False, False)])
def test_sort_rows(dev, n, with_tie, edge):
    from foundationdb_tpu_torch.ops.sort import sort_rows
    rng = np.random.default_rng(n)
    if edge:
        lanes = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                          0xFFFFFFFF], np.uint32)
        planar = lanes[rng.integers(0, lanes.size, size=(8, n))]
        planar[:, rng.integers(0, n, size=n // 10 + 1)] = 0xFFFFFFFF
    else:
        planar = key_digests(rng.integers(0, 1 << 40, size=n))
        planar[:, n // 2:] = 0xFFFFFFFF
    rows = torch.from_numpy(digest.planar_to_rows(planar)).to(dev)
    tie = (torch.randint(-3, 3, (n,), dtype=torch.int32, device=dev)
           if with_tie else None)
    pay = torch.arange(n, dtype=torch.int32, device=dev)
    same(sort_rows(rows, tie=tie, payload=pay),
         sort_rows(rows, tie=tie, payload=pay, impl="plain"))


def test_build_sparse_table_past_2_27(dev):
    """A CAP past 2^27 takes the 16,384-output tile (rangemax.tile_log)
    and residue sequences too long for 16 residues a block.  Each level is
    held against the level below it, the plain version's recurrence one
    level at a time (the plain version itself would hold two copies of
    this 15 GB table)."""
    cap = (1 << 27) + 12_345
    assert rangemax.tile_log(cap) == 14
    v = table_values(dev, cap, 27)
    K.reset_counts()
    table = rangemax.build_sparse_table(v)
    assert K.LAUNCHES["build_sparse_table"] == 2
    assert table.shape[0] == rangemax.table_levels(cap)
    assert torch.equal(table[0], v)
    for j in range(1, table.shape[0]):
        s, prev = 1 << (j - 1), table[j - 1]
        assert torch.equal(table[j][:cap - s],
                           torch.maximum(prev[:cap - s], prev[s:])), j
        assert torch.equal(table[j][cap - s:],
                           torch.clamp(prev[cap - s:], min=NEG_INF)), j
    del table


def sort_case(dev, kind: str, n: int, seed: int = 0):
    """Rows of one input shape: "digests", all 8 lanes random (hashed
    keys); "prefix", the first two lanes (8 bytes) shared by every row
    (keys under one tuple-layer directory); "equal", every row the same;
    "max_mixed", random rows with every third row MAX."""
    rng = np.random.default_rng(seed)
    planar = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64).astype(
        np.uint32)
    if kind == "prefix":
        planar[:2] = np.array([[0x15000000], [0x2A2A0102]], np.uint32)
    elif kind == "equal":
        planar[:] = planar[:, :1]
    elif kind == "max_mixed":
        planar[:, ::3] = 0xFFFFFFFF
    return torch.from_numpy(digest.planar_to_rows(planar)).to(dev)


def check_sort(dev, rows, tie=None, pay=None):
    from foundationdb_tpu_torch.ops.sort import sort_rounds, sort_rows
    K.reset_counts()
    got = sort_rows(rows, tie=tie, payload=pay)
    assert K.LAUNCHES["sort_rows"] == 1 + 2 * sort_rounds(rows.shape[0])
    want = sort_rows(rows, tie=tie, payload=pay, impl="plain")
    same(got[0], want[0])
    if pay is not None:
        same(got[1], want[1])
    return got


@pytest.mark.parametrize("n", [1, SORT_TILE - 1, SORT_TILE, SORT_TILE + 1,
                               2 * SORT_TILE + 1, (1 << 20) + 12_345,
                               1 << 21])
@pytest.mark.parametrize("kind", ["digests", "prefix"])
def test_sort_rows_sizes(dev, n, kind):
    """Tile edges and run pairs without a partner, on hashed keys and on
    keys sharing an 8-byte prefix, with the index as payload."""
    rows = sort_case(dev, kind, n, seed=n)
    check_sort(dev, rows, pay=torch.arange(n, dtype=torch.int32,
                                           device=dev))


@pytest.mark.parametrize("n", [SORT_TILE + 1, 100_000])
def test_sort_rows_stable_on_equal_keys(dev, n):
    """All keys equal: the index payload comes out in input order."""
    pay = torch.arange(n, dtype=torch.int32, device=dev)
    _, got = check_sort(dev, sort_case(dev, "equal", n), pay=pay)
    same(got, pay)


@pytest.mark.parametrize("with_tie", [False, True])
def test_sort_rows_max_rows_interleaved(dev, with_tie):
    n = 50_001
    rows = sort_case(dev, "max_mixed", n, seed=3)
    tie = (torch.randint(-2, 2, (n,), dtype=torch.int32, device=dev)
           if with_tie else None)
    check_sort(dev, rows, tie=tie,
               pay=torch.arange(n, dtype=torch.int32, device=dev))


def test_sort_rows_union_ranges_shape(dev):
    """The endpoint sort of _union_ranges: 2w rows, begins (tie 0, +1)
    then ends (tie 1, -1), invalid rows MAX with delta 0; overlapping and
    touching ranges put begins and ends on one key."""
    from foundationdb_tpu_torch.conflict import window
    w = 40_000
    rng = np.random.default_rng(5)
    wb, we = range_rows(rng, w, span=4, keyspace=3000)
    valid = torch.from_numpy((rng.random(w) < 0.9).astype(np.int32))
    v = valid.bool()[:, None]
    rows = torch.cat([torch.where(v, wb, -1), torch.where(v, we, -1)])
    tie = torch.cat([torch.zeros(w, dtype=torch.int32),
                     torch.ones(w, dtype=torch.int32)])
    delta = torch.cat([valid, -valid])
    check_sort(dev, rows.to(dev), tie=tie.to(dev), pay=delta.to(dev))
    check_union(dev, wb.to(dev), we.to(dev), valid.to(dev))


def check_union(dev, wb, we, valid):
    """_union_ranges, kernel against plain, and its launches a call:
    wu_endpoints and wu_sweep under union_ranges, the sort's own, and no
    scan or compaction."""
    from foundationdb_tpu_torch.conflict import window
    from foundationdb_tpu_torch.ops.sort import sort_rounds
    K.reset_counts()
    got = window._union_ranges(wb, we, valid)
    counts = dict(K.LAUNCHES)
    same(got, window._union_ranges(wb, we, valid, impl="plain"))
    n2 = 2 * wb.shape[0]
    assert counts["union_ranges"] == 2
    assert counts["sort_rows"] == (1 + 2 * sort_rounds(n2) if n2 else 0)
    assert counts["inclusive_scan"] == counts["compact_rows"] == 0
    assert sum(counts.values()) == counts["union_ranges"] + counts["sort_rows"]
    return got


@pytest.mark.parametrize("name", UNION_CASES)
def test_union_ranges_cases(dev, name):
    """tests/test_torch_union.py's cases (one range, none valid, only
    empty ranges, begin > end, one range over every other, a touching
    chain, coverage back to 0 at fixed strides), kernel against plain."""
    b, e, valid = union_case(name)
    rows = lambda p: torch.from_numpy(digest.planar_to_rows(p)).to(dev)
    check_union(dev, rows(b), rows(e),
                torch.from_numpy(valid.astype(np.int32)).to(dev))


UNION_TILE = 1024  # conflict/window.py UNION_TILE: endpoints a sweep tile


@pytest.mark.parametrize("kind", ["overlapping", "disjoint", "begin_gt_end"])
@pytest.mark.parametrize("w", [UNION_TILE // 2 - 1, UNION_TILE // 2,
                               UNION_TILE // 2 + 1, UNION_TILE - 1,
                               UNION_TILE + 1, (3 * UNION_TILE + 6) // 2,
                               1 << 20])
def test_union_ranges_tile_edges(dev, w, kind):
    """2w endpoints around the sweep's tile edges (2w is even: a tile -
    2, a tile, a tile + 2, two tiles +- 2, three tiles + 6) and at 2^21:
    heavily overlapping ranges (coverage carried across many tiles),
    disjoint ones (coverage back to 0 after every pair, so at every tile
    edge) and ranges with begin > end (coverage below 0), 10% invalid."""
    from foundationdb_tpu_torch.conflict import window
    assert window.UNION_TILE == UNION_TILE
    rng = np.random.default_rng(w)
    if kind == "disjoint":
        a, s = 10 * rng.permutation(w), np.full(w, 5)
    else:
        a = rng.integers(0, 4 * w, size=w)
        s = rng.integers(1, 60, size=w)
        if kind == "begin_gt_end":
            s[::3] = -s[::3]
    rows = lambda ids: torch.from_numpy(
        digest.planar_to_rows(key_digests(ids))).to(dev)
    valid = torch.from_numpy((rng.random(w) < 0.9).astype(np.int32)).to(dev)
    mb, _, m_incl = check_union(dev, rows(a), rows(a + s), valid)
    if kind == "disjoint":
        assert int(m_incl[-1]) == int(valid.sum())


@pytest.mark.parametrize("layout", ["aligned", "unaligned"])
@pytest.mark.parametrize("malformed", [False, True])
@pytest.mark.parametrize("pads", [(203, 101), (1024, 1023), (4099, 5),
                                  (1, 4096)])
def test_read_write_prep_edges(dev, pads, malformed, layout):
    """read_write_prep, kernel against plain, one launch a call: txn -1
    reads, too-old and padding txns (tests/test_torch_union.py rw_case),
    pads not a multiple of 4 (the scalar tail), arbitrary rank counts
    (out of range, not monotone, int32's extremes), and inputs at a 4-byte
    offset from a 16-byte boundary (no quad loads)."""
    r_pad, w_pad = pads
    c = rw_case(r_pad + w_pad, t_cap=max(8, r_pad // 3), r_pad=r_pad,
                w_pad=w_pad, u_pad=97, malformed=malformed)
    offset = 1 if layout == "unaligned" else 0
    K.reset_counts()
    got = rw_port(c, dev, offset=offset)
    assert K.LAUNCHES["read_write_prep"] == 1
    same(got, rw_port(c, dev, impl="plain"))


def check_prep(dev, c, offset=0, n_hist=2):
    """compact_prep kernel against plain on one case: one launch a call
    (ib_unpack) and no other kernel; its hists zeroed."""
    K.reset_counts()
    got = prep_port(c, dev, n_hist=n_hist, offset=offset)
    assert K.LAUNCHES["compact_prep"] == 1
    assert sum(K.LAUNCHES.values()) == 1
    assert K.LAUNCHES["inclusive_scan"] == 0
    want = prep_port(c, dev, impl="plain", n_hist=n_hist)
    same(got, want)
    assert len(got["hists"]) == n_hist
    assert not any(bool(h.any()) for h in got["hists"])
    return got


@pytest.mark.parametrize("layout", ["aligned", "unaligned"])
@pytest.mark.parametrize("name", PREP_CASES)
def test_compact_prep_cases(dev, name, layout):
    """tests/test_torch_prep.py's cases (unsorted, negative and
    past-the-pad starts, duplicates, n_t 0 and t_cap, u_n 0 and u_pad, lw
    7 and 32), kernel against plain, with every input 16-byte aligned or
    one element off (byte loads of the keys, no quad loads of the txns)."""
    check_prep(dev, prep_case(name), offset=1 if layout == "unaligned"
               else 0)


RT = 2048  # ib_unpack's scan tile (csrc/intra_batch.cu RANK_TILE)


@pytest.mark.parametrize("shape", [
    (RT - 1, RT + 1, 257, 700), (RT, RT, 256, 2 * RT), (RT + 1, RT - 1, 1000,
                                                        3 * RT + 5),
    (3 * RT + 5, 1, 1, RT), (0, 0, 0, 5), (1, 0, 3, 0),
    (212_992, 114_688, 49_152, 131_072)])
@pytest.mark.parametrize("name", ["sorted", "unsorted"])
def test_compact_prep_tile_edges(dev, shape, name):
    """r_pad and w_pad a tile of ib_unpack's scan and one either side, 3 tiles
    + 5, empty pads; u_pad not a multiple of the block; config 2's shape
    (t_cap 131,072, r_pad 212,992, w_pad 114,688, u_pad 49,152)."""
    r_pad, w_pad, u_pad, t_cap = shape
    assert fused.unpack_layout(t_cap, r_pad, w_pad, 2)[3] == RT
    check_prep(dev, prep_case(name, seed=r_pad + w_pad, t_cap=t_cap,
                              r_pad=r_pad, w_pad=w_pad, u_pad=u_pad))


def test_plain_only_unpack_blocks_raise_on_the_card(dev):
    """widen_unique and txn_prep have no kernel of their own: on a CUDA
    tensor without impl="plain" they raise."""
    c = {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v
         for k, v in prep_case("sorted").items()}
    t_cap, r_pad, w_pad, u_pad, lw = c["shape"]
    with pytest.raises(RuntimeError):
        digest.widen_unique(c["ub"], c["scal"], lw, u_pad)
    with pytest.raises(RuntimeError):
        fused.txn_prep(c["r_start"], c["w_start"], c["t_snap"], c["t_flags"],
                       c["scal"], r_pad, w_pad)
    digest.widen_unique(c["ub"], c["scal"], lw, u_pad, impl="plain")
    fused.txn_prep(c["r_start"], c["w_start"], c["t_snap"], c["t_flags"],
                   c["scal"], r_pad, w_pad, impl="plain")


def window_after_inserts(dev, cap=1 << 12, batches=4, w=256, impl=None):
    """A window on the card after a few batches of range inserts."""
    from foundationdb_tpu_torch.conflict import window
    rng = np.random.default_rng(11)
    st = window.make_window_state(cap, 0, dev)
    for b in range(batches):
        wb, we = range_rows(rng, w)
        valid = torch.from_numpy((rng.random(w) < 0.9).astype(np.int32))
        window.window_insert(st, wb.to(dev), we.to(dev), valid.to(dev),
                             1000 * (b + 1), impl=impl)
    return st


def test_window_programs(dev):
    """window_insert (a chain, then one that overflows), window_query and
    window_gc (at the rebase's wrap edge), kernel against plain."""
    from foundationdb_tpu_torch.conflict import window
    kern = window_after_inserts(dev)
    plain = window_after_inserts(dev, impl="plain")
    same(tuple(kern), tuple(plain))
    rng = np.random.default_rng(12)
    qb, qe = range_rows(rng, 5000, span=60)
    snap = torch.from_numpy(rng.integers(0, 5000, size=5000,
                                         dtype=np.int32)).to(dev)
    valid = torch.ones(5000, dtype=torch.int32, device=dev)
    got = window.window_query(kern.bk, kern.bv, qb.to(dev), qe.to(dev), snap,
                              valid)
    same(got, window.window_query(kern.bk, kern.bv, qb.to(dev), qe.to(dev),
                                  snap, valid, impl="plain"))
    assert 0 < int(got.sum()) < 5000
    small = [window_after_inserts(dev, cap=256, batches=1, impl=i)
             for i in (None, "plain")]
    wb, we = range_rows(rng, 256)
    ones = torch.ones(256, dtype=torch.int32, device=dev)
    outs = [window.window_insert(s, wb.to(dev), we.to(dev), ones, 9000,
                                 impl=i) for s, i in zip(small,
                                                         (None, "plain"))]
    same(outs[0], outs[1])
    assert int(outs[0][1][0]) == 1                   # overflowed
    kern.bv[0] = NEG_INF + 5
    plain.bv[0] = NEG_INF + 5
    for floor, rebase in ((2500, 1500), (-(1 << 31) + 2, 100)):
        same(tuple(window.window_gc(kern, floor, rebase)),
             tuple(window.window_gc(plain, floor, rebase, impl="plain")))


def check_gc(dev, c):
    """window_gc kernel against plain on a copy of case c: in place (the
    state returned, its tensors' storage unchanged), one launch a call and
    no other wrapper's."""
    from foundationdb_tpu_torch.conflict import window
    st = window.WindowState(*(torch.from_numpy(c[k].copy()).to(dev)
                              for k in ("bk", "bv", "size")))
    ptrs = [t.data_ptr() for t in st]
    K.reset_counts()
    got = window.window_gc(st, c["oldest"], c["rebase"])
    assert got is st and [t.data_ptr() for t in got] == ptrs
    assert K.LAUNCHES["window_gc"] == 1 and sum(K.LAUNCHES.values()) == 1
    same(tuple(got), tuple(gc_port(c, dev, impl="plain")))
    return got


@pytest.mark.parametrize("name", GC_CASES)
def test_window_gc_cases(dev, name):
    """tests/test_torch_gc.py's edges (size 0, 1 and cap, nothing dropped
    with a live NEG_INF version, all but row 0 dropped, runs of drops,
    the rebase's wrap), kernel against plain."""
    check_gc(dev, gc_case(name))


# Rows the kernel's grid holds in registers at once on the H100 (132 SMs
# x 2 blocks x GC_TILE): chunk boundaries near its multiples.
GC_CHUNK = 132 * 2 * 2048


@pytest.mark.parametrize("size", [(1 << 21) - 12_345, 1 << 21])
@pytest.mark.parametrize("where", ["spread", "ends_and_chunks", "late",
                                   "none"])
def test_window_gc_chunks(dev, size, where):
    """A 2^21 window, several chunks of the grid: drops spread all over;
    only in the first and last rows and around the chunk boundaries; only
    in the last rows (every earlier row keeps its place and only its
    version is rebased, across chunks); none (the rebase alone)."""
    cap = 1 << 21
    rng = np.random.default_rng(size % 97 + len(where))
    if where == "spread":
        below = runs_mask(rng, size)
    else:
        below = np.zeros(size, bool)
        spans = {"ends_and_chunks": [(3, 40), (size - 60, size - 2)] + [
                     (k * GC_CHUNK - 9, k * GC_CHUNK + 9)
                     for k in range(1, size // GC_CHUNK + 1)],
                 "late": [(size - 3000, size - 1)], "none": []}[where]
        for a, b in spans:
            below[a:b] = True
    got = check_gc(dev, gc_state(cap, size, below, 5000, 1234, seed=size))
    n = int(got.size[0])
    assert (n == size) == (where == "none")


def test_sharded_window_gc_near_empty_shards(dev):
    """ShardedWindow at kr=4 on one card whose writes all land on shard 0:
    its gc runs one launch a shard, three of them on a shard of one row,
    and equals the plain version's state."""
    from foundationdb_tpu_torch.parallel import (ShardedWindow,
                                                 make_conflict_mesh)
    mesh = make_conflict_mesh([dev] * 4)
    wins = [ShardedWindow(mesh, capacity=1 << 14, impl=i)
            for i in (None, "plain")]
    rng = np.random.default_rng(43)
    for i in range(6):
        d = rng.integers(0, 1 << 32, size=(8, 1024), dtype=np.uint64).astype(
            np.uint32)
        d[0] = 5
        e = d.copy()
        e[7] += 1
        wb, we = (torch.from_numpy(digest.planar_to_rows(x)).to(dev)
                  for x in (d, e))
        ones = torch.ones(1024, dtype=torch.int32, device=dev)
        for w in wins:
            w.resolve_step(wb, we, ones, ones, wb, we, ones, 1000 * (i + 1))
    sizes = wins[0].shard_sizes()
    assert sizes[0] > 1000 and sizes[1:] == [1, 1, 1], sizes
    K.reset_counts()
    wins[0].gc(3500, 1000)
    assert K.LAUNCHES["window_gc"] == 4
    assert sum(K.LAUNCHES.values()) == 4
    wins[1].gc(3500, 1000)
    for a, b in zip(wins[0].state_to_numpy(), wins[1].state_to_numpy()):
        assert np.array_equal(a, b)
    assert wins[0].shard_sizes()[0] < sizes[0]


def general_batch(rng, n_txns: int, now: int, oldest: int):
    """A range batch (2 range reads, 1 range write per txn) packed and
    stamped, and its shapes."""
    nr = 2 * n_txns
    rb, re_ = range_rows(rng, nr)
    wb, we = range_rows(rng, n_txns, span=5)
    enc = EncodedBatch(
        n_txns=n_txns,
        t_snap=rng.integers(oldest - 500, now, size=n_txns).astype(np.int64),
        t_has_reads=np.ones(n_txns, bool),
        r_txn=np.arange(nr, dtype=np.int32) // 2,
        r_begin=digest.rows_to_planar(rb), r_end=digest.rows_to_planar(re_),
        w_txn=np.arange(n_txns, dtype=np.int32),
        w_begin=digest.rows_to_planar(wb), w_end=digest.rows_to_planar(we))
    packed = TorchConflictSet._pack(enc)
    meta = packed["meta"]
    meta[packed["snap_off"]:packed["snap_off"] + n_txns] = enc.t_snap
    meta[packed["scalar_off"]:packed["scalar_off"] + 2] = (now, oldest)
    return packed


@pytest.mark.parametrize("d_cap,live_d,flag", [(1 << 10, 300, 0),
                                               (1 << 10, 1000, 0),
                                               (1 << 12, 300, 1)])
def test_general_step_program(dev, d_cap, live_d, flag):
    """The whole general step, kernel against plain, on state copies; the
    second case overflows the delta.  The fixpoint's rounds agree too."""
    st = make_state(dev, d_cap=d_cap, live_d=live_d, flag=flag)
    packed = general_batch(np.random.default_rng(13), 3000, 7000, 2500)
    t_cap, r_cap, w_cap = packed["caps"]
    n_rows = 2 * (r_cap + w_cap)
    buf = torch.from_numpy(packed["buf"]).to(dev)
    digests = buf[:32 * n_rows].view(torch.int32).view(n_rows, 8)
    meta = buf[32 * n_rows:].view(torch.int32)
    outs, rounds = [], []
    for impl in (None, "plain"):
        s = copy(st)
        acc = torch.zeros(1, dtype=torch.int32, device=dev)
        step = fused.make_resolve_step(1 << 12, d_cap, t_cap, r_cap, w_cap,
                                       impl=impl)
        outs.append(step(s["bk"], s["bv"], s["table"], s["size"], s["dk"],
                         s["dv"], s["dtable"], s["dsize"], s["flag"],
                         digests, meta, rounds_acc=acc))
        rounds.append(int(acc[0]))
    same(outs[0], outs[1])
    assert rounds[0] == rounds[1] >= 2
    assert int(outs[0][3][0]) == (1 if flag or live_d == 1000 else 0)
    codes = outs[0][4][:3000].tolist()
    assert {0, 1, 2} <= set(codes)


def test_backend_range_stream_kernels_equal_plain_and_oracle(dev):
    """TorchConflictSet on the card with range reads and writes (and keys
    over 31 bytes, with ids in their first bytes so the oracle agrees),
    kernels against impl="plain" at state level and against the oracle,
    crossing a merge on each side of a clear()."""
    rng = np.random.default_rng(14)
    kw = dict(capacity=1 << 14, delta_capacity=1 << 11,
              gc_interval_batches=3, device=dev)
    kern, plain = TorchConflictSet(0, **kw), TorchConflictSet(0, impl="plain",
                                                               **kw)
    oracle = OracleConflictSet(0)
    version = 1000

    def k(i, long):
        return (b"%08d" % i + b"z" * 40) if long else b"k%014d" % i

    for i, n in enumerate([300, 300, 500, 300, 300, 0, 300, 300, 300, 300]):
        if n == 0:
            for cs in (kern, plain, oracle):
                cs.clear(version)
            continue
        prev, version = version, version + 1000
        long = i % 2 == 1
        txns = []
        for t in range(n):
            a, b = (int(x) for x in rng.integers(0, 3000, size=2))
            s = int(rng.integers(1, 20))
            txns.append(CommitTransactionRef(
                read_conflict_ranges=[KeyRange(k(2 * a, long),
                                               k(2 * (a + s) + 1, long))],
                write_conflict_ranges=[KeyRange(k(2 * b, long),
                                                k(2 * b, long) + b"\x00")],
                read_snapshot=int(max(prev - rng.integers(0, 2000), 0))))
        floor = max(version - 5000, 0)
        a = [int(v) for v in kern.resolve(txns, version, floor)]
        b = [int(v) for v in plain.resolve(txns, version, floor)]
        c = [int(v) for v in oracle.resolve(txns, version, floor)]
        assert a == b == c, i
        sa, sb = state_to_numpy(kern), state_to_numpy(plain)
        for key_ in sa:
            assert np.array_equal(np.asarray(sa[key_]),
                                  np.asarray(sb[key_])), key_
    assert kern.profile["merges"] >= 2
    assert kern.profile["general_batches"] == 9
    assert int(kern.jacobi_rounds[0]) == int(plain.jacobi_rounds[0]) >= 9


# ---------------------------------------------------------------------------
# key-range sharding: the shard kernels and the sharded programs
# ---------------------------------------------------------------------------

def quarter_bounds(dev, d: int):
    """Shard d of 4's [lo, hi) rows under even lane-0 splits."""
    from foundationdb_tpu_torch.parallel.sharded_window import (digest_splits,
                                                                split_rows)
    rows = split_rows(digest_splits(4)).to(dev)
    return rows[d], rows[d + 1]


@pytest.mark.parametrize("edge", [False, True])
def test_shard_kernels(dev, edge):
    """clip_rows (with and without `valid`), shard_combine (max and
    wrapping sum) and shard_commit (overflow set and clear), kernel against
    plain."""
    from foundationdb_tpu_torch.ops import shard
    rng = np.random.default_rng(21)
    b, _ = sorted_rows(rng, 3000, 4096, edge=edge)
    e, _ = sorted_rows(rng, 3000, 4096, edge=edge)
    b, e = b.to(dev), e.to(dev)
    valid = torch.from_numpy((rng.random(4096) < 0.7).astype(np.int32)).to(
        dev)
    for d in range(4):
        lo, hi = quarter_bounds(dev, d)
        for v in (None, valid):
            same(shard.clip_rows(b, e, lo, hi, valid=v),
                 shard.clip_rows(b, e, lo, hi, valid=v, impl="plain"))
    parts = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31,
                                          size=(4, 65536 + 3),
                                          dtype=np.int64).astype(np.int32))
    parts[:, 0] = 0x7FFFFFFF
    parts = parts.to(dev)
    for n_max in (None, 2, 65536):
        same(shard.shard_combine(parts, n_max),
             shard.shard_combine(parts, n_max, impl="plain"))
    st = make_state(dev)
    for ovf in (0, 1):
        flag = torch.tensor([ovf], dtype=torch.int32, device=dev)
        saved = (st["bk"], st["bv"], st["size"])
        outs = []
        for impl in (None, "plain"):
            s = copy(make_state(dev, seed=2))
            shard.shard_commit(flag, saved, (s["bk"], s["bv"], s["size"]),
                               impl=impl)
            outs.append((s["bk"], s["bv"], s["size"]))
        same(outs[0], outs[1])
        same(outs[0], saved if ovf else tuple(
            make_state(dev, seed=2)[k] for k in ("bk", "bv", "size")))


def test_masked_point_insert_and_first_row_merge(dev):
    """The point insert with a shard's u_own mask (pi_mark) and the merge
    whose reset delta starts at a shard's lower split (mg_reset), kernel
    against plain."""
    st = make_state(dev)
    x = step_inputs(dev, packed_batch(6))
    t_cap, r_pad, w_pad, u_pad, lw = x["shapes"]
    u_b, u_e = digest.widen_unique(x["ub"], x["scal"], lw, u_pad, "plain")
    rng = np.random.default_rng(3)
    u_own = torch.from_numpy((rng.random(u_pad) < 0.5).astype(np.int32)).to(
        dev)
    w_ins = torch.from_numpy((rng.random(w_pad) < 0.6).astype(np.int32)).to(
        dev)
    outs = []
    for impl in (None, "plain"):
        s = copy(st)
        tail = torch.zeros((3,), dtype=torch.int32, device=dev)
        fused._point_insert(s["dk"], s["dv"], s["dsize"], u_b, u_e,
                            x["w_uid"], w_ins, x["scal"][4:5], s["flag"],
                            bsize=s["size"], tail=tail, impl=impl,
                            u_own=u_own)
        outs.append((s["dk"], s["dv"], s["dsize"], s["flag"], tail))
    same(outs[0], outs[1])
    lo, _ = quarter_bounds(dev, 2)
    outs = []
    for impl in (None, "plain"):
        s = copy(st)
        m = fused.make_merge_step(1 << 12, 1 << 10, impl=impl)
        outs.append(m(s["bk"], s["bv"], s["table"], s["size"], s["dk"],
                      s["dv"], s["dsize"], s["flag"], (100, 0), lo))
    same(outs[0], outs[1])
    assert torch.equal(outs[0][4][0], lo)


def test_sharded_backend_kernels_equal_plain_and_oracle(dev):
    """ShardedTorchConflictSet with four shards on one card: kernels
    against impl="plain" at state level and the verdicts against the
    one-device backend and the oracle, over point and range batches,
    merges and a delta growth."""
    from foundationdb_tpu_torch.parallel import (ShardedTorchConflictSet,
                                                 make_conflict_mesh,
                                                 sharded_state_to_numpy,
                                                 splits_from_sample)
    rng = np.random.default_rng(31)
    mesh = make_conflict_mesh([dev] * 4)
    splits = splits_from_sample(key_digests(np.arange(0, 3000, 7)), 4)
    kw = dict(capacity=1 << 12, delta_capacity=1 << 9, gc_interval_batches=3,
              splits=splits)
    kern = ShardedTorchConflictSet(mesh, 0, **kw)
    plain = ShardedTorchConflictSet(mesh, 0, impl="plain", **kw)
    single = TorchConflictSet(0, capacity=1 << 14, device=dev)
    oracle = OracleConflictSet(0)
    version = 1000
    for i, n in enumerate([200, 150, 300, 200, 200]):
        prev, version = version, version + 1000
        keys = [b"k%014d" % int(k) for k in rng.integers(0, 3000, size=2 * n)]
        snaps = np.maximum(prev - rng.integers(0, 2000, size=n), 0)
        span = 1 + (i % 2) * 40
        txns = [CommitTransactionRef(
            read_conflict_ranges=[KeyRange(keys[t], keys[t] + (
                b"\x00" if span == 1 else b"\xff"))],
            write_conflict_ranges=[KeyRange(keys[n + t],
                                            keys[n + t] + b"\x00")],
            read_snapshot=int(snaps[t])) for t in range(n)]
        floor = max(version - 5000, 0)
        verdicts = [[int(v) for v in cs.resolve(txns, version, floor)]
                    for cs in (kern, plain, single, oracle)]
        assert all(v == verdicts[0] for v in verdicts), i
        sa, sb = sharded_state_to_numpy(kern), sharded_state_to_numpy(plain)
        for k in sa:
            assert np.array_equal(np.asarray(sa[k]), np.asarray(sb[k])), k
    assert kern.profile["merges"] >= 1
    assert kern.profile["general_batches"] >= 1
    assert min(kern.shard_sizes()) > 1


def test_sharded_window_kernels_equal_plain(dev):
    """ShardedWindow at kr=4 on one card: bits, overflow and state of the
    kernels against impl="plain", through an overflow of one shard (all
    shards keep their state) and a gc."""
    from foundationdb_tpu_torch.parallel import (ShardedWindow,
                                                 make_conflict_mesh)
    rng = np.random.default_rng(41)
    mesh = make_conflict_mesh([dev] * 4)
    wins = [ShardedWindow(mesh, capacity=1 << 9, impl=i)
            for i in (None, "plain")]

    def rand_rows(n, lead=None):
        d = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64).astype(
            np.uint32)
        if lead is not None:
            d[0] = lead
        e = d.copy()
        e[7] += 1
        return (torch.from_numpy(digest.planar_to_rows(d)).to(dev),
                torch.from_numpy(digest.planar_to_rows(e)).to(dev))

    ovfs = []
    for i in range(8):
        qb, qe = rand_rows(512)
        snap = torch.from_numpy(rng.integers(0, 1000 * (i + 1), size=512,
                                             dtype=np.int32)).to(dev)
        ones = torch.ones(512, dtype=torch.int32, device=dev)
        wb, we = rand_rows(128, lead=5 if i >= 4 else None)
        outs = [w.resolve_step(qb, qe, snap, ones, wb, we, ones[:128],
                               1000 * (i + 1)) for w in wins]
        same(outs[0], outs[1])
        for a, b in zip(wins[0].state_to_numpy(), wins[1].state_to_numpy()):
            assert np.array_equal(a, b)
        ovfs.append(int(outs[0][1][0]))
    assert 1 in ovfs
    for w in wins:
        w.gc(4000, 1000)
    for a, b in zip(wins[0].state_to_numpy(), wins[1].state_to_numpy()):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# interval_fixpoint (csrc/segtree.cu): tiles, runs and the tile table
# ---------------------------------------------------------------------------

RUN = 1 << fused.FIX_BLOCK_LOG          # gaps a run minimum covers
TILE = 1 << fused.FIX_TILE_LOG          # gaps a pushdown tile owns


def span_columns(rng, n: int, u: int):
    """n spans [pb, pe) over U gaps: lengths 0, 1, RUN, RUN + 1, TILE,
    TILE + 1, 2 * TILE + 1, random and all of U, at random, run- and
    tile-aligned starts; a few reversed (empty)."""
    lengths = np.array([0, 1, 2, RUN - 1, RUN, RUN + 1, 2 * RUN + 1, TILE,
                        TILE + 1, 2 * TILE + 1, u // 3, u])
    ln = np.minimum(lengths[rng.integers(0, lengths.size, n)], u)
    ln = np.minimum(np.where(rng.random(n) < 0.3, rng.integers(0, 8, n), ln),
                    u)
    start = rng.integers(0, u + 1, n)
    aligned = rng.random(n)
    start = np.where(aligned < 0.2, start // RUN * RUN, start)
    start = np.where((aligned >= 0.2) & (aligned < 0.3), start // TILE * TILE,
                     start)
    start = np.minimum(start, u - ln)
    pb, pe = start, start + ln
    rev = rng.random(n) < 0.05
    return (np.where(rev, pe, pb).astype(np.int32),
            np.where(rev, pb, pe).astype(np.int32))


def fixpoint_inputs(dev, log_u: int, t_cap: int, n_r: int, n_w: int,
                    seed: int):
    """interval_fixpoint's columns for a random batch over U = 2^log_u
    gaps: reads and writes sorted by txn, ~5% history conflicts, ~10% dead
    reads and writes, writes at both edges of the universe, padding past
    the live columns."""
    rng = np.random.default_rng(seed)
    u = 1 << log_u
    r_cap, w_cap = n_r + 64, n_w + 64
    r_txn = np.full(r_cap, t_cap, np.int32)
    r_txn[:n_r] = np.sort(rng.integers(0, t_cap, n_r))
    w_txn = np.full(w_cap, t_cap, np.int32)
    w_txn[:n_w] = np.sort(rng.integers(0, t_cap, n_w))
    r_pb, r_pe = span_columns(rng, r_cap, u)
    w_pb, w_pe = span_columns(rng, w_cap, u)
    w_pb[:4], w_pe[:4] = [0, 0, u - 1, u - RUN], [1, RUN + 1, u, u]
    cols = [(rng.random(t_cap) < 0.05).astype(np.int32), r_txn,
            ((np.arange(r_cap) < n_r) & (rng.random(r_cap) < 0.9)),
            r_pb, r_pe, w_txn,
            ((np.arange(w_cap) < n_w) & (rng.random(w_cap) < 0.9)),
            w_pb, w_pe]
    return [torch.from_numpy(np.asarray(c, np.int32)).to(dev) for c in cols]


def check_fixpoint(args, log_u: int, depth=None):
    K.reset_counts()
    acc = torch.zeros(1, dtype=torch.int32, device=args[0].device)
    got, got_rounds = fused.interval_fixpoint(*args, log_u, rounds_acc=acc)
    assert K.LAUNCHES["interval_fixpoint"] == 1
    assert sum(K.LAUNCHES.values()) == 1
    want, rounds = fused.interval_fixpoint(*args, log_u, impl="plain")
    same(got, want)
    assert int(got_rounds[0]) == int(rounds[0]) == int(acc[0])
    if depth is not None:
        assert int(rounds[0]) == depth
    return int(rounds[0])


@pytest.mark.parametrize("log_u", list(range(12, 22)))
def test_interval_fixpoint_universe_sizes(dev, log_u):
    """U from 2^12 (one tile) to 2^21 (config 3's universe, 512 tiles):
    reads spanning 0, 1, a run, a run + 1, tiles and all gaps, writes at
    the universe's edges and empty spans; conflicts and rounds equal the
    plain version's, one launch."""
    t_cap = 1 << 12
    n = min(1 << (log_u - 2), 1 << 17)
    args = fixpoint_inputs(dev, log_u, t_cap, n, n // 4, seed=log_u)
    assert check_fixpoint(args, log_u) >= 2


@pytest.mark.parametrize("log_u", [1, 3, 5, 7, 23])
def test_interval_fixpoint_small_and_huge_universe(dev, log_u):
    """Universes below a run and a tile, and 2^23, whose 2,048 tiles
    exceed the shared tile table (the reads loop over the tile minima)."""
    t_cap = 256
    n = max(min(1 << log_u, 1 << 16), 8)
    args = fixpoint_inputs(dev, log_u, t_cap, n, max(n // 4, 4), seed=7)
    check_fixpoint(args, log_u)


@pytest.mark.parametrize("depth,log_u", [(60, 12), (200, 21), (1, 16)])
def test_interval_fixpoint_deep_chain(dev, depth, log_u):
    """txn i reads one gap of the span txn i - 1 writes: the Jacobi rounds
    equal the depth (each three grid barriers), conflicts alternate."""
    u = 1 << log_u
    t = np.arange(depth, dtype=np.int32)
    stride = u // (depth + 2)
    ones = np.ones(depth, np.int32)
    cols = [np.zeros(depth, np.int32), t, ones, t * stride + 1,
            t * stride + 2, t, ones, t * stride, (t + 1) * stride + 2]
    args = [torch.from_numpy(np.asarray(c, np.int32)).to(dev) for c in cols]
    check_fixpoint(args, log_u, depth=depth)
    got, _ = fused.interval_fixpoint(*args, log_u)
    assert got.cpu().tolist() == [i % 2 for i in range(depth)]


def check_general_codes(dev, cols: dict, log_u: int, offset: int = 0):
    """interval_fixpoint with the codes, kernel against plain: conf,
    rounds, codes and the insert mask; one launch a call and no other
    wrapper's.  cols: gcodes_case's layout (numpy); with `offset`,
    t_valid, w_txn and w_valid are views that many int32s into their
    buffers (the metadata block's sections at any offset)."""
    K.reset_counts()
    got = gcodes_port(cols, dev, offset=offset)
    assert K.LAUNCHES["interval_fixpoint"] == 1
    assert sum(K.LAUNCHES.values()) == 1
    same(got, gcodes_port(cols, dev, impl="plain"))
    return got


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("name", GCODES_CASES)
def test_interval_fixpoint_codes_cases(dev, name, offset):
    """tests/test_torch_gc.py's cases (txn -1 writes, too-old writers, no
    txn valid, every txn valid, t_cap 37, a chain), aligned and one int32
    off, kernel against plain."""
    check_general_codes(dev, gcodes_case(name), 9, offset)


def codes_columns(dev, log_u: int, t_cap: int, n_r: int, n_w: int,
                  seed: int, cols=None) -> dict:
    """fixpoint_inputs' columns (or `cols`) with the codes' inputs: the
    first t_cap - 7 txns valid, ~10% too old, ~95% of the writes valid."""
    rng = np.random.default_rng(seed)
    if cols is None:
        cols = fixpoint_inputs(dev, log_u, t_cap, n_r, n_w, seed)
    out = {k: c.cpu().numpy() for k, c in zip(
        ("hist", "r_txn", "r_live", "r_pb", "r_pe", "w_txn", "w_ok", "w_pb",
         "w_pe"), cols)}
    w_cap = out["w_txn"].shape[0]
    out["t_valid"] = (np.arange(t_cap) < t_cap - 7).astype(np.int32)
    out["too_old"] = ((rng.random(t_cap) < 0.1)
                      & (out["t_valid"] != 0)).astype(np.int32)
    out["w_valid"] = (rng.random(w_cap) < 0.95).astype(np.int32)
    out["shape"] = (t_cap, out["r_txn"].shape[0], w_cap, log_u)
    return out


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("shape", ["config3", "t_cap_5003"])
def test_interval_fixpoint_codes_shapes(dev, shape, offset):
    """The fixpoint with its codes at config 3's shape (U = 2^21, 65,536
    txns, 400,000 reads, 55,000 writes) and at t_cap 5,003 (not a multiple
    of 4), the metadata views aligned and three int32s off."""
    log_u, t_cap, n_r, n_w = {"config3": (21, 1 << 16, 400_000, 55_000),
                              "t_cap_5003": (16, 5_003, 20_000, 4_001)}[shape]
    got = check_general_codes(
        dev, codes_columns(dev, log_u, t_cap, n_r, n_w, seed=t_cap), log_u,
        offset)
    assert {-1, 0, 1, 2} <= set(got["codes"].unique().tolist())


def test_interval_fixpoint_codes_deep_chain(dev):
    """The 300-deep chain with the codes: rounds equal the depth, conf
    alternates, codes and the insert mask equal the plain version's."""
    depth, log_u = 300, 16
    u = 1 << log_u
    t = np.arange(depth, dtype=np.int32)
    stride = u // (depth + 2)
    ones = np.ones(depth, np.int32)
    cols = [np.zeros(depth, np.int32), t, ones, t * stride + 1,
            t * stride + 2, t, ones, t * stride, (t + 1) * stride + 2]
    cols = [torch.from_numpy(np.asarray(c, np.int32)).to(dev) for c in cols]
    c = codes_columns(dev, log_u, depth, 0, 0, seed=1, cols=cols)
    c["too_old"][:] = 0
    got = check_general_codes(dev, c, log_u, offset=1)
    assert int(got["rounds"][0]) == depth
    assert got["conf"].cpu().tolist() == [i % 2 for i in range(depth)]


def test_general_codes_plain_only_raises_on_the_card(dev):
    """general_codes has no kernel of its own (the fixpoint's launch
    writes the codes): on a CUDA tensor without impl="plain" it raises."""
    c = {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v
         for k, v in gcodes_case("mixed").items()}
    codes = torch.empty((c["shape"][0],), dtype=torch.int8, device=dev)
    with pytest.raises(RuntimeError):
        fused.general_codes(c["t_valid"], c["too_old"], c["hist"],
                            c["w_txn"], c["w_valid"], codes)
    fused.general_codes(c["t_valid"], c["too_old"], c["hist"], c["w_txn"],
                        c["w_valid"], codes, impl="plain")


# ---------------------------------------------------------------------------
# the merge (csrc/rank_scan.cu mg_merge): partition, merge, finish
# ---------------------------------------------------------------------------

def digest_rows(rng, n: int, prefix: int = 0x6B303030) -> np.ndarray:
    """n distinct sorted rows: lanes 0-5 a shared prefix, lanes 6-7 a
    random 64-bit key over the whole uint32 range of both lanes."""
    keys = np.unique(rng.integers(0, 1 << 63, size=n + n // 8 + 8,
                                  dtype=np.int64).astype(np.uint64) * 2 + 1)
    keys = np.sort(rng.permutation(keys)[:n])
    rows = np.full((n, 8), prefix, np.uint32)
    rows[:, 6] = (keys >> np.uint64(32)).astype(np.uint32)
    rows[:, 7] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return rows


def tier(rows: np.ndarray, cap: int, lo_v: int, hi_v: int, rng):
    """A tier of capacity cap: the zero row, then `rows`, then MAX rows;
    versions in [lo_v, hi_v), NEG_INF past the live rows."""
    n = 1 + rows.shape[0]
    k = np.full((cap, 8), 0xFFFFFFFF, np.uint32)
    k[0] = 0
    k[1:n] = rows
    v = np.full(cap, NEG_INF, np.int32)
    v[:n] = rng.integers(lo_v, hi_v, n)
    return torch.from_numpy(k.view(np.int32)), torch.from_numpy(v), n


def merge_state(dev, cap: int, d_cap: int, n_b: int, n_d: int, seed: int,
                shared: float = 0.3, dup_all: bool = False,
                empty_base: bool = False, empty_delta: bool = False,
                flag: int = 0) -> dict:
    """A base of n_b + 1 live rows and a delta of n_d + 1 (each starting
    at the zero row), a `shared` fraction of the delta's rows equal to
    base rows (all of them with dup_all); an empty tier has size 0."""
    rng = np.random.default_rng(seed)
    b_rows = digest_rows(rng, n_b)
    if dup_all:
        d_rows = b_rows[:n_d]
    else:
        n_sh = min(int(shared * n_d), n_b)
        pool = np.concatenate([b_rows[rng.choice(n_b, n_sh, replace=False)],
                               digest_rows(rng, n_d - n_sh, 0x6B303031)])
        d_rows = pool[np.lexsort(pool.T[::-1])]
    bk, bv, size = tier(b_rows, cap, 0, 4000, rng)
    dk, dv, dsize = tier(d_rows, d_cap, 3000, 6000, rng)
    if empty_base:
        bk[:] = -1
        bv[:] = NEG_INF
        size = 0
    if empty_delta:
        dk[:] = -1
        dv[:] = NEG_INF
        dsize = 0
    st = {"bk": bk, "bv": bv, "size": torch.tensor([size], dtype=torch.int32),
          "dk": dk, "dv": dv,
          "dsize": torch.tensor([dsize], dtype=torch.int32),
          "flag": torch.tensor([flag], dtype=torch.int32)}
    st["table"] = rangemax.build_sparse_table(bv)
    return {k: v.to(dev) for k, v in st.items()}


def check_merge(st, cap: int, d_cap: int, scalars, first=None):
    outs = []
    for impl in (None, "plain"):
        s = copy(st)
        m = fused.make_merge_step(cap, d_cap, impl=impl)
        K.reset_counts()
        outs.append(m(s["bk"], s["bv"], s["table"], s["size"], s["dk"],
                      s["dv"], s["dsize"], s["flag"], scalars, first))
        if impl is None:
            launches = dict(K.LAUNCHES)
    same(outs[0], outs[1])
    assert launches["merge"] == 3
    assert launches["merge"] + launches["build_sparse_table"] <= 4 + 2
    assert sum(launches.values()) == (launches["merge"]
                                      + launches["build_sparse_table"])
    return outs[0]


CAP_S, DCAP_S = 1 << 13, 1 << 11


@pytest.mark.parametrize("case", [
    "plain", "empty_base", "empty_delta", "both_empty", "reset_delta",
    "full_base", "dup_all", "gc_keeps_row_0", "rebase_wrap", "overflow",
    "overflow_by_delta", "first_row"])
def test_merge_cases(dev, case):
    """The merge against its plain version: empty tiers, a just-reset
    delta (its zero row only), a full base (size == cap), a delta that
    duplicates every base row, GC that keeps only row 0, a rebase at the
    int32 wrap edge, size + dsize > cap (the flag set, the poisoned state
    equal) and a shard's `first` row for the reset delta."""
    kw, scalars, first = {}, (2500, 1500), None
    n_b, n_d = 5000, 1500
    if case == "empty_base":
        kw["empty_base"] = True
    elif case == "empty_delta":
        kw["empty_delta"] = True
    elif case == "both_empty":
        kw.update(empty_base=True, empty_delta=True)
    elif case == "reset_delta":
        n_d = 0
    elif case == "full_base":  # the delta's zero row twins the base's
        n_b, n_d, scalars = CAP_S - 1, 0, (-(1 << 31) + 2, 0)
    elif case == "dup_all":
        n_b, n_d, kw["dup_all"] = 1800, 1800, True
    elif case == "gc_keeps_row_0":
        scalars = (1 << 30, 0)
    elif case == "rebase_wrap":
        scalars = (-(1 << 31) + 2, -(1 << 31) + 5)
    elif case in ("overflow", "overflow_by_delta"):
        n_b, scalars = (CAP_S - 100, (0, 0)) if case == "overflow" else (
            CAP_S - 1, (0, 7))
        kw["flag"] = 0
    st = merge_state(dev, CAP_S, DCAP_S, n_b, n_d, seed=len(case), **kw)
    if case == "first_row":
        first = st["dk"][3].clone()
        st["bv"][0] = NEG_INF + 5
    out = check_merge(st, CAP_S, DCAP_S, scalars, first)
    size, flag = int(out[3][0]), int(out[7][0])
    assert int(out[6][0]) == 1
    if case.startswith("overflow"):
        assert flag == 1 and size == CAP_S
    else:
        assert flag == 0
    if case == "full_base":
        assert size == CAP_S
    if case == "gc_keeps_row_0":
        assert size == 1
    if case == "both_empty":
        assert size == 0


@pytest.mark.parametrize("total", [1, 1015, 1016, 1017, 2031, 2032, 2033,
                                   3 * 1016 + 1])
def test_merge_tile_edges(dev, total):
    """Merged lengths around multiples of the 1,016-element tile, with the
    tier boundary and the dropped twins falling at tile edges."""
    n_d = max(total // 3 - 1, 0)
    n_b = max(total - n_d - 2, 0)
    st = merge_state(dev, 4096, 2048, n_b, n_d, seed=total, shared=0.0)
    assert int(st["size"][0]) + int(st["dsize"][0]) == max(total, 2)
    check_merge(st, 4096, 2048, (0, 0))
    st = merge_state(dev, 4096, 2048, n_b, n_d, seed=total, shared=0.5)
    check_merge(st, 4096, 2048, (2000, 3))


@pytest.mark.parametrize("shape", ["config2", "config5_shard"])
def test_merge_full_shapes(dev, shape):
    """Config 2's tiers (2^21 / 2^20, ~1.5M and ~200K live rows) and one
    config-5 shard's (2^20 / 2^18), GC and rebase on."""
    cap, d_cap, n_b, n_d = ((1 << 21, 1 << 20, 1_500_000, 200_000)
                            if shape == "config2" else
                            (1 << 20, 1 << 18, 300_000, 60_000))
    st = merge_state(dev, cap, d_cap, n_b, n_d, seed=5)
    check_merge(st, cap, d_cap, (2500, 1000))


# ---------------------------------------------------------------------------
# the range insert under the point insert and window_insert (csrc/insert.cu)
# ---------------------------------------------------------------------------

# Counters of the wrappers the old inserts ran inside them; the range
# insert moves none of them beyond _union_ranges' own.
INSERT_SHARED = ("inclusive_scan", "sort_rows", "searchsorted",
                 "compact_rows", "union_ranges")


def insert_launches(fn) -> dict:
    K.reset_counts()
    fn()
    torch.cuda.synchronize()
    return dict(K.LAUNCHES)


@pytest.mark.parametrize("kind,name", INSERT_CASES,
                         ids=[f"{k}-{n}" for k, n in INSERT_CASES])
def test_insert_cases_kernel_equals_plain(dev, kind, name):
    """tests/test_torch_insert.py's cases (empty ranges, a present end, a
    range over every row, an exact fit, an overflow by one, an end below
    row 0, a masked shard insert), kernel against plain; launches a call:
    the point insert 4, window_insert 3 beyond _union_ranges' own."""
    case = make_case(kind, name)
    got = run_port(case, dev)
    want = run_port(case, dev, impl="plain")
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=f"{kind}-{name} {k}")
    counts = insert_launches(lambda: run_port(case, dev))
    counter = "point_insert" if kind == "point" else "window_insert"
    assert counts[counter] == (4 if kind == "point" else 3)
    if kind == "point":
        assert all(counts[c] == 0 for c in INSERT_SHARED)
    else:
        from foundationdb_tpu_torch.conflict import window
        rows = lambda p: torch.from_numpy(digest.planar_to_rows(p)).to(dev)
        valid = torch.from_numpy(case["valid"].astype(np.int32)).to(dev)
        union = insert_launches(lambda: window._union_ranges(
            rows(case["wb"]), rows(case["we"]), valid))
        assert all(counts[c] == union[c] for c in INSERT_SHARED)


def point_insert_inputs(rng, u_pad: int, w_pad: int, n_keys: int,
                        keyspace: int):
    """A point batch's unique sorted begin keys (MAX padded), their ends and
    w_pad writes over them, about 70% surviving."""
    kid = np.sort(rng.choice(keyspace, size=n_keys, replace=False))
    u_k = digest.max_digest_block(u_pad)
    u_k[:, :n_keys] = key_digests(kid)
    u_e = u_k.copy()
    u_e[7, :n_keys] += 1
    w_uid = rng.integers(0, max(n_keys, 1), size=w_pad).astype(np.int32)
    w_ins = (rng.random(w_pad) < 0.7).astype(np.int32)
    rows = lambda p: torch.from_numpy(digest.planar_to_rows(p))
    return rows(u_k), rows(u_e), torch.from_numpy(w_uid), torch.from_numpy(
        w_ins)


@pytest.mark.parametrize("shape", ["config2", "config5_shard", "small"])
def test_point_insert_stream(dev, shape):
    """Seeded batches of point inserts into one delta, kernel against plain
    after each: config 2's delta (2^20, 2^17 unique keys a batch), a
    config-5 shard's (2^18, u_own, row 0 the shard's lower split), and a
    small delta that overflows."""
    d_cap, u_pad, n_keys, batches = {
        "config2": (1 << 20, 1 << 17, 100_000, 4),
        "config5_shard": (1 << 18, 1 << 16, 60_000, 3),
        "small": (1 << 10, 256, 200, 6)}[shape]
    rng = np.random.default_rng(d_cap)
    keyspace = 10 ** 9
    first = None
    if shape == "config5_shard":
        first = torch.from_numpy(digest.planar_to_rows(
            key_digests([keyspace // 4])))[0]
    states = [fused.make_delta_state(d_cap, dev, None if first is None else
                                     first.to(dev)) for _ in range(2)]
    flags = [torch.zeros(1, dtype=torch.int32, device=dev) for _ in range(2)]
    for b in range(batches):
        u_k, u_e, w_uid, w_ins = (x.to(dev) for x in point_insert_inputs(
            rng, u_pad, u_pad + u_pad // 2, n_keys, keyspace))
        u_own = None
        if first is not None:
            u_own = torch.from_numpy((rng.random(u_pad) < 0.3).astype(
                np.int32)).to(dev)
        outs = []
        for st, flag, impl in zip(states, flags, (None, "plain")):
            tail = torch.zeros(3, dtype=torch.int32, device=dev)
            fused._point_insert(st.bk, st.bv, st.size, u_k, u_e, w_uid, w_ins,
                                torch.tensor([1000 * (b + 1)],
                                             dtype=torch.int32, device=dev),
                                flag, bsize=st.size, tail=tail, impl=impl,
                                u_own=u_own)
            outs.append((st.bk, st.bv, st.size, flag, tail))
        same(outs[0], outs[1])
    if shape == "small":
        assert int(flags[0][0]) == 1
    else:
        assert int(states[0].size[0]) > n_keys


def window_ranges(rng, w: int, n_valid: int, keyspace: int, span: int):
    """w write ranges [key(a), key(a + s)), s in [1, span), the first
    n_valid of them valid."""
    wb, we = range_rows(rng, w, span=span, keyspace=keyspace)
    valid = (np.arange(w) < n_valid).astype(np.int32)
    return wb, we, torch.from_numpy(valid)


@pytest.mark.parametrize("shape", ["config3_delta", "window_2_21"])
def test_window_insert_stream(dev, shape):
    """Seeded batches of range inserts, kernel against plain after each:
    the general step's delta at config-3 shapes (2^20, 2^16 writes a
    batch), and a 2^21 window filled across several batches."""
    from foundationdb_tpu_torch.conflict import window
    cap, w, n_valid, batches = {
        "config3_delta": (1 << 20, 1 << 16, 55_000, 4),
        "window_2_21": (1 << 21, 1 << 16, 60_000, 8)}[shape]
    rng = np.random.default_rng(cap + w)
    states = [window.make_window_state(cap, 0, dev) for _ in range(2)]
    for b in range(batches):
        wb, we, valid = (x.to(dev) for x in window_ranges(
            rng, w, n_valid, 10 ** 8, 100))
        outs = [window.window_insert(st, wb, we, valid, 1000 * (b + 1),
                                     impl=impl)
                for st, impl in zip(states, (None, "plain"))]
        same(outs[0], outs[1])
    assert int(states[0].size[0]) > batches * n_valid


def chunk_edge_ranges(live: int, mode: str):
    """Ranges at the move's 256-row chunk edges c of a tier whose row j >= 1
    is key(1000 j): "across" drops rows c-5..c+5, "from" begins at row c,
    "to" ends at row c (a present end); edges up to just past the live
    prefix."""
    lo, hi = {"across": (-5500, 5500), "from": (0, 3000),
              "to": (-2999, 0)}[mode]
    edges = np.arange(256, live + 6, 256)
    b, e = 1000 * edges + lo, 1000 * edges + hi
    rows = lambda ids: torch.from_numpy(digest.planar_to_rows(key_digests(
        ids)))
    return rows(b), rows(e)


@pytest.mark.parametrize("n_valid", [0, 1, 255, 256, 257, 511, 512, 513,
                                     1024, 1025])
def test_window_insert_tile_edges(dev, n_valid):
    """Valid ranges around multiples of the 256-range probe tile (none and
    one included), into tiers of live rows around multiples of the move's
    256-row chunk, with no range at a chunk edge, or the first ones
    replaced by ranges whose dropped span crosses an edge, begins at one or
    ends at one."""
    from foundationdb_tpu_torch.conflict import window
    w, cap = 1536, 1 << 12
    for live in (255, 256, 257, 511, 512, 513, 1000):
        rng = np.random.default_rng(live * 2000 + n_valid)
        bk = digest.max_digest_block(cap)
        bk[:, 0] = 0
        bk[:, 1:live] = key_digests(1000 * np.arange(1, live))
        bv = np.full(cap, NEG_INF, dtype=np.int32)
        bv[:live] = rng.integers(0, 500, size=live, dtype=np.int32)
        for mode in (None, "across", "from", "to"):
            wb, we, valid = window_ranges(rng, w, n_valid, 10 ** 6, 40)
            if mode is not None:
                eb, ee = chunk_edge_ranges(live, mode)
                k = min(eb.shape[0], n_valid)
                wb[:k], we[:k] = eb[:k], ee[:k]
            wb, we, valid = wb.to(dev), we.to(dev), valid.to(dev)
            outs = [window.window_insert(
                window.window_state_from_numpy(bk, bv, live, dev), wb, we,
                valid, 900, impl=impl) for impl in (None, "plain")]
            same(outs[0], outs[1])


@pytest.mark.parametrize("n_keys", [0, 1, 255, 256, 257, 1024])
def test_point_insert_tile_edges(dev, n_keys):
    """Unique keys around multiples of the probe tile, none and one
    included, every write surviving."""
    rng = np.random.default_rng(n_keys)
    u_pad = 2048
    u_k, u_e, w_uid, _ = (x.to(dev) for x in point_insert_inputs(
        rng, u_pad, u_pad, n_keys, 10 ** 6))
    w_ins = torch.ones(u_pad, dtype=torch.int32, device=dev)
    outs = []
    for impl in (None, "plain"):
        st = make_state(dev, seed=4)
        tail = torch.zeros(3, dtype=torch.int32, device=dev)
        fused._point_insert(st["dk"], st["dv"], st["dsize"], u_k, u_e, w_uid,
                            w_ins, torch.tensor([7000], dtype=torch.int32,
                                                device=dev), st["flag"],
                            bsize=st["size"], tail=tail, impl=impl)
        outs.append((st["dk"], st["dv"], st["dsize"], st["flag"], tail))
    same(outs[0], outs[1])


# ------------------------------------------------------------ range probes
# history_probe (ds_history) and window_query (wq_query) walk the first
# levels of each search in shared memory (csrc/common.cuh probe_max), in
# lockstep over the tiers, with the live queries queued per warp.

STAGED = 8  # csrc/common.cuh PROBE_LEVELS


def probe_tier(dev, rng, cap: int, live: int):
    """(rows, versions, sparse table) of a cap-row tier: `live` sorted
    distinct point keys from row 0 on, MAX rows and NEG_INF past them."""
    ids = np.unique(rng.integers(0, 10 ** 13, size=live + live // 8 + 8))
    ids = np.sort(rng.permutation(ids)[:live])
    planar = digest.max_digest_block(cap)
    planar[:, :live] = key_digests(ids)
    bk = torch.from_numpy(digest.planar_to_rows(planar)).to(dev)
    bv = torch.full((cap,), NEG_INF, dtype=torch.int32)
    bv[:live] = torch.from_numpy(rng.integers(0, 5000, size=live,
                                              dtype=np.int32))
    bv = bv.to(dev)
    return bk, bv, rangemax.build_sparse_table(bv)


def probe_queries(rng, bk: torch.Tensor, live: int, n_rand: int):
    """Rows (begins, ends) on bk's device: a point range at every staged
    row of bk's tree; begin = end at live rows; a range over every live
    row (the paths split at the first live node) and one to MAX; ranges
    from a live row to the row after next (the paths split at that row's
    node, mostly near the bottom); n_rand random point and short ranges;
    MAX and edge-lane rows.  Their count is odd, no multiple of a block."""
    cap = bk.shape[0]
    levels = min(STAGED, cap.bit_length() - 1)
    host = bk.cpu()
    staged = host[torch.tensor(search_top(cap, levels) or [0])]
    bump = lambda r: torch.cat([r[:, :7], r[:, 7:] + 1], dim=1)
    idx = lambda n: torch.from_numpy(rng.integers(0, max(live, 1), n)).long()
    pick = idx(64)
    nxt = torch.clamp(pick + 2, max=max(live - 1, 0))
    ids = rng.integers(0, 10 ** 13, size=n_rand)
    span = np.where(rng.random(n_rand) < 0.5, 0, rng.integers(1, 10 ** 9,
                                                               n_rand))
    rb = torch.from_numpy(digest.planar_to_rows(key_digests(ids)))
    re = torch.from_numpy(digest.planar_to_rows(key_digests(ids + span)))
    re = torch.where(torch.from_numpy(span == 0)[:, None], bump(rb), re)
    mx = torch.full((3, 8), -1, dtype=torch.int32)
    lanes = torch.from_numpy(np.array(
        [0, 1, 0x7FFFFFFF, -0x80000000, -2, -1], dtype=np.int32))
    edge = lanes[torch.from_numpy(rng.integers(0, 6, (33, 8))).long()]
    begins = [staged, host[pick], host[:1], host[:1], host[pick], rb, mx,
              edge]
    ends = [bump(staged), host[pick], host[max(live - 1, 0):][:1], mx[:1],
            host[nxt], re, mx, edge.flip(0)]
    qb, qe = torch.cat(begins), torch.cat(ends)
    if qb.shape[0] % 2 == 0:
        qb, qe = qb[1:], qe[1:]
    return qb.contiguous().to(bk.device), qe.contiguous().to(bk.device)


def check_probes(dev, rng, base, delta, qb, qe):
    """history_probe with no mask, nothing owned, all owned and a quarter
    owned; window_query on the base with all and a quarter valid: kernel
    against plain."""
    bk, bv, bt = base
    dk, _, dt = delta
    n = qb.shape[0]
    quarter = torch.from_numpy((rng.random(n) < 0.25).astype(np.int32))
    for own in (None, torch.zeros(n, dtype=torch.int32),
                torch.ones(n, dtype=torch.int32), quarter):
        own = None if own is None else own.to(dev)
        same(digest.history_probe(bk, bt, dk, dt, qb, qe, own=own),
             digest.history_probe(bk, bt, dk, dt, qb, qe, impl="plain",
                                  own=own))
    from foundationdb_tpu_torch.conflict import window
    snap = torch.from_numpy(rng.integers(-10, 5010, n,
                                         dtype=np.int32)).to(dev)
    for valid in (torch.ones(n, dtype=torch.int32), quarter):
        valid = valid.to(dev)
        same(window.window_query(bk, bv, qb, qe, snap, valid),
             window.window_query(bk, bv, qb, qe, snap, valid, impl="plain"))


@pytest.mark.parametrize("log_cap", list(range(1, 22)))
def test_probes_every_cap(dev, log_cap):
    """Both probes at every capacity 2^1 .. 2^21 (the staged depth, 8,
    exceeds log2(cap) below 2^8), with live sizes 0, 1 and cap in each
    tier: queries at every staged row, begin = end, ranges whose paths
    split at the top and near the bottom, masks of every share."""
    cap = 1 << log_cap
    rng = np.random.default_rng(log_cap)
    for live in (0, 1, cap):
        base = probe_tier(dev, rng, cap, live)
        delta = probe_tier(dev, rng, max(cap // 2, 1), min(live, cap // 2))
        qb, qe = probe_queries(rng, base[0], live, 1001)
        check_probes(dev, rng, base, delta, qb, qe)


@pytest.mark.parametrize("slots", [4_097, 524_289])
def test_probes_both_layouts(dev, slots):
    """ds_history's two layouts on the general step's tiers (2^21 and
    2^20, half full): ~4,500 keys (4,097 random ones and the edge cases)
    take a lane a tier (their lanes fit on the card at once), ~525,000
    (the general step's 524,288 read slots and more) a thread a key (on an
    H100, 132 SMs of 2,048 threads hold at most 270,336 lanes);
    window_query at the same queries."""
    rng = np.random.default_rng(slots)
    base = probe_tier(dev, rng, 1 << 21, 1 << 20)
    delta = probe_tier(dev, rng, 1 << 20, 1 << 18)
    qb, qe = probe_queries(rng, base[0], 1 << 20, slots)
    check_probes(dev, rng, base, delta, qb, qe)


def test_probes_unsorted_tier(dev):
    """The tier an empty range at a live boundary leaves (empty_at_row: a
    MAX row at NEG_INF inside the live prefix, as the reference leaves
    it; its whole tree staged), and a 2^12 tier with such rows planted at
    the staged levels and below them, each as the base and as the delta;
    the staged search is path-exact, so the kernels agree with the plain
    versions there too."""
    st = run_port(make_case("window", "empty_at_row"), dev)
    bk = torch.from_numpy(digest.planar_to_rows(st["bk"])).to(dev)
    bv = torch.from_numpy(st["bv"]).to(dev)
    unsorted = (bk, bv, rangemax.build_sparse_table(bv))
    rng = np.random.default_rng(77)
    other = probe_tier(dev, rng, 16, 9)
    qb, qe = probe_queries(rng, bk, st["size"], 2001)
    check_probes(dev, rng, unsorted, other, qb, qe)
    check_probes(dev, rng, other, unsorted, qb, qe)
    bk, bv, _ = probe_tier(dev, rng, 1 << 12, 3_000)
    at = torch.tensor(search_top(1 << 12, 10)[::37] + [5, 1_001, 2_998])
    bk[at.to(dev)] = -1
    bv[at.to(dev)] = NEG_INF
    planted = (bk, bv, rangemax.build_sparse_table(bv))
    qb, qe = probe_queries(rng, bk, 3_000, 4_001)
    check_probes(dev, rng, planted, other, qb, qe)
    check_probes(dev, rng, other, planted, qb, qe)


def test_resolution_plane_small_case(dev):
    """chip_smoke.py's small exact case on the card: the reference's
    aligned parity stream and a contended straddling stream (a boundary
    move after wave 5, old-snapshot reads across it) at N = 1, 2 and 4
    through a resolution plane whose roles' supervised sets are on the
    card, against one over the port's oracle: replies equal batch for
    batch, the moves equal, no degrade."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke
    out = chip_smoke.plane_small(torch.cuda.get_device_name(0),
                                 device=dev.type)
    assert out["straddle_2"]["moved"] and out["straddle_4"]["moved"]
    assert out["straddle_4"]["old_snapshot_reads"] > 0


def test_sched_small_case(dev):
    """chip_smoke.py's small exact case of the scheduling plane on the
    card: every stage on (all+ladder) at N = 2, two proxies, every abort
    attributed exactly; with two reads a txn the plane whose roles' sets
    are on the card against one on the CPU, with one read a txn against
    one over the port's oracle: replies, stage counters and the GRV and
    commit proxies' status equal, no degrade, every stage acting."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke
    out = chip_smoke.sched_small(torch.cuda.get_device_name(0),
                                 device=dev.type)
    assert out["two_reads"]["backed_off"] > 0
    assert out["one_read"]["max_defers"] == 3


def test_write_path_small_case(dev):
    """chip_smoke.py's phase 22 at a small size with the resolvers' sets
    on the card (replies, durability, read-back on both replicas at two
    versions, counter, versionstamps, queue files, the point and general
    steps launched, every batch's replies equal to a CPU plane's
    verdicts), and its verdict replay against the oracle plane."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke
    launches, figures = chip_smoke.commit_run(
        device=dev.type, keyspace=20_000, txns=1_500, batches=(1, 4),
        capacity=1 << 14, delta_capacity=1 << 13)
    assert figures["committed"] > 0 and figures["versionstamps"] > 0
    assert launches["compact_prep"] > 0 and launches["interval_fixpoint"] > 0
    chip_smoke.commit_small(torch.cuda.get_device_name(0), device=dev.type)


def test_restart_small_case(dev):
    """chip_smoke.py's phase 23 at a small size with the resolvers' sets
    on the card, over each engine: two kills and recoveries read back
    every acknowledged key on both replicas, a held-back server's spilled
    backlog included, and the new epoch's batches launch the compact and
    general steps' kernels and equal a CPU plane's verdicts."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke
    for engine in ("memory", "btree"):
        launches, figures = chip_smoke.restart_run(
            engine=engine, device=dev.type, keyspace=3_000, txns=300,
            batches=(2, 2), after=2, capacity=1 << 12,
            delta_capacity=1 << 11, spill_threshold=4_000)
        assert figures["restarts"] == 2 and figures["mb_spilled"] > 0
        assert launches["compact_prep"] > 0
        assert launches["interval_fixpoint"] > 0


def test_client_small_case(dev):
    """chip_smoke.py's phase 24 at a small size with the resolvers' sets
    on the card: ReadWrite and Cycle through StaticCluster.database() on
    the port's event loop, every acknowledged write read back on both
    replicas, the ring intact, the Cycle batches equal to an oracle
    plane's, the compact and general steps launched."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke
    K.reset_counts()
    figures = chip_smoke.client_run(
        device=dev.type, keyspace=20_000, rw_actors=256, rw_txns=4,
        cycle_nodes=500, cycle_actors=64, cycle_swaps=2,
        capacity=1 << 14, delta_capacity=1 << 13)
    assert figures["cycle"]["swaps"] == 128
    assert K.LAUNCHES["compact_prep"] > 0
    assert K.LAUNCHES["interval_fixpoint"] > 0


def test_shard_moves_small_case(dev):
    """chip_smoke.py's phase 27 at a small size with the resolvers' sets
    on the card: a shard moved, the split sweep, a storage process killed
    and its shards re-replicated under ReadWrite; every check of the
    phase, the compact and general steps launched."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke
    K.reset_counts()
    figures = chip_smoke.dd_run(
        device=dev.type, keyspace=20_000, rw_actors=256, rw_txns=5,
        rw_warmup=1, rw_before=1, split_bytes=200_000,
        capacity=1 << 14, delta_capacity=1 << 13)
    assert figures["splits"] > 0 and figures["rereplications"] >= 2
    assert figures["fence_checks"] > 0
    assert K.LAUNCHES["compact_prep"] > 0
    assert K.LAUNCHES["interval_fixpoint"] > 0


def test_recovery_small_case(dev):
    """chip_smoke.py's phase 28 at a small size with the Resolver roles'
    sets on the card: four kills, four new epochs through the five
    states, every check of the phase, and the compact and general steps
    launched in every epoch (counted before the native set's comparison
    with a bare set on the card); then that comparison."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke
    K.reset_counts()
    with chip_smoke.recovery_cluster(
            device=dev.type, keyspace=20_000, rw_actors=256,
            capacity=1 << 14, delta_capacity=1 << 13) as run:
        figures = run.figures
    assert [k["new_epoch"] for k in figures["kills"]] == [2, 3, 4, 5]
    assert all(n > 0 for n in figures["epoch_launches"].values())
    assert K.LAUNCHES["compact_prep"] > 0
    assert K.LAUNCHES["interval_fixpoint"] > 0
    native = chip_smoke.native_against_card(
        dev.type, 2, 10_000, capacity=1 << 14, delta_capacity=1 << 13)
    assert native["ranges"] > 0


def test_fleet_small_case(dev):
    """chip_smoke.py's phase 29 at a small size with the Resolver roles'
    sets on the card, on phase 28's cluster: the configure to 3
    resolvers, whose new epoch's three roles resolve on the card with
    the compact and general steps launched there (counted from the
    phase's start), then the storage death, the exclusion and the wiggle
    step, with every check of the phase."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke

    with chip_smoke.recovery_cluster(
            device=dev.type, keyspace=20_000, rw_actors=256,
            capacity=1 << 14, delta_capacity=1 << 13) as run:
        K.reset_counts()
        fleet = chip_smoke.fleet_run(run)
    configure = fleet["steps"][0]
    assert configure["resolvers"] == 3 and configure["epoch"] == 6
    assert min(configure["resolver_batches"]) > 0
    assert all(n > 0 for n in fleet["epoch_launches"].values())
    assert fleet["launches"]["compact_prep"] > 0
    assert fleet["launches"]["interval_fixpoint"] > 0
    assert fleet["steps"][3]["engine_migrations"] >= 1
