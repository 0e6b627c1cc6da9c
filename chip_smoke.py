#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA conflict path on one NVIDIA GPU.

Drives foundationdb_tpu_torch's point-batch main path (the resolver's
production route: TorchConflictSet.resolve_encoded_async -> _pack_compact
-> the compact step, the delta table, the merge) at the size of the
bench's config 2: 100K transactions per batch, 2 point reads + 1 point
write each, zipf(1.2) keys over a 1M keyspace as 15-byte b"k%014d" keys,
capacity 2^21, delta capacity 2^20, snapshots up to 2,000 versions behind,
1,000 versions per batch, the window floor 5 batches back.

Phases (each prints its lines; any failure raises and exits non-zero):
  1. toolchain: the card's name and power limit, CUDA, nvcc; build the
     kernels from csrc/ (one nvcc per source, in parallel);
  2. every kernel wrapper, and the three device programs, through the
     kernel and through its plain-torch version on the card on identical
     inputs at the main path's shapes: outputs must be bit-equal (all of
     it is integer data; tolerance 0); times by CUDA events (a wrapper's
     row: the device time of its own launches, without host gaps);
  3. the main path: 3 warmup batches, 10 measured at pipeline depth 8
     (crossing merges), 8 at depth 1 for the p50 (and host packing alone
     on the same batches); verdict parity against the oracle on 2
     high-contention batches and on 2 low-contention batches of 10K txns,
     and against PointOracle (held equal to the oracle on all of those
     first) on 2 full-size low-contention batches; state equality of the
     kernel path against impl="plain" over a short stream that crosses a
     merge;
  4. the kernels line (launch counts of the main path's run, all > 0);
  5. the last line: {"ok": true, "device": {...}}.

Run it from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import deque

import numpy as np

TXNS = 100_000
READS = 2
KEYSPACE = 1_000_000
KEYSPACE_LOW = 100_000_000
VERSIONS_PER_BATCH = 1_000
WINDOW = 5 * VERSIONS_PER_BATCH
CAPACITY = 1 << 21
DELTA_CAPACITY = 1 << 20
N_WARMUP, N_MEASURED, N_LATENCY, DEPTH = 3, 10, 8, 8
N_PARITY, N_LOWC = 2, 2
N_LOWC_SMALL, N_LOWC_SMALL_TXNS = 2, 10_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
REPS = 5
BACKLOG_CYCLES = 50_000_000  # ~25 ms of sleep at the H100's ~2 GHz
DEVICE = "cuda"


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------- workload
def gen_batch(rng, prev: int, keyspace: int, zipf: bool, txns: int = TXNS):
    """The bench's config-2 batch (bench.py gen_batch): columns + the key
    ids and snapshots the oracle's object form is built from."""
    from foundationdb_tpu_torch.conflict.encoded import EncodedBatch
    from foundationdb_tpu_torch.ops.digest import encode_fixed
    n = txns * (READS + 1)
    if zipf:
        kids = (rng.zipf(1.2, size=n) % keyspace).astype(np.int64)
    else:
        kids = rng.integers(0, keyspace, size=n, dtype=np.int64)
    mat = np.empty((n, 16), dtype=np.uint8)
    mat[:, 0] = ord("k")
    mat[:, 15] = 0
    x = kids.copy()
    for d in range(14):
        mat[:, 14 - d] = 48 + x % 10
        x //= 10
    snaps = np.maximum(prev - rng.integers(0, 2 * VERSIONS_PER_BATCH,
                                           size=txns), 0)
    nr = txns * READS
    begin = encode_fixed(mat[:, :15])
    end = encode_fixed(mat)
    enc = EncodedBatch(
        n_txns=txns, t_snap=snaps.astype(np.int64),
        t_has_reads=np.ones((txns,), dtype=bool),
        r_txn=np.arange(nr, dtype=np.int32) // READS,
        r_begin=begin[:, :nr], r_end=end[:, :nr],
        w_txn=np.arange(txns, dtype=np.int32),
        w_begin=begin[:, nr:], w_end=end[:, nr:], all_point=True)
    return enc, kids, snaps


def to_transactions(kids, snaps):
    from foundationdb_tpu_torch.txn.types import CommitTransactionRef, KeyRange
    keys = [b"k%014d" % int(k) for k in kids]
    txns = len(snaps)
    nr = txns * READS
    return [CommitTransactionRef(
        read_conflict_ranges=[KeyRange(k, k + b"\x00") for k in
                              keys[t * READS:(t + 1) * READS]],
        write_conflict_ranges=[KeyRange(keys[nr + t], keys[nr + t] + b"\x00")],
        read_snapshot=int(snaps[t])) for t in range(txns)]


class PointOracle:
    """The oracle's semantics (SkipList.cpp, conflict/oracle.py) for the
    stream's all-point batches, with the intra-batch check as a set lookup:
    [r, r+\\x00) overlaps [w, w+\\x00) only when r == w, so the oracle's
    scan over every earlier surviving write (quadratic in a batch's
    survivors: hours for a 100K-txn batch that mostly commits) becomes one
    membership test.  History, insertion and GC are the oracle copy's own
    VersionHistory.  It is held equal to OracleConflictSet itself, on
    high-contention batches and on smaller low-contention ones, before it
    judges the full-size low-contention batches."""

    def __init__(self):
        from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet
        self._o = OracleConflictSet(0)

    def resolve(self, kids, snaps, now: int, new_floor: int) -> np.ndarray:
        from foundationdb_tpu_torch.conflict.oracle import \
            combine_write_ranges
        o, hist = self._o, self._o.history
        keys = [b"k%014d" % int(k) for k in kids]
        txns = len(snaps)
        nr = txns * READS
        codes = np.full((txns,), 2, dtype=np.int8)
        written, survivors = set(), []
        for t in range(txns):
            snap = int(snaps[t])
            if snap < o.oldest_version:          # every txn reads
                codes[t] = 1
                continue
            reads = keys[t * READS:(t + 1) * READS]
            if any(hist.query_max(k, k + b"\x00") > snap or k in written
                   for k in reads):
                codes[t] = 0
                continue
            w = keys[nr + t]
            written.add(w)
            survivors.append((w, w + b"\x00"))
        hist.insert_many(combine_write_ranges(survivors), now)
        if new_floor > o.oldest_version:
            o.oldest_version = new_floor
            hist.remove_before(new_floor)
        return codes


def make_stream(rng, count: int, keyspace=KEYSPACE, zipf=True, txns=TXNS):
    out, version = [], 1_000
    for _ in range(count):
        prev, version = version, version + VERSIONS_PER_BATCH
        out.append((version, *gen_batch(rng, prev, keyspace, zipf, txns)))
    return out


def floor(v: int) -> int:
    return max(v - WINDOW, 0)


# ------------------------------------------------------------- measurement
def cuda_ms(fn, reps: int = REPS, setup=None) -> float:
    """Mean milliseconds of fn() on the device's timeline over reps, by
    CUDA events around the call (host gaps between its launches included);
    setup() runs before each rep, outside the timed span."""
    import torch
    total = 0.0
    for _ in range(reps):
        if setup is not None:
            setup()
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def device_ms(fn, reps: int = REPS, setup=None, counter=None) -> float:
    """Mean device milliseconds per call of fn(), without host gaps: a
    sleep kernel holds the stream while the host enqueues the call, so
    every launch is queued before the card reaches it (a rep whose sleep
    ended first is taken again with a longer sleep).  With `counter`, the
    time is the sum over the launches counted under that name, each
    bracketed by its own pair of events (kernels.timed_launches), so a
    wrapper's row holds its own kernels and not those of the wrappers it
    calls; without, it is the whole call."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    total, cycles = 0.0, BACKLOG_CYCLES
    for _ in range(reps):
        for _attempt in range(4):
            if setup is not None:
                setup()
            torch.cuda._sleep(cycles)
            held = torch.cuda.Event()
            held.record()
            a, b = torch.cuda.Event(True), torch.cuda.Event(True)
            with K.timed_launches() as timed:
                a.record()
                fn()
                b.record()
            backlogged = not held.query()
            torch.cuda.synchronize()
            if backlogged:
                break
            cycles *= 4
        else:
            raise AssertionError("the host could not enqueue one call "
                                 "within the stream's sleep")
        if counter is None:
            total += a.elapsed_time(b)
            continue
        pairs = timed.get(counter, [])
        if not pairs:
            raise AssertionError(f"{counter}: no launch under its counter")
        total += sum(s.elapsed_time(e) for s, e in pairs)
    return total / reps


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


def search_bytes(table, n_queries: int) -> int:
    """Distinct table rows a batch of binary searches must read: level l
    of the search touches at most min(2^l, Q) rows."""
    cap = table.shape[0]
    levels = cap.bit_length()
    rows = sum(min(1 << lvl, n_queries, cap) for lvl in range(levels))
    return rows * table.shape[1] * table.element_size()


def bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def max_abs_err(a, b) -> int:
    import torch
    if a.dtype == torch.bool:
        a, b = a.int(), b.int()
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def require_equal(name: str, got, want) -> int:
    """The largest absolute difference between the kernel's outputs and the
    plain version's; raises unless it is 0 and every shape agrees."""
    if isinstance(got, (tuple, list)):
        return max(require_equal(f"{name}[{i}]", g, w)
                   for i, (g, w) in enumerate(zip(got, want)))
    if isinstance(got, dict):
        return max(require_equal(f"{name}.{k}", got[k], want[k]) for k in got)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shapes differ, {tuple(got.shape)} "
                             f"against {tuple(want.shape)}")
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{name}: kernel and plain outputs differ "
                             f"(max abs err {err})")
    return err


# ------------------------------------------------------------------ phases
def toolchain() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    from foundationdb_tpu_torch import kernels as K
    nvcc = subprocess.run([K.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"toolchain: gpu={smi!r} torch={torch.__version__} "
          f"cuda={torch.version.cuda} nvcc={nvcc[-1]!r}", flush=True)
    secs = K.build(force=True)
    print(f"build: {len(K.SOURCES)} sources in {secs:.2f} s "
          f"(into {os.path.relpath(K.BUILD_DIR)})", flush=True)
    return smi


def warmed_state():
    """A backend on the card after 3 batches and a merge, the next batch
    packed and stamped, and a copy of its state."""
    import torch
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
    cs = TorchConflictSet(0, capacity=CAPACITY, delta_capacity=DELTA_CAPACITY, device=DEVICE)
    stream = make_stream(np.random.default_rng(7), 5)
    for v, enc, _, _ in stream[:3]:
        cs.resolve_encoded_async(enc, v, floor(v)).wait_codes()
    cs.merge()
    v, enc, _, _ = stream[3]
    cs.resolve_encoded_async(enc, v, floor(v)).wait_codes()  # delta non-empty
    v, enc, _, _ = stream[4]
    packed = cs._pack(enc)
    cs._stamp(packed, v, cs.oldest_version, enc.n_txns)
    cs.oldest_version = floor(v)
    cs.synchronize()
    buf = torch.from_numpy(packed["buf"]).to(DEVICE)
    return cs, packed, buf


def compare_kernels(cs, packed, buf):
    """Phase 2: each wrapper and program, kernel against plain."""
    import torch
    from foundationdb_tpu_torch.conflict import fused
    from foundationdb_tpu_torch.ops import digest, rangemax, scan
    t_cap, r_pad, w_pad, u_pad, lw = packed["shapes"]
    lay = fused.compact_layout(t_cap, r_pad, w_pad, u_pad, lw)
    b32 = buf.view(torch.int32)

    def i32(name, n):
        return b32[lay[name] // 4:lay[name] // 4 + n]

    ub = buf[lay["ubytes"]:lay["ubytes"] + u_pad * lw]
    r_uid, w_uid = i32("r_uid", r_pad), i32("w_uid", w_pad)
    r_start, w_start = i32("r_start", t_cap), i32("w_start", t_cap)
    t_snap = i32("t_snap", t_cap)
    t_flags = buf[lay["t_flags"]:lay["t_flags"] + t_cap]
    scal = i32("scalars", fused.COMPACT_SCALARS)
    P = "plain"

    # Intermediates of the step, from the plain versions.
    u_b, u_e = digest.widen_unique(ub, scal, lw, u_pad, P)
    too_old, r_cnt, w_cnt = fused.txn_prep(r_start, w_start, t_snap, t_flags,
                                           scal, r_pad, w_pad, P)
    vmax = digest.history_probe(cs.bk, cs.table, cs.dk, cs.dtable, u_b, u_e,
                                P)
    rw = fused.read_write_prep(r_uid, w_uid, r_cnt, w_cnt, too_old, t_snap,
                               scal, vmax, u_pad, P)
    conf, rounds = fused.intra_batch_fixpoint(
        rw["hist"], rw["r_txn"], rw["r_live"], rw["r_slot"], rw["w_txn"],
        rw["w_ok"], rw["w_slot"], u_pad, P)
    codes = torch.empty((t_cap,), dtype=torch.int8, device=DEVICE)
    w_ins = fused.batch_codes(scal, too_old, conf, rw["w_txn"], codes, P)
    log(f"fixpoint rounds on this batch: {int(rounds.item())}")
    keep_s = (torch.arange(CAPACITY + DELTA_CAPACITY, device=DEVICE) % 3
              != 0).to(torch.int32)
    s_rows = torch.arange((CAPACITY + DELTA_CAPACITY) * 8, dtype=torch.int32,
                          device=DEVICE).reshape(-1, 8)
    s_v = torch.arange(CAPACITY + DELTA_CAPACITY, dtype=torch.int32,
                       device=DEVICE)
    ks_incl = scan.inclusive_scan(keep_s, P)
    dpos = digest.searchsorted(cs.dk, u_e, True, P)
    rw_in = (rw["hist"], rw["r_txn"], rw["r_live"], rw["r_slot"],
             rw["w_txn"], rw["w_ok"], rw["w_slot"])

    def state_copy():
        return {k: getattr(cs, k).clone() for k in
                ("bk", "bv", "table", "size", "dk", "dv", "dtable", "dsize",
                 "flag")}

    def insert_run(impl, st):
        out = torch.zeros((3,), dtype=torch.int32, device=DEVICE)
        fused._point_insert(st["dk"], st["dv"], st["dsize"], u_b, u_e, w_uid,
                            w_ins, scal[4:5], st["flag"], bsize=st["size"],
                            tail=out, impl=impl)
        return (st["dk"], st["dv"], st["dsize"], st["flag"], out)

    def step_run(impl, st):
        step = fused.make_resolve_step_compact(
            CAPACITY, cs.d_cap, t_cap, r_pad, w_pad, u_pad, lw, impl=impl)
        r = step(st["bk"], st["bv"], st["table"], st["size"], st["dk"],
                 st["dv"], st["dtable"], st["dsize"], st["flag"], buf)
        return r

    def merge_run(impl, st):
        m = fused.make_merge_step(CAPACITY, cs.d_cap, impl=impl)
        return m(st["bk"], st["bv"], st["table"], st["size"], st["dk"],
                 st["dv"], st["dsize"], st["flag"],
                 (cs._rel(cs.oldest_version),
                  max(cs.oldest_version - cs.version_base, 0)))

    # Least bytes of the history probe: the unique keys in, the maxima
    # out, the table rows a batch of searches touches in each tier (once:
    # a key's begin and end searches walk the same rows, since no row lies
    # between b and its successor e but b itself), two range-max gathers
    # per key and tier.
    probe_bytes = (nbytes(u_b, u_e, vmax) + search_bytes(cs.bk, u_pad)
                   + search_bytes(cs.dk, u_pad) + 4 * 4 * u_pad)
    # name -> (fn(impl) -> outputs, bytes bound, library call or None);
    # stateful cases get a fresh copy of the state per call.
    cases = {
        "widen_unique": (lambda i: digest.widen_unique(ub, scal, lw, u_pad, i),
                         nbytes(ub, u_b, u_e), None),
        "searchsorted": (lambda i: digest.searchsorted(cs.dk, u_e, True, i),
                         nbytes(u_e, dpos) + search_bytes(cs.dk, u_pad),
                         None),
        "history_probe": (
            lambda i: digest.history_probe(cs.bk, cs.table, cs.dk, cs.dtable,
                                           u_b, u_e, i),
            probe_bytes, None),
        "rank_count": (lambda i: digest.rank_count(dpos, cs.d_cap, i),
                       nbytes(dpos) + 4 * cs.d_cap, None),
        "inclusive_scan": (lambda i: scan.inclusive_scan(keep_s, i),
                           2 * nbytes(keep_s),
                           lambda: torch.cumsum(keep_s, 0,
                                                dtype=torch.int32)),
        "compact_rows": (
            lambda i: _compact(scan, keep_s, ks_incl, s_rows, s_v, i),
            nbytes(keep_s, ks_incl) + 2 * int(keep_s.sum()) * 36, None),
        "build_sparse_table": (
            lambda i: rangemax.build_sparse_table(cs.bv, impl=i),
            nbytes(cs.bv, cs.table), None),
        "txn_prep": (lambda i: fused.txn_prep(r_start, w_start, t_snap,
                                              t_flags, scal, r_pad, w_pad, i),
                     nbytes(r_start, w_start, t_snap, t_flags, too_old,
                            r_cnt, w_cnt), None),
        "read_write_prep": (
            lambda i: fused.read_write_prep(r_uid, w_uid, r_cnt, w_cnt,
                                            too_old, t_snap, scal, vmax,
                                            u_pad, i),
            nbytes(r_uid, w_uid, r_cnt, w_cnt, too_old, t_snap, vmax,
                   *rw.values()), None),
        "intra_batch_fixpoint": (
            lambda i: fused.intra_batch_fixpoint(*rw_in, u_pad, i)[0],
            nbytes(*rw_in, conf), None),
        "batch_codes": (
            lambda i: _codes(fused, scal, too_old, conf, rw["w_txn"], i),
            nbytes(too_old, conf, rw["w_txn"], codes, w_ins), None),
        # The pi_* kernels: the batch's keys and verdicts in, the delta
        # read and rewritten (its scans and searches are rows of their own).
        "point_insert": ("insert", nbytes(cs.dk, cs.dv, u_b, u_e, w_uid,
                                          w_ins) + nbytes(cs.dk, cs.dv),
                         None),
        # The mg_* kernels: base and delta in, the merged base and the reset
        # delta out (the base table is build_sparse_table's row).
        "merge": ("merge", 2 * nbytes(cs.bk, cs.bv, cs.dk, cs.dv), None),
    }
    stateful = {"insert": insert_run, "merge": merge_run}
    from foundationdb_tpu_torch import kernels as K
    rows = []
    for name, (fn, n_bytes, library) in cases.items():
        if isinstance(fn, str):
            run = stateful[fn]
            holder = {}

            def setup(run=run, holder=holder):
                holder["st"] = state_copy()

            def go(i, run=run, holder=holder):
                return run(i, holder["st"])

            setup()
            got = go("kernel")
            setup_p = state_copy()
            want = run("plain", setup_p)
            err = require_equal(name, got, want)
            ms = device_ms(lambda: go("kernel"), setup=setup, counter=name)
            plain = cuda_ms(lambda: go("plain"), reps=2, setup=setup)
        else:
            got = fn("kernel")
            want = fn("plain")
            err = require_equal(name, got, want)
            ms = device_ms(lambda: fn("kernel"), counter=name)
            plain = cuda_ms(lambda: fn("plain"), reps=2)
        lib = device_ms(library) if library is not None else None
        src, ref = K.KERNELS[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"foundationdb_tpu_torch/csrc/{src}.cu",
                     "replaces": ref, "launches": 0, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain,
                     "bound_ms": bound_ms(n_bytes), "bound_by": "bytes",
                     "library_ms": lib})
        log(f"{name}: bit-equal; own kernels {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bound_ms(n_bytes):.4f} ms")

    # The three device programs, kernel against plain, on state copies.
    programs = {}
    for prog, run, n_bytes in (
            # The buffer in, the probe, the delta read and rewritten, the
            # codes and tail out.
            ("resolve_step", step_run, nbytes(buf) + probe_bytes
             + 2 * nbytes(cs.dk, cs.dv) + t_cap + 12),
            ("delta_table_step", None, nbytes(cs.dv, cs.dtable)),
            # Base and delta in; base, its table and the reset delta out.
            ("merge_step", merge_run, nbytes(cs.bk, cs.bv, cs.dk, cs.dv)
             + nbytes(cs.bk, cs.bv, cs.table, cs.dk, cs.dv))):
        if run is None:
            got = fused.delta_table_step(cs.dv, impl="kernel")
            want = fused.delta_table_step(cs.dv, impl="plain")
            require_equal(prog, got, want)

            def kern():
                fused.delta_table_step(cs.dv, out=cs.dtable)

            setup = None
            plain = cuda_ms(lambda: fused.delta_table_step(cs.dv,
                                                           impl="plain"), 2)
        else:
            a, b = state_copy(), state_copy()
            require_equal(prog, run("kernel", a), run("plain", b))
            holder = {}

            def setup(holder=holder):
                holder["st"] = state_copy()

            def kern(run=run, holder=holder):
                run("kernel", holder["st"])

            plain = cuda_ms(lambda: run("plain", holder["st"]), 2, setup)
        ms = cuda_ms(kern, setup=setup)
        dev_ms = device_ms(kern, setup=setup)
        programs[prog] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                          "bound_ms": bound_ms(n_bytes)}
        log(f"program {prog}: bit-equal; kernel {ms:.3f} ms "
            f"({dev_ms:.3f} ms without host gaps), plain {plain:.3f} ms")
    return rows, programs


def _codes(fused, scal, too_old, conf, w_txn, impl):
    import torch
    codes = torch.empty(too_old.shape, dtype=torch.int8, device=DEVICE)
    return fused.batch_codes(scal, too_old, conf, w_txn, codes, impl), codes


def _compact(scan, keep, incl, rows, vals, impl):
    import torch
    n = rows.shape[0]
    dst_rows = torch.full((n, 8), -1, dtype=torch.int32, device=rows.device)
    dst_v = torch.full((n,), -7, dtype=torch.int32, device=rows.device)
    scan.compact_rows(keep, incl, rows, vals, dst_rows, dst_v, rebase=5,
                      impl=impl)
    return dst_rows, dst_v


def main_path(smi: str):
    """Phase 3 (and the launch counts of phase 4)."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet
    from foundationdb_tpu_torch.conflict.torch_backend import (
        TorchConflictSet, state_to_numpy)

    rng = np.random.default_rng(2026)
    log("generating the config-2 stream")
    batches = make_stream(rng, N_WARMUP + N_MEASURED + N_LATENCY)

    K.reset_counts()
    cs = TorchConflictSet(0, capacity=CAPACITY, delta_capacity=DELTA_CAPACITY, device=DEVICE)
    for v, enc, _, _ in batches[:N_WARMUP]:
        cs.resolve_encoded_async(enc, v, floor(v)).wait_codes()
    merges0 = cs.profile["merges"]
    inflight, results = deque(), []
    n_ranges = 0
    t0 = time.perf_counter()
    for v, enc, _, _ in batches[N_WARMUP:N_WARMUP + N_MEASURED]:
        inflight.append((enc, cs.resolve_encoded_async(enc, v, floor(v))))
        if len(inflight) > DEPTH:
            e, h = inflight.popleft()
            results.append(h.wait_codes().copy())
            n_ranges += e.n_ranges
    while inflight:
        e, h = inflight.popleft()
        results.append(h.wait_codes().copy())
        n_ranges += e.n_ranges
    dt = time.perf_counter() - t0
    rate = n_ranges / dt
    merges = cs.profile["merges"] - merges0
    lats = []
    for v, enc, _, _ in batches[N_WARMUP + N_MEASURED:]:
        t1 = time.perf_counter()
        cs.resolve_encoded_async(enc, v, floor(v)).wait_codes()
        lats.append(time.perf_counter() - t1)
    p50 = float(np.percentile(lats, 50) * 1e3)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    # The host's share of a resolve: packing alone, on the same batches.
    packs = []
    for _, enc, _, _ in batches[N_WARMUP + N_MEASURED:]:
        t1 = time.perf_counter()
        TorchConflictSet._pack_compact(enc)
        packs.append(time.perf_counter() - t1)
    pack_ms = float(np.percentile(packs, 50) * 1e3)
    if merges < 1:
        raise AssertionError("the measured batches crossed no merge")
    commit_rate = float(np.mean([np.mean(r == 2) for r in results]))
    print(f"path: {rate:.1f} ranges/s at depth {DEPTH} over {N_MEASURED} "
          f"batches ({merges} merges), p50 resolve {p50:.3f} ms at depth 1 "
          f"(host packing alone {pack_ms:.3f} ms), commit rate "
          f"{commit_rate:.4f} -- {smi}", flush=True)
    if not 0.01 < commit_rate < 0.99:
        raise AssertionError(f"degenerate contention: {commit_rate}")

    log("oracle parity, high contention")
    oracle, point = OracleConflictSet(0), PointOracle()
    for i, (v, enc, kids, snaps) in enumerate(batches[:N_WARMUP + N_PARITY]):
        want = np.asarray([int(x) for x in oracle.resolve(
            to_transactions(kids, snaps), v, floor(v))], dtype=np.int8)
        if not np.array_equal(point.resolve(kids, snaps, v, floor(v)), want):
            raise AssertionError(f"the point oracle differs from the oracle "
                                 f"on batch {i}")
        if i >= N_WARMUP:
            bad = int(np.sum(results[i - N_WARMUP] != want))
            if bad:
                raise AssertionError(f"parity: {bad} verdicts differ from "
                                     f"the oracle on batch {i}")
    log("oracle parity, low contention, smaller batches")
    small = make_stream(rng, N_LOWC_SMALL, KEYSPACE_LOW, zipf=False,
                        txns=N_LOWC_SMALL_TXNS)
    oracle, point = OracleConflictSet(0), PointOracle()
    cs_small = TorchConflictSet(0, capacity=CAPACITY,
                                delta_capacity=DELTA_CAPACITY, device=DEVICE)
    for i, (v, enc, kids, snaps) in enumerate(small):
        want = np.asarray([int(x) for x in oracle.resolve(
            to_transactions(kids, snaps), v, floor(v))], dtype=np.int8)
        if not np.array_equal(point.resolve(kids, snaps, v, floor(v)), want):
            raise AssertionError(f"the point oracle differs from the oracle "
                                 f"on small low-contention batch {i}")
        got = cs_small.resolve_encoded_async(enc, v, floor(v)).wait_codes()
        bad = int(np.sum(got != want))
        if bad:
            raise AssertionError(f"parity: {bad} verdicts differ from the "
                                 f"oracle on small low-contention batch {i}")
    del cs_small
    log("oracle parity, low contention")
    low = make_stream(rng, N_LOWC, KEYSPACE_LOW, zipf=False)
    cs_low = TorchConflictSet(0, capacity=CAPACITY,
                              delta_capacity=DELTA_CAPACITY, device=DEVICE)
    point = PointOracle()
    committed = 0
    for i, (v, enc, kids, snaps) in enumerate(low):
        got = cs_low.resolve_encoded_async(enc, v, floor(v)).wait_codes()
        bad = int(np.sum(got != point.resolve(kids, snaps, v, floor(v))))
        if bad:
            raise AssertionError(f"parity: {bad} verdicts differ from the "
                                 f"point oracle on low-contention batch {i}")
        committed += int(np.sum(got == 2))
    commit_low = committed / (N_LOWC * TXNS)
    if commit_low < 0.8:
        raise AssertionError(f"low-contention regime degenerate: {commit_low}")
    print(f"parity: verdicts equal the oracle on {N_PARITY} high-contention "
          f"batches and on {N_LOWC_SMALL} low-contention batches of "
          f"{N_LOWC_SMALL_TXNS} txns, and the point oracle (itself equal to "
          f"the oracle on those {N_WARMUP + N_PARITY} + {N_LOWC_SMALL} "
          f"batches) on {N_LOWC} low-contention batches of {TXNS} txns "
          f"(commit rates {commit_rate:.4f} / {commit_low:.4f})", flush=True)

    log("state equality, kernels against impl='plain'")
    kern = TorchConflictSet(0, capacity=CAPACITY,
                            delta_capacity=DELTA_CAPACITY,
                            gc_interval_batches=2, device=DEVICE)
    plain = TorchConflictSet(0, capacity=CAPACITY,
                             delta_capacity=DELTA_CAPACITY,
                             gc_interval_batches=2, impl="plain",
                             device=DEVICE)
    for v, enc, _, _ in batches[:4]:
        a = kern.resolve_encoded_async(enc, v, floor(v)).wait_codes()
        b = plain.resolve_encoded_async(enc, v, floor(v)).wait_codes()
        if not np.array_equal(a, b):
            raise AssertionError("kernel and plain verdicts differ")
        sa, sb = state_to_numpy(kern), state_to_numpy(plain)
        for k in sa:
            if not np.array_equal(np.asarray(sa[k]), np.asarray(sb[k])):
                raise AssertionError(f"kernel and plain state differ: {k}")
    if kern.profile["merges"] < 1:
        raise AssertionError("state-equality stream crossed no merge")
    print(f"state: kernel path equals the plain path on 4 batches and "
          f"{kern.profile['merges']} merge(s), every state array", flush=True)
    path = {"ranges_per_s": rate, "p50_resolve_ms": p50,
            "p50_pack_ms": pack_ms,
            "commit_rate": commit_rate, "commit_rate_low": commit_low,
            "merges_measured": merges, "batches_measured": N_MEASURED,
            "depth": DEPTH, "txns_per_batch": TXNS, "card": smi}
    return launches, path


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "foundationdb_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    os.chdir(here)
    smi = toolchain()

    log("phase 2: kernels against their plain versions")
    cs, packed, buf = warmed_state()
    rows, programs = compare_kernels(cs, packed, buf)
    del cs, buf
    torch.cuda.empty_cache()

    log("phase 3: the main path")
    launches, path = main_path(smi)
    for row in rows:
        row["launches"] = launches[row["name"]]
    missing = [r["name"] for r in rows if r["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    print(json.dumps({"programs": programs, "path": path}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
