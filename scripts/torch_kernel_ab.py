#!/usr/bin/env python3
"""Time the port's redesigned kernels of one checkout on one NVIDIA GPU, at
the shapes the conflict path hands them.

  python3 scripts/torch_kernel_ab.py [--root DIR] [--label NAME]
      [--cases table,sort,fixpoint,merge,insert,probe,rwprep,prep,union,
               search,combine,codes,gprep,cstep,gstep,sharded,swindow,
               general,gc,gcodes]
      [--profile] [--sweep]

DIR (default: the checkout holding this script) is the checkout whose
foundationdb_tpu_torch package is timed; its kernels are built from its own
csrc/ into its own build/.  The inputs, the checks and the timing are this
checkout's chip_smoke.py:
  table     build_sparse_table at 2^18, 2^20, 2^21 (table_sizes);
  sort      sort_rows on (a) the config-3 universe of one batch, (b)
            random 32-byte digests, (c) rows sharing an 8-byte prefix, and
            the window path's endpoint sort (sort_inputs);
  fixpoint  interval_fixpoint on one config-3 batch against an empty
            history (general_fixpoint_inputs: U = 2^21) and on a 200-deep
            chain of ranges at config-3 width (general_deep_chain);
  merge     the merge at config 2's tiers (2^21 / 2^20, 1,000,001 and
            200,001 live rows) and at one config-5 shard's (2^20 / 2^18,
            250,001 and 60,001), synthetic sorted digests (merge_state);
  insert    the point insert at config 2's delta (2^20, 3,401 live rows,
            49,152 unique-key slots, 114,688 writes) and at a config-5
            shard's (2^18, 32,655 live rows, 196,608 slots, a quarter
            owned), window_insert at config 3's delta (2^20, 110,000 live
            rows, 65,536 writes, 55,000 valid) and on a 2^21 window
            (550,000 live rows), synthetic digests (insert_state,
            insert_at: own and whole-call device ms);
  probe     the range probes at their paths' shapes (PROBE_SHAPES,
            probe_state: synthetic sorted tiers built as insert_state
            builds them): history_probe at config 2 (2^21 / 2^20 tiers of
            9,765 and 3,343 live rows, 49,152 key slots), at config 3's
            general step (213,442 and 63,553 rows, 524,288 read slots,
            400,000 ranges of 1-100 records) and at a config-5 shard (2^20
            / 2^18, 97,495 and 32,305 rows, 196,608 slots, a quarter
            owned); window_query on config 3's 2^21 window (540,494 rows,
            400,000 ranges), on an empty shard of the sharded window (none
            of the 400,000 valid) and on a shard under spread traffic
            (110,000 rows, a quarter valid); with --sweep also
            history_probe at config 2's tiers with 256, 4,096 and 16,384
            key slots (its latency floor);
  rwprep    read_write_prep on config 2's warmed state and next batch
            (chip_smoke's warmed_state; the plain versions give its
            inputs): launches a call, own device ms, the whole call's
            (with the hist fill), plain ms, bound;
  prep      the compact step's unpacking chain at config 2 on the same
            batch: compact_prep (one cooperative launch, ib_unpack) where
            the package has it, else widen_unique, txn_prep (its two scans
            and three fills) and read_write_prep's t_cap hist fill;
            equality with the plain versions, launches a call by counter,
            own device ms (every counted launch), the whole chain's device
            ms behind the sleep, each kernel's and fill's profiler us;
  union     _union_ranges on config 3's delta shape (65,536 ranges of
            1-100 records, 55,000 valid; insert_state) and on one config-3
            batch's writes (the general step's 65,536 slots): launches a
            call by counter, own ms, the whole call's device ms, the sort's
            own, the call without the sort, plain ms, bound (union_at);
  search    (not in the default set) searchsorted where the general step
            calls it: the endpoint universe of one config-3 batch (its
            1,179,648 rows sorted by the plain sort, MAX padded to 2^21:
            endpoint_universe) and all of the batch's rows as queries,
            left side: one call over every row (own ms by counter, the
            whole call's device ms, plain ms, bound by search_bytes plus
            the queries and the output once) and the two calls a step
            made before it was one (the reads' endpoints, then the
            writes'), each equal to the plain version; and its own ms on
            the same queries sorted, on a 2^16 table and on one repeated
            query (where the time goes);
  combine   (not in the default set) shard_combine as the sharded compact
            step calls it at config 5: ShardedTorchConflictSet._combine
            of the four shards' hists (views into compact_prep's scratch,
            CompactStep.unpack with four hists) and of the reply tails
            (n_max 2): equality with the plain version, launches a call,
            own ms, the whole chain's device ms behind the sleep (any
            staging included) and its device operations a call by
            torch.profiler (the port's kernels, others);
  codes     (not in the default set) the compact step's resolve
            (CompactStep.resolve: the fixpoint and the verdict codes, as
            this package runs them) on the history bits of config 2's
            warmed state's next batch and on the combined bits of config
            5's four shards (warm_sharded), the inputs from the plain
            versions: equality of the codes and the insert mask with the
            plain versions', launches a call by counter, own device ms
            (the fixpoint's and any codes kernel's launches), the whole
            call's device ms behind the sleep, its device operations a
            call by torch.profiler (the port's kernels, others) and each
            one's us;
  gprep     (not in the default set) general_prep on config 3's warmed
            state's next batch (warmed_general_state; each read's history
            maximum from the plain probe), timed the same way, with its
            least bytes;
  cstep     (not in the default set) program #1, the compact step, on
            config 2's warmed state and its next batch, timed as gstep;
  gstep     (not in the default set) program #4, the general step, on
            chip_smoke's warmed config-3 state and its next batch
            (warmed_general_state), bit-equal to its plain version: the
            whole call behind the sleep, on the timeline, and on device
            time alone by torch.profiler (profiled_step);
  sharded   (not in the default set) program #8's sharded compact step at
            config 5 (four shards on the card, chip_smoke's warm_sharded
            after 4 batches and a merge), bit-equal to its plain version,
            then its device time by torch.profiler: each kernel's duration
            summed a call (no host time), per kernel and in all, the
            state's restore taken out (profiled_step);
  swindow   (not in the default set) program #9's ShardedWindow step on
            config 3's sixth batch after five, timed the same way;
  gc        (not in the default set) program #7, window_gc, on
            chip_smoke's config-3 window (the five batches of
            warmed_general_state) at the sixth batch's floor (no row
            moves) and 3,000 versions above it, and on a synthetic 2^21
            window with drops in every chunk (chip_smoke's gc_at: own ms,
            the whole call's device ms behind the sleep, plain ms, bound
            by gc_bytes), the state restored before every call; at the
            first also the device operations a call by torch.profiler,
            the timeline and the device time alone per kernel and copy
            (profiled_step); and program #9's gc, ShardedWindow.gc over
            the four shards of the sharded window on the same batches:
            the sum of its own kernels' times (kernel_sum_ms),
            profiled_step, the timeline, bound;
  gcodes    (not in the default set) the general step's fixpoint and
            codes on config 3's warmed state's next batch: the fixpoint
            with its codes in one launch where the checkout has it, else
            interval_fixpoint then general_codes' kernel; timed as codes,
            with the fixpoint alone's own ms;
  general   (not in the default set) the config-3 general path through
            TorchConflictSet (chip_smoke's general_path): ranges/s at
            depth 8, p50 resolve and packing, to compare a host-bound
            path's end-to-end figures between checkouts on one card.
So two commits are compared on one card by running this once per
checkout on that card, in turns (parent, change, change, parent).  Prints
one JSON line: each case's launches a call, own device time, plain time,
bound and equality with the plain version (any difference fails the
run), and the launch floor: the device time of a one-element fill_
between CUDA events behind the stream's sleep, as every own time is
taken (chip_smoke.py device_ms).  With
--profile it adds, under "profile", each kernel's mean device time and
launches per call by torch.profiler, for the chosen cases (the table at
2^21, each sort input, the config-3 fixpoint, the config-2 merge, each
insert and probe shape, the union at config 3's delta shape), and the time of a copy_ of the universe's rows
(the bytes of one sort pass: a floor for a pass).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = None  # this checkout's chip_smoke.py, loaded by main()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--cases", default="table,sort,fixpoint,merge,insert")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    cases = set(args.cases.split(","))
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    S = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(S)
    global SMOKE
    SMOKE = S
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
    assert K.CSRC.startswith(root), K.CSRC
    K.build()
    from foundationdb_tpu_torch.conflict import fused
    from foundationdb_tpu_torch.ops.rangemax import NEG_INF
    _, enc, _ = S.make_stream3(np.random.default_rng(17), 1)[0]
    packed = TorchConflictSet._pack(enc)
    t_cap, r_cap, w_cap = packed["caps"]
    n_rows = 2 * (r_cap + w_cap)
    buf = torch.from_numpy(packed["buf"]).to(S.DEVICE)
    universe = buf[:32 * n_rows].view(torch.int32).view(n_rows, 8).clone()
    out = {"label": args.label, "root": os.path.relpath(root, HERE)}
    if "table" in cases:
        out["build_sparse_table"] = S.table_sizes()
    if "sort" in cases:
        out["sort_rows"] = S.sort_inputs(universe, r_cap, w_cap,
                                         enc.w_txn.shape[0])
    m = fused.unpack_meta(buf[32 * n_rows:].view(torch.int32), t_cap, r_cap,
                          w_cap)
    vmax = torch.full((r_cap,), NEG_INF, dtype=torch.int32, device=S.DEVICE)
    _, fix_in, log_u = S.general_fixpoint_inputs(universe, m, vmax)
    merges = {"config2": (1 << 21, 1 << 20, 1_000_000, 200_000),
              "config5_shard": (1 << 20, 1 << 18, 250_000, 60_000)}
    if "fixpoint" in cases:
        out["interval_fixpoint"] = {
            "config3": fixpoint_case(S, K, fused, fix_in, log_u),
            "deep_chain": S.general_deep_chain(fused, t_cap, r_cap, w_cap,
                                               log_u)}
    if "merge" in cases:
        out["merge"] = [
            S.merge_at(what, S.merge_state(cap, d_cap, n_b, n_d), cap,
                       d_cap, (2500, 1000), expect_launches=None, reps=20)
            for what, (cap, d_cap, n_b, n_d) in merges.items()]
    if "insert" in cases:
        out["insert"] = [
            S.insert_at(what, kind, *S.insert_state(kind, *shape, **kw),
                        expect_launches=False, reps=20)
            for what, kind, shape, kw in INSERTS]
    if "probe" in cases:
        out["probe"] = [S.probe_case(r[0], reps=20) for r in S.PROBE_SHAPES]
        if args.sweep:
            out["probe_sweep"] = probe_sweep(S)
    if "rwprep" in cases:
        out["read_write_prep"] = rwprep_case(S, K, fused)
    if "prep" in cases:
        out["prep"] = prep_case(S, K, fused)
    if "union" in cases:
        w_b = universe[2 * r_cap:2 * r_cap + w_cap]
        w_e = universe[2 * r_cap + w_cap:]
        _, (d_b, d_e, d_valid, _) = S.insert_state("window", *INSERTS[2][2])
        out["union_ranges"] = [
            S.union_at(what, b, e, v, expect_launches=False, reps=20)
            for what, b, e, v in (("config3_delta", d_b, d_e, d_valid),
                                  ("config3_batch", w_b, w_e,
                                   m["w_valid"]))]
    if "search" in cases:
        out["searchsorted"] = search_case(S, K, universe, r_cap)
    if "combine" in cases:
        out["shard_combine"] = combine_case(S, K, fused)
    if "codes" in cases:
        out["resolve"] = codes_case(S, K, fused)
    if "gprep" in cases:
        out["general_prep"] = gprep_case(S, K, fused)
    if "cstep" in cases:
        out["compact_step"] = cstep_case(S, fused)
    if "gstep" in cases:
        out["general_step"] = gstep_case(S, fused)
    if "gc" in cases:
        out["window_gc"] = gc_case(S, K)
    if "gcodes" in cases:
        out["general_codes"] = gcodes_case(S, K, fused)
    if "sharded" in cases:
        out["sharded_step"] = sharded_case(S)
    if "swindow" in cases:
        out["sharded_window_step"] = swindow_case(S)
    one = torch.zeros((1,), dtype=torch.int32, device=S.DEVICE)
    out["launch_floor_ms"] = S.device_ms(lambda: one.fill_(0), reps=50)
    if "general" in cases:
        with contextlib.redirect_stdout(sys.stderr):
            _, path, _ = S.general_path("")
        out["general_path"] = {k: path[k] for k in (
            "ranges_per_s", "p50_resolve_ms", "p50_pack_ms", "commit_rate")}
    if args.profile:
        cap, d_cap, n_b, n_d = merges["config2"]
        out["profile"] = profile(S, universe, r_cap, w_cap,
                                 enc.w_txn.shape[0], fix_in, log_u,
                                 S.merge_state(cap, d_cap, n_b, n_d)
                                 if "merge" in cases else None, cases)
    out["gpu"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


# insert_state's shapes: (what, kind, (cap, live rows, ranges, valid),
# keyword arguments).
INSERTS = [
    ("config2", "point", (1 << 20, 3_401, 0, 45_000),
     {"u_pad": 49_152, "w_pad": 114_688}),
    ("config5_shard", "point", (1 << 18, 32_655, 0, 190_000),
     {"u_pad": 196_608, "w_pad": 65_536, "owned": 0.25}),
    ("config3_delta", "window", (1 << 20, 110_000, 65_536, 55_000), {}),
    ("window_2_21", "window", (1 << 21, 550_000, 65_536, 55_000), {}),
]


# Key slots the sweep times config 2's history probe at (its latency
# floor).
PROBE_SLOTS = (256, 4_096, 16_384)


def probe_sweep(S, reps: int = 20) -> list:
    """history_probe at config 2's tiers with fewer key slots
    (PROBE_SLOTS): own ms, equality checked each time."""
    result = []
    for slots in PROBE_SLOTS:
        name, path, fn, n_bytes, info = S.probe_inputs("config2", slots)
        row = S.probe_at(f"config2 slots={slots}", name, path, fn, n_bytes,
                         reps=reps, **info)
        result.append({"slots": slots, "ms": row["ms"]})
    return result


def rwprep_case(S, K, fused, reps: int = 20) -> dict:
    """read_write_prep at config 2: on chip_smoke's warmed state and its
    next batch, the inputs from the plain versions of the blocks before it
    (as compare_kernels builds them)."""
    import torch
    from foundationdb_tpu_torch.ops import digest
    cs, packed, buf = S.warmed_state()
    t_cap, r_pad, w_pad, u_pad, lw = packed["shapes"]
    lay = fused.compact_layout(t_cap, r_pad, w_pad, u_pad, lw)
    b32 = buf.view(torch.int32)

    def i32(name, n):
        return b32[lay[name] // 4:lay[name] // 4 + n]

    ub = buf[lay["ubytes"]:lay["ubytes"] + u_pad * lw]
    scal = i32("scalars", fused.COMPACT_SCALARS)
    t_snap = i32("t_snap", t_cap)
    P = "plain"
    u_b, u_e = digest.widen_unique(ub, scal, lw, u_pad, P)
    too_old, r_cnt, w_cnt = fused.txn_prep(
        i32("r_start", t_cap), i32("w_start", t_cap), t_snap,
        buf[lay["t_flags"]:lay["t_flags"] + t_cap], scal, r_pad, w_pad, P)
    vmax = digest.history_probe(cs.bk, cs.table, cs.dk, cs.dtable, u_b, u_e,
                                P)
    args = (i32("r_uid", r_pad), i32("w_uid", w_pad), r_cnt, w_cnt, too_old,
            t_snap, scal, vmax, u_pad)

    def run(impl=None):
        return fused.read_write_prep(*args, impl=impl)

    K.reset_counts()
    got = run()
    launches = K.LAUNCHES["read_write_prep"]
    want = run(P)
    err = S.require_equal("read_write_prep", got, want)
    return {"shapes": [t_cap, r_pad, w_pad, u_pad],
            "launches_per_call": launches, "max_abs_err": err,
            "ms": S.device_ms(run, reps=reps, counter="read_write_prep"),
            "call_ms": S.device_ms(run, reps=reps),
            "plain_ms": S.cuda_ms(lambda: run(P), reps=2),
            "bound_ms": S.bound_ms(S.nbytes(*args[:6], vmax,
                                            *want.values()))}


def prep_case(S, K, fused, reps: int = 20) -> dict:
    """The compact step's unpacking chain at config 2 on chip_smoke's
    warmed state's next batch, as this package runs it: compact_prep with
    one hist, or (a package without it) widen_unique, txn_prep and
    read_write_prep's hist fill.  Both are checked against the plain
    versions of widen_unique and txn_prep."""
    import torch
    from foundationdb_tpu_torch.ops import digest
    _, packed, buf = S.warmed_state()
    t_cap, r_pad, w_pad, u_pad, lw = packed["shapes"]
    lay = fused.compact_layout(t_cap, r_pad, w_pad, u_pad, lw)
    b32 = buf.view(torch.int32)

    def i32(name, n):
        return b32[lay[name] // 4:lay[name] // 4 + n]

    ub = buf[lay["ubytes"]:lay["ubytes"] + u_pad * lw]
    scal = i32("scalars", fused.COMPACT_SCALARS)
    txn_in = (i32("r_start", t_cap), i32("w_start", t_cap),
              i32("t_snap", t_cap),
              buf[lay["t_flags"]:lay["t_flags"] + t_cap], scal)
    P = "plain"
    want = (*digest.widen_unique(ub, scal, lw, u_pad, P),
            *fused.txn_prep(*txn_in, r_pad, w_pad, P))
    if hasattr(fused, "compact_prep"):
        prep_in = (ub, *txn_in, lw, u_pad, r_pad, w_pad)

        def chain():
            p = fused.compact_prep(*prep_in)
            return (p["u_b"], p["u_e"], p["too_old"], p["r_cnt"],
                    p["w_cnt"], *p["hists"])

        counters = ("compact_prep",)
    else:
        def chain():
            return (*digest.widen_unique(ub, scal, lw, u_pad),
                    *fused.txn_prep(*txn_in, r_pad, w_pad),
                    torch.zeros((t_cap,), dtype=torch.int32,
                                device=buf.device))

        counters = ("widen_unique", "txn_prep", "inclusive_scan")
    K.reset_counts()
    got = chain()
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    err = S.require_equal("prep", got[:5], want)
    if got[5].any():
        raise AssertionError("prep: the hist is not zeroed")
    return {"shapes": [t_cap, r_pad, w_pad, u_pad, lw],
            "launches_per_call": launches, "max_abs_err": err,
            "ms": S.device_ms(chain, reps=reps, counter=counters),
            "chain_ms": S.device_ms(chain, reps=reps),
            "profile_us": device_us(chain, 10)}


def search_case(S, K, digests, r_cap: int, reps: int = 20) -> dict:
    """searchsorted at the general step's shape (the `search` case), and
    where its time goes: the same queries in the universe's own order (the
    searches' paths coalesce), random rows of a 2^16 table built from the
    universe's live rows (the table sits in L2) and one repeated query
    (every load a broadcast), each own ms and equal to the plain
    version."""
    import torch
    from foundationdb_tpu_torch.ops import digest
    table = S.endpoint_universe(digests)
    n = digests.shape[0]
    live = int((table != -1).any(dim=1).sum())
    g = torch.Generator(device=S.DEVICE).manual_seed(3)
    small = table[torch.sort(torch.randint(
        0, live, (1 << 16,), device=S.DEVICE, generator=g)).values]
    shapes = {}
    for what, (t, q) in {
            "sorted_queries": (table, table[:n].contiguous()),
            "table_2^16": (small, small[torch.randint(
                0, 1 << 16, (n,), device=S.DEVICE, generator=g)]),
            "one_query": (table, digests[5:6].expand(n, 8).contiguous())
            }.items():
        S.require_equal(f"searchsorted {what}",
                        digest.searchsorted(t, q, True),
                        digest.searchsorted(t, q, True, impl="plain"))
        shapes[what] = S.device_ms(
            lambda t=t, q=q: digest.searchsorted(t, q, True), reps=reps,
            counter="searchsorted")

    def one():
        return digest.searchsorted(table, digests, True)

    def two():
        return torch.cat([digest.searchsorted(table, digests[:2 * r_cap],
                                              True),
                          digest.searchsorted(table, digests[2 * r_cap:],
                                              True)])

    want = digest.searchsorted(table, digests, True, impl="plain")
    K.reset_counts()
    got = one()
    launches = K.LAUNCHES["searchsorted"]
    err = max(S.require_equal("searchsorted", got, want),
              S.require_equal("searchsorted in two calls", two(), want))
    return {"table_rows": table.shape[0], "live_rows": live, "queries": n,
            "at_shapes_ms": shapes,
            "launches_per_call": launches, "max_abs_err": err,
            "ms": S.device_ms(one, reps=reps, counter="searchsorted"),
            "two_calls_ms": S.device_ms(two, reps=reps,
                                        counter="searchsorted"),
            "call_ms": S.device_ms(one, reps=reps),
            "plain_ms": S.cuda_ms(lambda: digest.searchsorted(
                table, digests, True, impl="plain"), reps=2),
            "bound_ms": S.bound_ms(S.search_bytes(table, n)
                                   + S.nbytes(digests, want)),
            "profile_us": device_us(one, 10)}


def combine_case(S, K, fused, reps: int = 20) -> dict:
    """shard_combine as the sharded compact step calls it (the `combine`
    case): the hists' combine and the tails'."""
    import torch
    rng5 = np.random.default_rng(5055)
    splits5 = S.config5_splits(rng5)
    _, enc, *_ = S.make_stream5(rng5, 1)[0]
    cs = S.sharded_backend(splits5)
    packed = cs._pack(enc)
    buf = torch.from_numpy(packed["buf"]).to(S.DEVICE)
    step = fused.make_resolve_step_compact(cs.capacity, cs.d_cap,
                                           *packed["shapes"])
    hists = step.unpack(buf, S.N_SHARDS)["hists"]
    g = torch.Generator(device=S.DEVICE).manual_seed(11)
    for h in hists:
        h.copy_(torch.randint(0, 2, h.shape, generator=g, device=S.DEVICE,
                              dtype=torch.int32))
    tails = [torch.randint(0, 1 << 30, (3,), generator=g, device=S.DEVICE,
                           dtype=torch.int32) for _ in hists]
    tail_out = torch.empty((3,), dtype=torch.int32, device=S.DEVICE)
    from foundationdb_tpu_torch.ops.shard import shard_combine
    result = {"t_cap": hists[0].shape[0], "shards": len(hists)}
    for what, fn, want in (
            ("hists", lambda: cs._combine(hists),
             shard_combine(torch.stack(hists), impl="plain")),
            ("tails", lambda: cs._combine(tails, n_max=2, out=tail_out),
             shard_combine(torch.stack(tails), 2, impl="plain"))):
        K.reset_counts()
        got = fn()
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        err = S.require_equal(f"shard_combine {what}", got, want)
        kernels, others = S.device_ops(fn)
        result[what] = {
            "launches_per_call": launches, "max_abs_err": err,
            "kernels_per_call": kernels, "other_ops_per_call": others,
            "ms": S.device_ms(fn, reps=reps, counter="shard_combine"),
            "chain_ms": S.device_ms(fn, reps=reps),
            "profile_us": device_us(fn, 10)}
    return result


# chip_smoke's warmed states, each built once a run (the cases read them
# or restore copies of them).
_WARM = {}


def warm(S, name: str):
    if name not in _WARM:
        _WARM[name] = {"config2": S.warmed_state,
                       "config3": S.warmed_general_state}[name]()
    return _WARM[name]


def call_row(S, K, name: str, run, want, counters, n_bytes: int,
             reps: int = 20) -> dict:
    """One call of a chain of this package's kernels (run(impl)), against
    its plain outputs `want`: launches a call by counter, own device ms
    (the launches under `counters`, and under each alone), the whole call's device ms behind the
    sleep, device operations a call by torch.profiler and each one's us,
    plain ms, bound."""
    K.reset_counts()
    got = run()
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    err = S.require_equal(name, got, want)
    kernels, others = S.device_ops(run)
    names = (counters,) if isinstance(counters, str) else counters
    return {"launches_per_call": launches, "max_abs_err": err,
            "kernels_per_call": kernels, "other_ops_per_call": others,
            "ms": S.device_ms(run, reps=reps, counter=counters),
            "ms_by_counter": {n: S.device_ms(run, reps=reps, counter=n)
                              for n in names if launches.get(n)},
            "chain_ms": S.device_ms(run, reps=reps),
            "profile_us": device_us(run, 10),
            "plain_ms": S.cuda_ms(lambda: run("plain"), reps=2),
            "bound_ms": S.bound_ms(n_bytes)}


def resolve_row(S, K, fused, cap: int, d_cap: int, shapes, h: dict,
                hist) -> dict:
    """CompactStep.resolve on one batch's history bits `hist` and its
    history dict `h` (from the plain versions)."""
    import torch
    t_cap = shapes[0]
    steps = {impl: fused.make_resolve_step_compact(cap, d_cap, *shapes,
                                                   impl=impl)
             for impl in (None, "plain")}

    def run(impl=None):
        out = torch.empty((t_cap + fused.OUT_EXTRA,), dtype=torch.int8,
                          device=S.DEVICE)
        w_ins = steps[impl].resolve(h, hist, out)
        return w_ins, out[:t_cap]

    rw = h["rw"]
    want = run("plain")
    n_bytes = S.nbytes(hist, *(rw[k] for k in (
        "r_txn", "r_live", "r_slot", "w_txn", "w_ok", "w_slot")),
        h["too_old"], *want) + 4 * t_cap  # + conf
    row = call_row(S, K, "resolve", run, want,
                   ("intra_batch_fixpoint", "batch_codes"), n_bytes)
    row["shapes"] = list(shapes)
    return row


def codes_case(S, K, fused) -> dict:
    """The compact step's resolve (the `codes` case) at config 2 and on
    config 5's combined bits."""
    import torch
    from foundationdb_tpu_torch.ops.shard import shard_combine
    P = "plain"
    cs, packed, buf = warm(S, "config2")
    shapes = packed["shapes"]
    h = fused.make_resolve_step_compact(S.CAPACITY, cs.d_cap, *shapes,
                                        impl=P).history(
        cs.bk, cs.table, cs.dk, cs.dtable, buf)
    result = {"config2": resolve_row(S, K, fused, S.CAPACITY, cs.d_cap,
                                     shapes, h, h["rw"]["hist"])}
    rng5 = np.random.default_rng(5055)
    splits5 = S.config5_splits(rng5)
    cs5, _, packed5, _ = S.warm_sharded(
        splits5, S.make_stream5(rng5, 5), S.CONFIG5_CAPACITY // S.N_SHARDS,
        S.CONFIG5_DELTA // S.N_SHARDS)
    shapes5 = packed5["shapes"]
    step = fused.make_resolve_step_compact(cs5.capacity, cs5.d_cap, *shapes5,
                                           impl=P)
    buf5 = torch.from_numpy(packed5["buf"]).to(S.DEVICE)
    hs = [step.history(sh.bk, sh.table, sh.dk, sh.dtable, buf5, sh.bounds)
          for sh in cs5.shards]
    hist = shard_combine(torch.stack([x["rw"]["hist"] for x in hs]),
                         impl=P)
    result["config5"] = resolve_row(S, K, fused, cs5.capacity, cs5.d_cap,
                                    shapes5, hs[0], hist)
    return result


def gprep_case(S, K, fused) -> dict:
    """general_prep at config 3 (the `gprep` case)."""
    import torch
    from foundationdb_tpu_torch.ops import digest
    cs, packed, _, _ = warm(S, "config3")
    t_cap, r_cap, w_cap = packed["caps"]
    n_rows = 2 * (r_cap + w_cap)
    buf = torch.from_numpy(packed["buf"]).to(S.DEVICE)
    digests = buf[:32 * n_rows].view(torch.int32).view(n_rows, 8)
    m = fused.unpack_meta(buf[32 * n_rows:].view(torch.int32), t_cap, r_cap,
                          w_cap)
    vmax = digest.history_probe(cs.bk, cs.table, cs.dk, cs.dtable,
                                digests[:r_cap], digests[r_cap:2 * r_cap],
                                "plain")

    def run(impl=None):
        return fused.general_prep(m, vmax, impl)

    want = run("plain")
    n_bytes = S.nbytes(*(m[k] for k in (
        "r_txn", "r_valid", "w_txn", "w_valid", "t_snap", "t_has_reads",
        "t_valid")), vmax, *want.values())
    row = call_row(S, K, "general_prep", run, want, "general_prep", n_bytes)
    row.update(caps=[t_cap, r_cap, w_cap],
               hist_bits=int(want["hist"].sum()),
               too_old=int(want["too_old"].sum()))
    return row


def gc_case(S, K) -> dict:
    """window_gc (the `gc` case) on chip_smoke's config-3 window (the five
    batches of warmed_general_state) at the sixth batch's floor (no row
    moves) and 3,000 versions above it (the first three batches' rows
    dropped), and on a synthetic 2^21 window with drops in every chunk
    (chip_smoke's gc_at and gc_synthetic); at the first, the device
    operations a call and the device time alone by torch.profiler per
    kernel and copy; and ShardedWindow.gc over the four shards of the
    sharded window on the same batches (kr=4, 2^21 a shard; shard 0 holds
    every row), the state restored before every call."""
    import torch
    from foundationdb_tpu_torch.conflict import window
    from foundationdb_tpu_torch.parallel import ShardedWindow
    _, _, win, stream = warm(S, "config3")
    fl = S.floor(stream[5][0])
    rows = [S.gc_at("config3_window", win, fl, fl, reps=20),
            S.gc_at("config3_window_floor_plus_3000", win, fl + 3000,
                    fl + 3000, reps=20),
            S.gc_at("synthetic_2_21", S.gc_synthetic(
                S.CAPACITY, S.CAPACITY - 12_345, 5000), 5000, 1234, reps=20)]
    saved = tuple(t.clone() for t in win)
    st = tuple(t.clone() for t in win)

    def load():
        for t, x in zip(st, saved):
            t.copy_(x)

    def run(impl=None):
        return tuple(window.window_gc(window.WindowState(*st), fl, fl,
                                      impl=impl))

    kernels, others = S.device_ops(run)
    rows[0].update(kernels_per_call=kernels, other_ops_per_call=others,
                   timeline_ms=S.cuda_ms(run, reps=20, setup=load),
                   bound_ms_whole_state=S.bound_ms(2 * S.nbytes(*saved[:2])))
    rows[0].update(profiled_step(run, load))
    del st, saved
    stream3 = S.make_stream3(np.random.default_rng(17), 6)
    wins = [ShardedWindow(S.shard_mesh(), S.CAPACITY, impl=i)
            for i in (None, "plain")]
    for v, enc, _ in stream3[:5]:
        wins[0].resolve_step(*S.window_inputs(enc, 0), v)
    torch.cuda.synchronize()
    wsaved = [tuple(t.clone() for t in x) for x in wins[0].shard_states()]
    sizes = [int(x[2][0]) for x in wsaved]
    bound = sum(S.gc_bytes(window.WindowState(*x), fl, fl) for x in wsaved)

    def wload(w):
        for x, sv in zip(w.shard_states(), wsaved):
            for t, y in zip(x, sv):
                t.copy_(y)

    def wrun(w):
        w.gc(fl, fl)
        return tuple(t for x in w.shard_states() for t in x)

    wload(wins[0])
    wload(wins[1])
    err = S.require_equal("sharded_gc", wrun(wins[0]), wrun(wins[1]))
    sharded = {"max_abs_err": err, "sizes": sizes,
               "kernel_sum_ms": S.kernel_sum_ms(lambda: wrun(wins[0]),
                                                reps=20,
                                                setup=lambda: wload(wins[0])),
               "timeline_ms": S.cuda_ms(lambda: wrun(wins[0]), reps=20,
                                        setup=lambda: wload(wins[0])),
               "bound_ms": S.bound_ms(bound)}
    sharded.update(profiled_step(lambda: wrun(wins[0]),
                                 lambda: wload(wins[0])))
    return {"window": rows, "sharded_window": sharded}


def gcodes_case(S, K, fused) -> dict:
    """The general step's fixpoint and codes (the `gcodes` case) on config
    3's warmed state's next batch (the inputs from the plain versions):
    interval_fixpoint with its codes where the package has them, else the
    fixpoint and general_codes' kernel; and the fixpoint alone."""
    import inspect
    import torch
    from foundationdb_tpu_torch.ops import digest
    cs, packed, _, _ = warm(S, "config3")
    t_cap, r_cap, w_cap = packed["caps"]
    n_rows = 2 * (r_cap + w_cap)
    buf = torch.from_numpy(packed["buf"]).to(S.DEVICE)
    digests = buf[:32 * n_rows].view(torch.int32).view(n_rows, 8)
    m = fused.unpack_meta(buf[32 * n_rows:].view(torch.int32), t_cap, r_cap,
                          w_cap)
    vmax = digest.history_probe(cs.bk, cs.table, cs.dk, cs.dtable,
                                digests[:r_cap], digests[r_cap:2 * r_cap],
                                "plain")
    g, fix_in, log_u = S.general_fixpoint_inputs(digests, m, vmax)
    fused_codes = "codes_out" in inspect.signature(
        fused.interval_fixpoint).parameters

    def run(impl=None):
        codes = torch.empty((t_cap,), dtype=torch.int8, device=S.DEVICE)
        if fused_codes:
            conf, rounds, w_ins = fused.interval_fixpoint(
                *fix_in, log_u, impl=impl, codes_out=codes,
                t_valid=m["t_valid"], too_old=g["too_old"],
                w_valid=m["w_valid"])
        else:
            conf, rounds = fused.interval_fixpoint(*fix_in, log_u, impl=impl)
            w_ins = fused.general_codes(m["t_valid"], g["too_old"], conf,
                                        m["w_txn"], m["w_valid"], codes,
                                        impl)
        return conf, rounds, w_ins, codes

    want = run("plain")
    n_bytes = S.nbytes(*fix_in, m["t_valid"], g["too_old"], m["w_valid"],
                       *want)
    row = call_row(S, K, "gcodes", run, want,
                   ("interval_fixpoint", "general_codes"), n_bytes)
    row.update(fused=fused_codes, rounds=int(want[1][0]),
               alone_ms=S.device_ms(
                   lambda: fused.interval_fixpoint(*fix_in, log_u), reps=20,
                   counter="interval_fixpoint"))
    return row


def program_row(S, name: str, run, load, reps: int = 20) -> dict:
    """A one-device program run(impl) on a warmed state that load()
    restores, bit-equal to its plain version: its device time alone by
    torch.profiler (profiled_step), behind the sleep and on the
    timeline."""
    load()
    got = tuple(t.clone() for t in run())
    load()
    err = S.require_equal(name, got, run("plain"))
    row = profiled_step(run, load)
    row.update(max_abs_err=err,
               device_ms=S.device_ms(run, reps=reps, setup=load),
               timeline_ms=S.cuda_ms(run, reps=reps, setup=load))
    return row


STATE_KEYS = ("bk", "bv", "table", "size", "dk", "dv", "dtable", "dsize",
              "flag")


def saved_state(cs):
    """A copy of a backend's state, a working copy and its restore."""
    saved = {k: getattr(cs, k).clone() for k in STATE_KEYS}
    st = {k: v.clone() for k, v in saved.items()}

    def load():
        for k in STATE_KEYS:
            st[k].copy_(saved[k])

    return st, load


def cstep_case(S, fused) -> dict:
    """Program #1 on the warmed config-2 state (the `cstep` case)."""
    cs, packed, buf = warm(S, "config2")
    st, load = saved_state(cs)

    def run(impl=None):
        step = fused.make_resolve_step_compact(S.CAPACITY, cs.d_cap,
                                               *packed["shapes"], impl=impl)
        return step(*(st[k] for k in STATE_KEYS), buf)

    return program_row(S, "compact_step", run, load)


def gstep_case(S, fused) -> dict:
    """Program #4 on a warmed config-3 state (the `gstep` case)."""
    import torch
    cs, packed, _, _ = warm(S, "config3")
    t_cap, r_cap, w_cap = packed["caps"]
    n_rows = 2 * (r_cap + w_cap)
    buf = torch.from_numpy(packed["buf"]).to(S.DEVICE)
    digests = buf[:32 * n_rows].view(torch.int32).view(n_rows, 8)
    meta = buf[32 * n_rows:].view(torch.int32)
    st, load = saved_state(cs)

    def run(impl=None):
        step = fused.make_resolve_step(S.CAPACITY, cs.d_cap, t_cap, r_cap,
                                       w_cap, impl=impl)
        return step(*(st[k] for k in STATE_KEYS), digests, meta)

    return program_row(S, "general_step", run, load)


def kernel_key(key: str) -> str:
    """A profiler key as a short name: the port's kernels by their name
    (k_...), others by their first 80 characters."""
    name = SMOKE.kernel_name(key)
    return name if name.startswith("k_") else key[:80]


def device_us(fn, calls: int) -> dict:
    """Microseconds of device activity a call of fn() by torch.profiler
    (chip_smoke's profile_calls), per kernel (kernel_key) and copy, each
    one's durations summed."""
    out = {}
    for key, (_, us) in SMOKE.profile_calls(fn, calls).items():
        k = kernel_key(key)
        out[k] = out.get(k, 0.0) + us / calls
    return out


def profiled_step(step, load, calls: int = 10) -> dict:
    """A sharded program's device time a call, without host time: the
    profiler's per-kernel durations of `calls` (load, step) pairs less
    those of `calls` loads alone (load restores the state).  Returns the
    total, the port's kernels' sum (k_...) and each entry in us."""
    step()
    both = device_us(lambda: (load(), step()), calls)
    alone = device_us(load, calls)
    per = {k: round(v - alone.get(k, 0.0), 3) for k, v in both.items()
           if v - alone.get(k, 0.0) > 1e-3}
    return {"device_us": round(sum(per.values()), 3),
            "kernels_us": round(sum(v for k, v in per.items()
                                    if k.startswith("k_")), 3),
            "per_kernel_us": per}


def sharded_case(S) -> dict:
    """Program #8's sharded compact step at config 5 on chip_smoke's warmed
    state: bit-equal to the plain version, then profiled_step, with
    read_write_prep's kernels' share (k_rw_prep; k_read_prep + k_write_prep
    before it) and the unpacking's (k_unpack; k_widen, k_txn_prep and
    k_scan before it), torch's fills not counted."""
    import torch
    rng5 = np.random.default_rng(5055)
    splits5 = S.config5_splits(rng5)
    stream5 = S.make_stream5(rng5, 5)
    cs, plain, packed, saved = S.warm_sharded(
        splits5, stream5, S.CONFIG5_CAPACITY // S.N_SHARDS,
        S.CONFIG5_DELTA // S.N_SHARDS)
    host_buf = torch.from_numpy(packed["buf"]).pin_memory()

    def run(c):
        out, _ = c._run_step(packed, host_buf)
        return (out,) + S.shard_tensors(c)

    S.load_shards(cs, saved)
    S.load_shards(plain, saved)
    err = S.require_equal("sharded_step", run(cs), run(plain))
    row = profiled_step(lambda: run(cs), lambda: S.load_shards(cs, saved))
    def share(names):
        return sum(v for k, v in row["per_kernel_us"].items()
                   if k.split("<")[0] in names)

    rw = share(("k_rw_prep", "k_read_prep", "k_write_prep"))
    unpack = share(("k_unpack", "k_widen", "k_txn_prep", "k_scan"))
    row.update(max_abs_err=err, read_write_prep_us=round(rw, 3),
               read_write_prep_share=round(rw / row["device_us"], 4),
               unpack_kernels_us=round(unpack, 3),
               unpack_share=round(unpack / row["device_us"], 4))
    return row


def swindow_case(S) -> dict:
    """Program #9's ShardedWindow step (kr=4, 2^21 boundaries a shard) on
    config 3's sixth batch after five, as chip_smoke's compare_sharded
    times it: bit-equal to the plain version, then profiled_step, with
    _union_ranges' kernels but the sort's (k_endpoints, k_sweep; k_marks,
    k_scan, k_compact before) and their share."""
    import torch
    from foundationdb_tpu_torch.parallel import ShardedWindow
    stream3 = S.make_stream3(np.random.default_rng(17), 6)
    wins = [ShardedWindow(S.shard_mesh(), S.CAPACITY, impl=i)
            for i in (None, "plain")]
    for v, enc, _ in stream3[:5]:
        wins[0].resolve_step(*S.window_inputs(enc, 0), v)
    torch.cuda.synchronize()
    saved = [tuple(t.clone() for t in st) for st in wins[0].shard_states()]
    v5, enc5, _ = stream3[5]
    inputs = S.window_inputs(enc5, 0)

    def load(w):
        for st, sv in zip(w.shard_states(), saved):
            for t, x in zip(st, sv):
                t.copy_(x)

    def run(w):
        bits, ovf = w.resolve_step(*inputs, v5)
        return (bits, ovf) + tuple(t for st in w.shard_states() for t in st)

    load(wins[0])
    load(wins[1])
    err = S.require_equal("sharded_window_step", run(wins[0]), run(wins[1]))
    row = profiled_step(lambda: run(wins[0]), lambda: load(wins[0]))
    union = sum(v for k, v in row["per_kernel_us"].items()
                if k.split("<")[0] in ("k_endpoints", "k_sweep", "k_marks",
                                       "k_scan", "k_compact"))
    row.update(max_abs_err=err, union_but_sort_kernels_us=round(union, 3),
               union_share=round(union / row["device_us"], 4))
    return row


def fixpoint_case(S, K, fused, fix_in, log_u: int, reps: int = 20) -> dict:
    """interval_fixpoint on one batch's inputs: launches a call, rounds,
    equality with the plain version, own device ms, plain ms, bound."""
    K.reset_counts()
    conf, rounds = fused.interval_fixpoint(*fix_in, log_u)
    launches = sum(K.LAUNCHES.values())
    want = fused.interval_fixpoint(*fix_in, log_u, impl="plain")
    err = S.require_equal("interval_fixpoint", (conf, rounds), want)
    return {"log_u": log_u, "rounds": int(rounds[0]),
            "launches_per_call": launches, "max_abs_err": err,
            "ms": S.device_ms(lambda: fused.interval_fixpoint(*fix_in, log_u),
                              reps=reps, counter="interval_fixpoint"),
            "plain_ms": S.cuda_ms(lambda: fused.interval_fixpoint(
                *fix_in, log_u, impl="plain"), reps=2),
            "bound_ms": S.bound_ms(S.nbytes(*fix_in, conf))}


def profile(S, universe, r_cap: int, w_cap: int, n_writes: int, fix_in,
            log_u: int, merge_in: dict, chosen: set,
            calls: int = 5) -> dict:
    """Per-kernel device time (mean microseconds a launch) and launches a
    call, by torch.profiler over `calls` calls of each case of the chosen
    kinds (table, sort, fixpoint, merge, insert, probe, union; for the
    union every device kernel of the call, torch's fills included)."""
    import torch
    from foundationdb_tpu_torch.conflict import fused
    from foundationdb_tpu_torch.ops.rangemax import build_sparse_table
    from foundationdb_tpu_torch.ops.sort import sort_rows
    cases = {}
    if "table" in chosen:
        g = torch.Generator(device=S.DEVICE).manual_seed(5)
        v = torch.randint(-(1 << 31), (1 << 31) - 1, (1 << 21,),
                          dtype=torch.int32, device=S.DEVICE, generator=g)
        cases["table_2^21"] = lambda: build_sparse_table(v)
    for what, (rows, tie, pay) in (S.sort_cases(
            universe, r_cap, w_cap, n_writes).items()
            if "sort" in chosen else ()):
        cases[f"sort_{what}"] = (lambda rows=rows, tie=tie, pay=pay:
                                 sort_rows(rows, tie=tie, payload=pay))
    if "fixpoint" in chosen:
        cases["fixpoint_config3"] = lambda: fused.interval_fixpoint(*fix_in,
                                                                    log_u)
    if "merge" in chosen:
        step = fused.make_merge_step(merge_in["bk"].shape[0],
                                     merge_in["dk"].shape[0])

        def merge():  # on a copy: the merge updates its state in place
            st = {k: t.clone() for k, t in merge_in.items()}
            step(st["bk"], st["bv"], st["table"], st["size"], st["dk"],
                 st["dv"], st["dsize"], st["flag"], (2500, 1000))

        cases["merge_config2"] = merge
    for what, kind, shape, kw in INSERTS if "insert" in chosen else ():
        state, ins_args = S.insert_state(kind, *shape, **kw)
        cases[f"insert_{what}"] = (
            lambda kind=kind, state=state, ins_args=ins_args:
            insert_once(kind, state, ins_args))
    for what, *_ in S.PROBE_SHAPES if "probe" in chosen else ():
        fn = S.probe_inputs(what)[2]
        cases[f"probe_{what}"] = lambda fn=fn: fn("kernel")
    if "union" in chosen:
        from foundationdb_tpu_torch.conflict import window
        _, (d_b, d_e, d_valid, _) = S.insert_state("window", *INSERTS[2][2])
        cases["union_config3_delta"] = lambda: window._union_ranges(
            d_b, d_e, d_valid)
    result = {}
    for name, fn in cases.items():
        fn()
        kernels = {}
        for key, (n, us) in S.profile_calls(fn, calls).items():
            short = kernel_key(key)  # the union's fills too
            if short.startswith("k_") or name.startswith("union"):
                kernels[short] = {"us_per_launch": us / n,
                                  "launches_per_call": n / calls}
        result[name] = kernels
    dst = torch.empty_like(universe)
    result["copy_universe_ms"] = S.device_ms(lambda: dst.copy_(universe),
                                             reps=20)
    return result


def insert_once(kind: str, state: dict, args: tuple) -> None:
    """One insert on a copy of the state (the insert is in place)."""
    from foundationdb_tpu_torch.conflict import fused, window
    st = {k: t.clone() for k, t in state.items()}
    if kind == "point":
        u_k, u_e, w_uid, w_ins, now, u_own = args
        fused._point_insert(st["k"], st["v"], st["size"], u_k, u_e, w_uid,
                            w_ins, now, st["flag"], u_own=u_own)
    else:
        window.window_insert(window.WindowState(st["k"], st["v"],
                                                st["size"]), *args)


if __name__ == "__main__":
    sys.exit(main())
