#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA conflict path on one NVIDIA GPU.

Drives foundationdb_tpu_torch's five paths through the entry points a
resolver calls, each at full size, then the supervised set (the
factory's default route) over them, then the Resolver role over that
(the requests a commit proxy sends), the entry points of entry.py, and
the resolution plane (N roles behind the commit proxies' clip and
min-merge, with resolution balancing) and the scheduling plane around it
(predictor admission, reorder, repair), the write path behind it, its
restart from a data directory, the client in front of it all with every
role in a simulated process of its own on the port's SimNetwork, faults
on that network, and the Resolver in another OS process over TCP:

  point    TorchConflictSet.resolve_encoded_async -> _pack_compact -> the
           compact step, the delta table, the merge, at the bench's config
           2: 100K txns per batch, 2 point reads + 1 point write each,
           zipf(1.2) keys over a 1M keyspace as 15-byte b"k%014d" keys;
  general  the same entry point -> _pack -> the general interval step
           (range reads, range writes, keys over 31 bytes), the delta
           table, the merge, at config 3 (BASELINE.json configs[2]): 50K
           txns per batch, 8 read ranges of 1-100 records each over 50M
           records, one point write per txn and a clear every 10th txn,
           1,024-byte keys;
  window   a one-shard window: window_query -> window_insert every config-3
           batch, window_gc every 8 batches (window_query is the entry
           __graft_entry__.py hands out);
  sharded  ShardedTorchConflictSet.resolve_encoded_async, four key-range
           shards on the one card, at config 5 (BASELINE.json configs[4]):
           65,536 txns per batch, 2 point reads + 1 point write each,
           uniform over 100M keys, 2^20 boundaries and a 2^18 delta per
           shard, equi-depth splits, the floor frozen while the window
           fills to >= 1,000,000 in-flight writes at depth 3;
  sharded_window
           ShardedWindow.resolve_step at kr=4, q=1, 2^21 boundaries per
           shard, on the config-3 batches of the window path.

Paths 1-3: capacity 2^21, delta capacity 2^20, snapshots up to 2,000
versions behind, 1,000 versions per batch, the window floor 5 batches back.

Phases (each prints its lines and its seconds; any failure raises and
exits non-zero):
  1. toolchain: the card's name and power limit, CUDA, nvcc; build the
     kernels from csrc/ (one nvcc per source, in parallel);
  2. every config-2 kernel wrapper and program through the kernel and
     through its plain-torch version on the card on identical inputs:
     outputs must be bit-equal (all integer data; tolerance 0); times by
     CUDA events (a wrapper's row: the device time of its own launches);
     inclusive_scan also at config 2's pads, delta and merge beside
     torch.cumsum, one launch a call; intra_batch_fixpoint also on a
     300-deep chain at config-2 width (rounds equal to the depth);
     build_sparse_table also at 2^18, 2^20 and 2^21 (a shard's delta, the
     delta, the base), at most two launches a call; the merge's launches
     a call (3, and 5 with the base table); the point insert on the
     warmed delta (insert_at: 4 launches a call and no scan, sort, search,
     rank count or compaction; its own and whole device ms, bounds over
     the live rows and over the full-capacity passes of a histogram-and-
     scatter insert); history_probe at config 2 (probe_at: launches a
     call, own ms, the bound by search_bytes); read_write_prep's one
     launch a call; compact_prep's and intra_batch_fixpoint's (with the
     codes: the compact step's resolve) one launch, one kernel and no
     other device operation a call by torch.profiler, and each whole
     call's device time behind the sleep;
  3. the point path: 3 warmup batches, 10 at pipeline depth 8, 8 at depth
     1; oracle parity in both contention regimes; kernel-vs-plain state
     equality across a merge;
  4. every new wrapper and the programs #4-#7 (general step, window_query,
     window_insert, window_gc), kernel against plain at config-3 shapes;
     sort_rows also on (a) the config-3 universe, (b) random 32-byte
     digests, (c) rows sharing an 8-byte prefix, all 1,179,648 rows, and
     the window path's 2w endpoints with tie and payload: 1 + 2 *
     sort_rounds(n) launches a call, and the spread of its times over
     (a)-(c); general_prep's one launch, one kernel and no other device
     operation a call by torch.profiler, and its whole call's device time
     behind the sleep; interval_fixpoint with its codes (as the general
     step calls it): rounds equal to the plain version's, one launch, one
     kernel and no other device operation a call, its own time beside the
     fixpoint alone's, and a 200-deep chain of ranges at config-3 width
     (rounds equal to the depth); window_gc on path 3's window the same
     way (one in-place launch and nothing else a call), its bound the
     in-place call's least bytes (gc_bytes) beside wg_keep's, and at a
     floor that drops rows and on a synthetic 2^21 window (gc_at);
     window_insert on the general step's
     delta and on path 3's window (insert_at: 3 launches a call beyond
     _union_ranges', which it no longer adds to); _union_ranges on the
     general step's and path 3's writes (union_at: wu_endpoints and
     wu_sweep, the sort, no scan or compaction; its own ms, the whole
     call's without the sort, its bound); searchsorted where the general
     step calls it (the batch's 2^21 universe, every one of its 1,179,648
     rows a query; one launch a call); history_probe at the
     general step's shape (every read slot against the warmed tiers) and
     window_query on path 3's window (probe_at);
  5. the general path on config 3 (3 + 10 at depth 8 + 8 at depth 1): the
     path_general line, commit rate in 0.05-0.95;
  6. oracle parity on 6 batches of 1,000 config-3 txns over 1M records,
     full 1,024-byte keys, too-old snapshots included;
  7. kernel-vs-plain state equality at full config-3 size across a merge;
  8. the window path on 10 config-3 batches, bits and state against the
     plain versions, then bits against the oracle's history on small
     batches;
  9. the shard wrappers (clip_rows, shard_combine, shard_commit; the
     combine over the four shards' hists in place in compact_prep's
     scratch, through the sharded step's own call: one launch, one kernel
     and no copy a call by torch.profiler, its time behind the sleep) and
     the programs #8 (sharded compact step and merge at config 5, sharded
     general step at config 3) and #9 (sharded window step and gc), kernel
     against plain; one shard's merge, point insert and history probe
     (its owned keys) alone at its shape, and window_query on one shard of
     the sharded window;
 10. the sharded path on config 5: fill, p50 at depth 1, shard balance,
     the at-capacity probe (2,048 committed writes re-read at snapshot 0
     must all conflict);
 11. the sharded backend against the oracle on small batches (config 5,
     zipf, config 3), and kernel-vs-plain state at full config-5 size
     across a merge;
 12. the config-3 stream through four shards: codes equal the one-device
     general path's;
 13. the sharded window on the config-3 batches (bits equal the one-shard
     window's), on spread random batches (bits and state equal the plain
     versions) and on an overflow of one shard (every shard unchanged);
 14. the supervised point path: new_conflict_set("torch") -- a
     SupervisedConflictSet over TorchConflictSet -- at
     CONFLICT_PIPELINE_DEPTH 8 over phase 3's stream (3 warmup batches,
     10 at depth 8, 8 at depth 1), its codes equal to the bare set's on
     the same stream batch for batch; the path_supervised line beside the
     bare figures, the pipeline stalls and the mirror's fold-through ms a
     batch; nothing rechecked (15-byte keys);
 15. long keys: phase 6's small config-3 batches and a stream whose keys
     share 31-byte prefixes, through the supervised set (verdicts equal
     the oracle's, batches rechecked) and the bare set (its aborts the
     oracle does not make, counted);
 16. degrade and promotion: a timeout injected on one dispatch with 7
     batches in flight at depth 8, a monitor whose re-probe is due at
     once: one degrade, the in-flight batches replayed in order through
     the mirror, one promotion rebuilding the device set on the card from
     the mirror (compact and general steps), codes equal to the oracle's;
 17. ShardedTorchConflictSet.supervised on phase 10's mesh, splits,
     capacity and delta, filled at depth 3 over 11 batches, then the
     2,048 re-reads of committed writes (all must conflict);
 18. new_conflict_set("auto") is the supervised torch set on `cuda`.
     Every supervised phase that injects no fault requires no degrade, no
     fallback batch and no promotion, every batch on the card, the
     expected device set on `cuda`, and the kernels of its path launched;
 19. (new in the fifteenth slice; the JSON phase was 19 before) the
     Resolver role, server/resolver.py, over the supervised set on the
     card (capacity 2^21, delta 2^20, MAX_WRITE_TRANSACTION_LIFE_VERSIONS
     set to WINDOW so that its floor is floor(v)) on phase 14's stream in
     object form, 3 warmup batches and 10 measured: the batches alternate
     between proxies p0 and p1 on one chain, each measured pair is
     delivered second-first (the second parks), the last batch is resent
     once (answered from the cache, no resolve), 1% of the txns are state
     transactions with one mutation; codes equal phase 14's batch for
     batch, each reply's state broadcast as specified, no degrade, the
     point path's kernels launched; the path_resolver line (ranges/s
     chain-serialised, p50 a request, the set's call, the role's host ms
     beyond it and _sample_batch's alone, QueueWait); then the role on
     the card against a role over the oracle on a small contended stream
     (replies, counters and heat tables equal), and the entry points
     (entry()'s window_query against its plain version,
     dryrun_multichip(4) over `cuda` four times);
 20. (new in the sixteenth slice; the JSON phase was 20 before) the
     resolution plane, server/cluster.py ResolutionPlane: N roles over
     supervised sets on the card (capacity 2^21, delta 2^20,
     MAX_WRITE_TRANSACTION_LIFE_VERSIONS = WINDOW), boundaries from
     seed_resolver_boundaries over a 16-shard map cutting the 1M ids
     evenly.  Stream A (1 warmup + 4 measured config-2 batches, each
     txn's three keys zipf inside one quarter of the ids) at N = 1, 2, 4
     and N = 1 again, one proxy: merged verdicts of every reading equal
     the first N = 1's batch for batch; the requests' build ms, each
     resolver's share and ranges/s, bench.py's aggregate model, the
     serial wall, the collector's time.
     Stream B (config 2 as generated, 2 + 5 batches) at N = 4, two proxies
     alternating on one chain, 1% state txns, a balancing step after
     every batch: each resolver's codes equal a point oracle over its own
     fragments, the merged verdicts their min, every other proxy's
     committed state txn received once, a move adopted; the extra aborts
     (and commits) over one resolver, the moves, the shares.  The small
     exact case: the reference's aligned parity stream and a contended
     straddling stream with a forced move and old-snapshot reads across
     it, at N = 1, 2 and 4, the plane on the card against one over the
     oracle (replies equal).  No degrade; every role launches the point
     path's wrappers; the path_plane line;
 21. the scheduling plane around the resolution plane: the GRV proxies'
     predictor admission (server/grv_proxy.py), the commit proxy's
     reorder, repair collection and replies (commit()), the ratekeeper's
     heat poll (server/ratekeeper.py), driven as bench.py sched drives its
     model (drive_sched) over supervised sets on the card (capacity 2^21,
     delta 2^20, MAX_WRITE_TRANSACTION_LIFE_VERSIONS = WINDOW).  The small
     exact case first: all+ladder at N = 2, two proxies, 256 txns a batch
     over 4,096 ids, every abort attributed exactly: replies and counters
     equal to the plane on the CPU (two reads a txn) and to the oracle
     plane (one read a txn).  Then bench.py sched's stream (8,192 txns a
     batch, 2 point reads + 1 point write each, zipf(1.2) over the 1M ids,
     seed 4242, 2 warmup + 7 counted batches, cut from 3 + 10), every txn
     with its tag, reporting its keys, opted into repair: the seven configurations (off,
     predictor, reorder, repair, all, ladder, all+ladder) at N = 1,
     all+ladder at N = 4 with two proxies, and all+ladder at N = 1 with
     every abort attributed exactly.  Every txn answered exactly once,
     none deferred more than SCHED_MAX_DEFERRALS times, reorder moves and
     repairs non-zero where their knobs are on, the off configuration's
     codes equal to the plain plane's (resolve()) batch for batch, no
     degrade; a path_sched line a reading (commit rate, bench.py's stage
     counters, role calls, repair batches and sizes, exact and
     conservative attributions, ms a round by stage);
 22. (new in the eighteenth slice; the JSON phase was 22 before) the
     write path behind the resolvers, server/cluster.py StaticCluster, in
     FoundationDB's `double` redundancy mode: the master's versions, 2
     Resolver roles on the card (supervised sets, capacity 2^21, delta
     2^20), 2 commit proxies in turn routing mutations to tags with
     versionstamps, 2 TLogs (replication 2) over disk queues in a
     temporary directory, 4 storage servers in teams of 2 cut at the
     quartiles of the ids, 1 GRV proxy; config 2's 1M keys loaded with
     100-byte values on both replicas; 2 warmup + 6 timed config-2
     batches at the batcher's cap (32,768 txns) of 100-byte SetValues
     read at the GRV's version, 1% adding
     to a counter, 1% writing a versionstamped key, every 4th batch 100
     ClearRanges of 10 keys (the general step; the rest the compact
     step), one txn splitting a shard.  Every request answered once, no
     reply before its version is durable on every TLog and known to the
     master, every written key read back equal to a dict model on both
     replicas (get and get_range over every shard) at the last version
     and at the one before, the counter equal to the committed adds,
     every versionstamp its CommitID, the queue files recovered whole,
     the resolution kernels of both steps launched, every batch's replies
     equal to a CPU plane's verdicts on the same batches at the same
     versions; a small replay (2,000 txns, a point and a general batch)
     equal to a plane over the oracle at the same versions; the
     path_commit line (committed txns/s,
     p50 of commit() and its phases, pull, fsync, MB logged, mutations
     applied/s, read-back, TOO_OLD and conflicts);
 23. (new in the nineteenth slice; the JSON phase was 23 before) a
     restart, `configure new double memory`: phase 22's cluster over the
     memory storage engine (server/kvstore.py) on every storage server,
     the 1M keys imaged into every engine, 2 + 4 of phase 22's batches
     with the engines made durable every second batch, the TLogs' spill
     threshold lowered to 64 KiB and storage server 0 (the zipf head's
     shard) held back for the last 2 batches so its backlog spills and a
     peek reads it back from the queue file; then the kill (descriptors
     released, nothing synced) and StaticCluster.recover (the boot scan,
     the epoch end, a new TLog generation carrying the un-popped data,
     the engines' recovery, new roles at the recovery version on the
     card): the recovery version at least the last acknowledged version,
     every acknowledged key read back on both replicas equal to the dict
     model (read_back), a read below the recovery version too old, 2 more
     batches (a clear batch: the general step, then a point batch) whose
     replies equal a CPU plane's built at the recovery version, the
     compact and general steps' kernels launched in the new epoch; a
     second kill and recovery reads everything back again.  The B-tree
     engine (server/kvstore_btree.py) the same at a cut: 50,000 keys, 2 +
     2 batches of 4,096 txns.  The path_restart line (the restart and its
     parts, MB replayed, keys recovered/s, MB spilled, the spilled peek,
     engine commit ms a batch, p50 commit() before and after);
 24. (new in the twentieth slice; the JSON phase was 24 before) the
     client: phase 22's cluster (double redundancy, 2 Resolver roles on
     the card at capacity 2^21 and delta 2^20, 2 commit proxies behind
     their batchers, 2 TLogs over disk queues, 4 storage servers in teams
     of 2, 1 GRV proxy, the 1M keys with 100-byte values on both
     replicas) on the port's EventLoop, every transaction through
     StaticCluster.database() and TestWorkload.run_transaction's retry
     loop: ReadWrite's shape (4 uniform point reads, 2 writes of fresh
     100-byte values) from 8,192 concurrent actors, 4 transactions each
     (1 warmup round; 8 and 2 before the twenty-second slice), every
     4th round's transactions also reading 10 consecutive keys with
     get_range (the general step; the rest the compact step); then
     Cycle over 10,000 nodes from 2,048 actors, 3 swaps each (4
     before).  Every acknowledged ReadWrite write read back on both
     replicas at the last version against a dict model ordered by
     (commit version, batch index, order within the transaction), the
     Cycle ring intact on both replicas and by the workload's check, the
     Cycle batches replayed through a plane over the oracle at the same
     versions giving the same codes, the proxies' committed count equal
     to the clients', both steps' kernels launched, no degrade; the
     path_client line (committed txns/s, p50 and p99 of a transaction
     from its first GRV request to its commit reply over every attempt
     and backoff, GRV and read ms a transaction summed over its
     attempts, retries a commit and the abort rate, batches and their
     mean size, the wall split into client Python, the proxies' commit()
     and the storage reads, and the share of transactions whose
     committed attempt outlasted the 5 s MVCC window in wall time).  The
     master's versions follow the loop's virtual clock and the cyclic
     collector is off while the actors run, so no transaction grows too
     old however slow the host is, and the rates and aborts are those of
     that regime, not of a wall-clock cluster with the collector on.
     Since the twenty-second slice every role runs in a simulated
     process of its own on the port's SimNetwork (StaticCluster.start):
     the proxies' batches reach the master, the resolvers and the TLogs
     as messages with the network's latency;
 25. (new in the twenty-second slice) faults on the simulated network:
     phase 24's cluster, ReadWrite from 2,048 actors, 8 transactions
     each (2 warmup rounds); while the measured rounds run, storage
     server ss1's process is killed and resolver0's process clogged for
     2 virtual seconds.  Every acknowledged write read back from every
     surviving replica of its team, reads failed over, one reply a
     commit (one stamp a commit, the proxies' count the clients'),
     commits sent during the clog answered after it; the path_sim line
     (committed/s, p50 and p99, failovers, broken_promise replies,
     messages sent, commits held by the clog);
 26. (new in the twenty-second slice) the Resolver over TCP: a child
     interpreter (this file, RESOLVER_CHILD_ARG) serves the port's
     Resolver role on the card on a RealNetwork at 127.0.0.1 and writes
     its interface, serde-encoded, to a file; this process, on a
     real-mode EventLoop and a RealNetwork of its own, sends phase 19's
     13 requests down the version chain as columnar frames and holds
     every reply to phase 19's in-process role's bit for bit, reads the
     child's launch counts over the network, then kills it: the next
     request fails with a transport error within 10 s and the failure
     monitor marks the role failed; the path_wire line (frame MB,
     encode and decode ms, p50 and p99 round trip beside phase 19's
     p50 delivery to reply);
 27. the JSON lines (programs and paths; kernels with launches per path,
     each wrapper > 0 on the paths that use it, searchsorted once a
     general step; inclusive_scan and compact_rows, which no path runs
     (window_gc scans and compacts inside its own launch), are held
     against their plain versions in phase 2 and report 0),
     the card's name and power
     limit, and the last line: {"ok": true, "device": {...}}.

Run it from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import deque
from dataclasses import dataclass
from typing import Any

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


PHASE_SECONDS = {}
_T_LAST = [time.perf_counter()]


def phase_done(name: str) -> None:
    """Print and keep the seconds since the previous phase ended."""
    now = time.perf_counter()
    PHASE_SECONDS[name] = now - _T_LAST[0]
    _T_LAST[0] = now
    print(f"phase: {name} took {PHASE_SECONDS[name]:.1f} s", flush=True)


# The wrappers each path must launch (counted with the counts set to 0
# just before the path is driven and read just after).
# The inserts run no scan, search, rank count or compaction of ops/, nor
# does _union_ranges (its sweep is one kernel), nor the compact step's
# unpacking (compact_prep scans its rank counts itself), nor window_gc
# (one in-place launch): searchsorted runs on the general path only (the
# endpoint universe), and no path runs inclusive_scan or compact_rows
# (OFF_PATH: phase 2 still holds them against their plain versions).
_WINDOW = ["window_query", "sort_rows", "union_ranges", "window_insert",
           "window_gc", "build_sparse_table"]
OFF_PATH = ("inclusive_scan", "compact_rows")
PATH_KERNELS = {
    "point": ["compact_prep", "history_probe", "read_write_prep",
              "intra_batch_fixpoint", "point_insert", "merge",
              "build_sparse_table"],
    "general": ["history_probe", "merge", "sort_rows", "general_prep",
                "interval_fixpoint", "union_ranges",
                "window_insert", "searchsorted", "build_sparse_table"],
    "window": _WINDOW,
    "sharded": ["compact_prep", "history_probe", "read_write_prep",
                "intra_batch_fixpoint", "point_insert", "merge", "clip_rows",
                "shard_combine", "build_sparse_table"],
    "sharded_window": [*_WINDOW, "clip_rows", "shard_combine",
                       "shard_commit"],
}
# The supervised phases (14-18): the same device programs under the
# supervision layer.  Long keys take the general step; the promotion's
# rebuild replays the mirror through it; one "auto" batch merges nothing.
_GENERAL_STEP = ["history_probe", "sort_rows", "general_prep",
                 "interval_fixpoint", "union_ranges", "window_insert",
                 "searchsorted", "build_sparse_table"]
PATH_KERNELS.update({
    "supervised": PATH_KERNELS["point"],
    "long_keys": _GENERAL_STEP,
    "promotion": [*PATH_KERNELS["point"], *_GENERAL_STEP],
    "supervised_sharded": PATH_KERNELS["sharded"],
    "auto": [k for k in PATH_KERNELS["point"] if k != "merge"],
})
# Phase 19: the Resolver role over the supervised set takes the point path
# (13 batches cross a merge); the entry points' window_query, and the
# sharded dry run's steps on tiny shapes.
PATH_KERNELS.update({
    "resolver": PATH_KERNELS["point"],
    "entry": ["window_query", "build_sparse_table", "shard_combine"],
})
# Phase 20: every role of the resolution plane takes the point path (its
# small straddling stream's range reads take the general step too, which
# this list does not require); stream B's 12 batches cross a merge.
PATH_KERNELS["plane"] = PATH_KERNELS["point"]
# Phase 21: the scheduling plane adds no kernel; every role of its readings
# takes the point path (each reading's 13 batches cross a merge).
PATH_KERNELS["sched"] = PATH_KERNELS["point"]
# Phase 22: the write path's roles take the compact step on point batches
# and the general step on batches with clears; no role's delta fills in
# its 8 batches, so no merge.
PATH_KERNELS["commit"] = [
    *[k for k in PATH_KERNELS["point"] if k != "merge"],
    *[k for k in _GENERAL_STEP if k not in PATH_KERNELS["point"]]]
# Phase 23: the new epochs' batches after each first restart (a point
# batch and a clear batch, each run) take the same two steps; no merge.
PATH_KERNELS["restart"] = PATH_KERNELS["commit"]
# Phase 24: the client's batches take the compact step (point
# transactions) and the general step (the rounds with a get_range); a
# merge (#3) runs where a role's delta comes due, which the drive does
# not fix, so it is counted and not required.
PATH_KERNELS["client"] = PATH_KERNELS["commit"]
# Phase 25: the client's drive with a storage process killed and a
# resolver's process clogged takes the same two steps.
PATH_KERNELS["sim"] = PATH_KERNELS["client"]
# Phase 26: the Resolver role in another OS process, over TCP, on phase
# 19's requests: the point path (13 batches cross a merge), counted in
# that process and read back over the network.
PATH_KERNELS["wire"] = PATH_KERNELS["point"]


# ---------------------------------------------------------------- workload
def point_draws(rng, prev: int, keyspace: int, zipf: bool,
                txns: int = TXNS, cells: int = 0, reads: int = READS):
    """The bench's config-2 draws (bench.py gen_batch): the key ids, a
    txn's `reads` reads first (txn-major) then one write a txn, and the
    snapshots.  With `cells`, every txn's keys fall zipf inside one of
    `cells` equal cells of the ids, its cell drawn uniformly."""
    n = txns * (reads + 1)
    if zipf:
        kids = (rng.zipf(1.2, size=n) % keyspace).astype(np.int64)
    else:
        kids = rng.integers(0, keyspace, size=n, dtype=np.int64)
    if cells:
        width = keyspace // cells
        cell = rng.integers(0, cells, size=txns)
        kids = kids % width + width * np.concatenate(
            [np.repeat(cell, reads), cell])
    snaps = np.maximum(prev - rng.integers(0, 2 * VERSIONS_PER_BATCH,
                                           size=txns), 0)
    return kids, snaps


def gen_batch(rng, prev: int, keyspace: int, zipf: bool, txns: int = TXNS):
    """The bench's config-2 batch (bench.py gen_batch): columns + the key
    ids and snapshots the oracle's object form is built from."""
    from foundationdb_tpu_torch.conflict.encoded import EncodedBatch
    from foundationdb_tpu_torch.ops.digest import encode_fixed
    kids, snaps = point_draws(rng, prev, keyspace, zipf, txns)
    n = txns * (READS + 1)
    mat = np.empty((n, 16), dtype=np.uint8)
    mat[:, 0] = ord("k")
    mat[:, 15] = 0
    x = kids.copy()
    for d in range(14):
        mat[:, 14 - d] = 48 + x % 10
        x //= 10
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
    """The oracle's semantics (SkipList.cpp, conflict/oracle.py) for
    all-point batches, with the intra-batch check as a set lookup:
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
        """A stream batch in draws (point_draws' layout): READS reads and
        one write a txn."""
        keys = [b"k%014d" % int(k) for k in kids]
        txns = len(snaps)
        nr = txns * READS
        return self.resolve_keys(
            [keys[t * READS:(t + 1) * READS] for t in range(txns)],
            keys[nr:], snaps, now, new_floor)

    def resolve_txns(self, txns, now: int, new_floor: int) -> np.ndarray:
        """Point txns in object form: 0-2 point reads and 0-1 point write
        each (a resolver's fragments of a stream batch)."""
        reads, writes = [], []
        for t in txns:
            rs = [r.begin for r in t.read_conflict_ranges]
            ws = [w.begin for w in t.write_conflict_ranges]
            if len(rs) > READS or len(ws) > 1 or any(
                    r.end != r.begin + b"\x00" for r in
                    t.read_conflict_ranges + t.write_conflict_ranges):
                raise AssertionError(f"not a point txn: {t}")
            reads.append(rs)
            writes.append(ws[0] if ws else None)
        return self.resolve_keys(reads, writes,
                                 [t.read_snapshot for t in txns], now,
                                 new_floor)

    def resolve_keys(self, reads, writes, snaps, now: int,
                     new_floor: int) -> np.ndarray:
        """Txn t reads the keys reads[t] and writes writes[t] (or
        nothing, None) at snapshot snaps[t]; too old only if it reads."""
        from foundationdb_tpu_torch.conflict.oracle import \
            combine_write_ranges
        o, hist = self._o, self._o.history
        codes = np.full((len(snaps),), 2, dtype=np.int8)
        written, survivors = set(), []
        for t, (rs, w) in enumerate(zip(reads, writes)):
            snap = int(snaps[t])
            if rs and snap < o.oldest_version:
                codes[t] = 1
                continue
            if any(hist.query_max(k, k + b"\x00") > snap or k in written
                   for k in rs):
                codes[t] = 0
                continue
            if w is not None:
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


# ---------------------------------------------------------------- config 3
# BASELINE.json configs[2] / BASELINE.md:25, "range-read heavy": 50K txns
# per batch, each with 8 read ranges of s records, s uniform in 1-100
# (YCSB workload E's scan length, maxscanlength=100, uniform) starting
# uniformly over 50M records; one point write per txn at a uniform record
# and, every 10th txn, one clear of 1-100 records.  Keys are 1,024 bytes:
# an 8-byte big-endian id, then 1,016 filler bytes.  Record r has id 2r and
# a range over records [r, r+s) ends at id 2(r+s)-1: begins are even and
# ends odd, so the 31-byte digest (ends rounded up one ulp) orders every
# pair of keys as the full keys do, and verdicts must equal the oracle's.
RECORDS = 50_000_000
TXNS3 = 50_000
READS3 = 8
SCAN_MAX = 100
CLEAR_EVERY = 10
KEY_BYTES = 1024
FILL = ord("v")
RECORDS_SMALL, TXNS_SMALL, N_ORACLE3 = 1_000_000, 1_000, 6
N_WARMUP3, N_MEASURED3, N_LATENCY3 = 3, 10, 8
N_WINDOW3, GC_EVERY3 = 10, 8


def digests3(ids, end: bool):
    """Digests of the 1,024-byte keys of `ids`, encoded from their first 32
    bytes (encode_fixed with the true lengths); ends round up."""
    from foundationdb_tpu_torch.ops.digest import encode_fixed
    ids = np.asarray(ids, dtype=np.int64).ravel()
    mat = np.full((ids.size, 32), FILL, dtype=np.uint8)
    mat[:, :8] = ids.astype(">u8").view(np.uint8).reshape(-1, 8)
    return encode_fixed(mat, np.full(ids.size, KEY_BYTES), round_up=end)


def full_key(i: int) -> bytes:
    return int(i).to_bytes(8, "big") + bytes([FILL]) * (KEY_BYTES - 8)


def gen_batch3(rng, prev: int, oldest: int, records: int = RECORDS,
               txns: int = TXNS3, too_old: float = 0.0):
    """One config-3 batch: (EncodedBatch, the record draws the oracle's
    objects are built from).  A `too_old` share of the snapshots sits
    just below `oldest`, the floor in force when the batch arrives."""
    from foundationdb_tpu_torch.conflict.encoded import EncodedBatch
    r0 = rng.integers(0, records - SCAN_MAX, size=(txns, READS3))
    s = rng.integers(1, SCAN_MAX + 1, size=(txns, READS3))
    q = rng.integers(0, records, size=txns)
    ct = np.arange(0, txns, CLEAR_EVERY)
    c0 = rng.integers(0, records - SCAN_MAX, size=ct.size)
    cs = rng.integers(1, SCAN_MAX + 1, size=ct.size)
    snaps = np.maximum(prev - rng.integers(0, 2 * VERSIONS_PER_BATCH,
                                           size=txns), 0)
    if too_old:
        snaps[rng.random(txns) < too_old] = max(oldest - 1, 0)
    w_txn = np.concatenate([np.arange(txns), ct]).astype(np.int32)
    order = np.argsort(w_txn, kind="stable")
    wb = np.concatenate([digests3(2 * q, False), digests3(2 * c0, False)], 1)
    we = np.concatenate([digests3(2 * q, True),
                         digests3(2 * (c0 + cs) - 1, True)], 1)
    enc = EncodedBatch(
        n_txns=txns, t_snap=snaps.astype(np.int64),
        t_has_reads=np.ones((txns,), dtype=bool),
        r_txn=np.arange(txns * READS3, dtype=np.int32) // READS3,
        r_begin=digests3(2 * r0, False), r_end=digests3(2 * (r0 + s) - 1, True),
        w_txn=w_txn[order], w_begin=wb[:, order], w_end=we[:, order])
    return enc, (r0, s, q, ct, c0, cs, snaps)


def transactions3(draws):
    """The batch as CommitTransactionRef objects over the full keys."""
    from foundationdb_tpu_torch.txn.types import CommitTransactionRef, KeyRange
    r0, s, q, ct, c0, cs, snaps = draws
    clears = {int(t): (int(a), int(b)) for t, a, b in zip(ct, c0, cs)}
    out = []
    for t in range(len(snaps)):
        wk = full_key(2 * q[t])
        writes = [KeyRange(wk, wk + b"\x00")]
        if t in clears:
            a, b = clears[t]
            writes.append(KeyRange(full_key(2 * a), full_key(2 * (a + b) - 1)))
        out.append(CommitTransactionRef(
            read_conflict_ranges=[
                KeyRange(full_key(2 * a), full_key(2 * (a + b) - 1))
                for a, b in zip(r0[t], s[t])],
            write_conflict_ranges=writes, read_snapshot=int(snaps[t])))
    return out


def make_stream3(rng, count: int, records: int = RECORDS, txns: int = TXNS3,
                 too_old: float = 0.0):
    """`count` batches, 1,000 versions apart, from past the first window
    (so every batch's floor is above 0)."""
    out, version = [], 1_000 + WINDOW
    for _ in range(count):
        prev, version = version, version + VERSIONS_PER_BATCH
        out.append((version, *gen_batch3(rng, prev, floor(prev), records,
                                         txns, too_old)))
    return out


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
    calls (a tuple of names: their sum); without, it is the whole call,
    with no event between its operations."""
    import contextlib
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
            with (K.timed_launches() if counter is not None
                  else contextlib.nullcontext({})) as timed:
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
        names = (counter,) if isinstance(counter, str) else counter
        pairs = [pair for n in names for pair in timed.get(n, [])]
        if not pairs:
            raise AssertionError(f"{counter}: no launch under its counter")
        total += sum(s.elapsed_time(e) for s, e in pairs)
    return total / reps


def kernel_sum_ms(fn, reps: int = REPS, setup=None) -> float:
    """Mean device milliseconds per call of fn() as the sum of the times of
    its own kernels, each launch between a pair of CUDA events
    (kernels.timed_launches); torch's own fill and copy kernels are not in
    it.  For the sharded programs, which enqueue four shards' launches:
    held behind a sleep (device_ms), their host stalls before the whole
    call is enqueued (the launch queue fills), so device_ms cannot
    separate their device time from the host's."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    total = 0.0
    for _ in range(reps):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        with K.timed_launches() as timed:
            fn()
        torch.cuda.synchronize()
        total += sum(s.elapsed_time(e) for pairs in timed.values()
                     for s, e in pairs)
    return total / reps


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


def search_bytes(table, n_queries: int) -> int:
    """Distinct table rows a batch of binary searches must read.  The
    midpoints over [0, cap) form a tree of cap nodes, level l holding
    min(2^l, cap - (2^l - 1)) of them (a power-of-two table's last level
    holds one), and Q searches touch at most Q of a level's."""
    cap = table.shape[0]
    levels = cap.bit_length()
    rows = sum(min(1 << lvl, n_queries, cap - ((1 << lvl) - 1))
               for lvl in range(levels))
    return rows * table.shape[1] * table.element_size()


def prep_bytes(prep_in, prep) -> int:
    """Least bytes of compact_prep: the packed sections it reads (ub,
    r_start, w_start, t_snap, t_flags, scal) once, its outputs (u_b, u_e,
    too_old, r_cnt, w_cnt) and the zeroed hists written once."""
    return nbytes(*prep_in[:6], *(prep[k] for k in ("u_b", "u_e", "too_old",
                                                     "r_cnt", "w_cnt")),
                  *prep["hists"])


# Sessions profile_calls takes before it gives up: on the H100 machine the
# profiler has lost events in three sessions in a row (empty sessions, or
# one kernel short), most often in a process's first sessions.
PROFILE_ATTEMPTS = 8


def profile_calls(fn, calls: int) -> dict:
    """The device operations of `calls` calls of fn() by torch.profiler:
    {the profiler's key: (operations, microseconds)}.  The profiler may
    drop events at the edge of a session, so the calls are those of the
    active step of a schedule behind a warmup step, and a session in
    which some operation did not run a whole number of times a call is
    taken again (PROFILE_ATTEMPTS sessions at most, then the run
    fails)."""
    import torch
    from torch.profiler import ProfilerActivity, schedule
    for _attempt in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=1,
                                  repeat=1)) as p:
            for _step in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                p.step()
        ops = {}
        for e in p.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0:
                ops[e.key] = (e.count, us)
        if ops and all(n % calls == 0 for n, _ in ops.values()):
            return ops
        log(f"profile_calls: the profiler saw {sorted(ops.values())} over "
            f"{calls} calls; taken again")
    raise AssertionError("profile_calls: the profiler lost device events in "
                         f"{PROFILE_ATTEMPTS} sessions")


def kernel_name(key: str) -> str:
    """A profiler key's kernel name (the port's are k_...)."""
    return key.split("(")[0].split()[-1] if "(" in key else key


def device_ops(fn, calls: int = 4) -> tuple:
    """The device operations a call of fn() enqueues, by torch.profiler
    (profile_calls): (the port's kernels, every other kernel, fill, memset
    and copy), each a call."""
    own = other = 0
    for key, (n, _) in profile_calls(fn, calls).items():
        if kernel_name(key).startswith("k_"):
            own += n
        else:
            other += n
    return own / calls, other / calls


def one_operation(name: str, fn) -> dict:
    """A wrapper's call on the card as one device operation: its launches
    a call as the counters read them (1, and none of another wrapper's),
    its device operations a call as the profiler sees them (1 of the
    port's kernels, and no fill or other operation), and the whole call
    behind the stream's sleep (chain_ms)."""
    from foundationdb_tpu_torch import kernels as K
    K.reset_counts()
    fn()
    launches = K.LAUNCHES[name]
    if launches != 1 or sum(K.LAUNCHES.values()) != 1:
        raise AssertionError(f"{name}: {dict(K.LAUNCHES)} launches a call, "
                             "not 1 of its own")
    kernels, others = device_ops(fn)
    if kernels != 1 or others != 0:
        raise AssertionError(f"{name}: the profiler saw {kernels} of the "
                             f"port's kernels and {others} other device "
                             "operations a call, not 1 and 0")
    row = {"launches_per_call": launches, "kernels_per_call": kernels,
           "other_ops_per_call": others,
           "chain_ms": device_ms(fn, reps=20)}
    log(f"{name}: one launch, {kernels} kernel and {others} other device "
        f"operations a call; the call {row['chain_ms']:.5f} ms behind the "
        "sleep")
    return row


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
    prep_in = (ub, r_start, w_start, t_snap, t_flags, scal, lw, u_pad, r_pad,
               w_pad)
    prep = fused.compact_prep(*prep_in, impl=P)
    u_b, u_e, too_old = prep["u_b"], prep["u_e"], prep["too_old"]
    r_cnt, w_cnt = prep["r_cnt"], prep["w_cnt"]
    vmax = digest.history_probe(cs.bk, cs.table, cs.dk, cs.dtable, u_b, u_e,
                                P)
    rw = fused.read_write_prep(r_uid, w_uid, r_cnt, w_cnt, too_old, t_snap,
                               scal, vmax, u_pad, P)
    rw_in = (rw["hist"], rw["r_txn"], rw["r_live"], rw["r_slot"],
             rw["w_txn"], rw["w_ok"], rw["w_slot"])
    conf, rounds, w_ins, codes = _fix_codes(fused, rw_in, u_pad, scal,
                                            too_old, P)
    log(f"fixpoint rounds on this batch: {int(rounds.item())}")
    keep_s = (torch.arange(CAPACITY + DELTA_CAPACITY, device=DEVICE) % 3
              != 0).to(torch.int32)
    s_rows = torch.arange((CAPACITY + DELTA_CAPACITY) * 8, dtype=torch.int32,
                          device=DEVICE).reshape(-1, 8)
    s_v = torch.arange(CAPACITY + DELTA_CAPACITY, dtype=torch.int32,
                       device=DEVICE)
    ks_incl = scan.inclusive_scan(keep_s, P)
    keep_bool = keep_s.bool()

    def state_copy():
        return {k: getattr(cs, k).clone() for k in
                ("bk", "bv", "table", "size", "dk", "dv", "dtable", "dsize",
                 "flag")}

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
        "compact_prep": (lambda i: fused.compact_prep(*prep_in, impl=i),
                         prep_bytes(prep_in, prep), None),
        "history_probe": (
            lambda i: digest.history_probe(cs.bk, cs.table, cs.dk, cs.dtable,
                                           u_b, u_e, i),
            probe_bytes, None),
        "inclusive_scan": (lambda i: scan.inclusive_scan(keep_s, i),
                           2 * nbytes(keep_s),
                           lambda: torch.cumsum(keep_s, 0,
                                                dtype=torch.int32)),
        "compact_rows": (
            lambda i: _compact(scan, keep_s, ks_incl, s_rows, s_v, i),
            nbytes(keep_s, ks_incl) + 2 * int(keep_s.sum()) * 36,
            lambda: s_rows[keep_bool]),
        "build_sparse_table": (
            lambda i: rangemax.build_sparse_table(cs.bv, impl=i),
            nbytes(cs.bv, cs.table), None),
        "read_write_prep": (
            lambda i: fused.read_write_prep(r_uid, w_uid, r_cnt, w_cnt,
                                            too_old, t_snap, scal, vmax,
                                            u_pad, i),
            nbytes(r_uid, w_uid, r_cnt, w_cnt, too_old, t_snap, vmax,
                   *rw.values()), None),
        # Conf, the round count, the codes and the insert mask (the
        # fixpoint's last phase, batch_codes); the bound is one pass over
        # the inputs, too_old and the outputs, whatever the rounds (see
        # the row's "rounds").
        "intra_batch_fixpoint": (
            lambda i: _fix_codes(fused, rw_in, u_pad, scal, too_old, i),
            nbytes(*rw_in, too_old, conf, codes, w_ins), None),
        # mg_merge: the live rows of base and delta in, the merged base and
        # the reset delta out (the base table is build_sparse_table's row).
        "merge": ("merge", merge_bytes(int(cs.size[0]), int(cs.dsize[0]),
                                       CAPACITY, cs.d_cap), None),
    }
    stateful = {"merge": merge_run}
    from foundationdb_tpu_torch import kernels as K
    rows = []
    K.reset_counts()
    cases["read_write_prep"][0]("kernel")
    if (K.LAUNCHES["read_write_prep"] != 1
            or sum(K.LAUNCHES.values()) != 1):
        raise AssertionError(f"read_write_prep: {dict(K.LAUNCHES)} launches "
                             "a call, not 1 of its own")
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
        # Boolean-mask indexing synchronises the host (its output size is
        # read back), so that library call is timed on the timeline.
        lib = (None if library is None else cuda_ms(library)
               if name == "compact_rows" else device_ms(library))
        src, ref = K.KERNELS[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"foundationdb_tpu_torch/csrc/{src}.cu",
                     "replaces": ref, "launches": 0, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain,
                     "bound_ms": bound_ms(n_bytes), "bound_by": "bytes",
                     "library_ms": lib})
        log(f"{name}: bit-equal; own kernels {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bound_ms(n_bytes):.4f} ms")
    # The point insert on the warmed delta (insert_at); the config-5
    # shard's shape joins in phase 9.
    rows.append(insert_row("point_insert", insert_at(
        "config2", "point", {"k": cs.dk, "v": cs.dv, "size": cs.dsize,
                             "flag": cs.flag, "bsize": cs.size},
        (u_b, u_e, w_uid, w_ins, scal[4:5], None))))
    by_name = {r["name"]: r for r in rows}
    by_name["compact_prep"].update(one_operation(
        "compact_prep", lambda: fused.compact_prep(*prep_in)))
    log(f"compact_prep: the histograms' round trip at the memory rate "
        f"{bound_ms(8 * (r_pad + w_pad)):.5f} ms")
    by_name["intra_batch_fixpoint"].update(one_operation(
        "intra_batch_fixpoint",
        lambda: _fix_codes(fused, rw_in, u_pad, scal, too_old, None)))
    # The history probe's shapes: config 2 here, config 3's general step
    # and a config-5 shard in phases 4 and 9.
    by_name["history_probe"]["at_shapes"] = [probe_at(
        "config2", "history_probe", "point", cases["history_probe"][0],
        probe_bytes, cap=CAPACITY, slots=u_pad, searched=u_pad,
        size=int(cs.size[0]), dsize=int(cs.dsize[0]))]
    by_name["inclusive_scan"]["at_sizes"] = scan_sizes(
        scan, {"w_pad": w_pad, "r_pad": r_pad, "d_cap": cs.d_cap,
               "merge": CAPACITY + DELTA_CAPACITY})
    table = by_name["build_sparse_table"]
    table["at_sizes"] = table_sizes()
    if any(r["launches_per_call"] > 2 for r in table["at_sizes"]):
        raise AssertionError("build_sparse_table: more than two launches a "
                             "call")
    fix = by_name["intra_batch_fixpoint"]
    fix["rounds"] = int(rounds.item())
    fix["deep_chain"] = deep_chain(fused, t_cap, r_pad, w_pad, u_pad)
    # The merge's launches a call at config 2; the config-5 shard's shape
    # joins in phase 9.
    by_name["merge"]["at_shapes"] = [merge_at(
        "config2", state_copy(), CAPACITY, cs.d_cap,
        (cs._rel(cs.oldest_version),
         max(cs.oldest_version - cs.version_base, 0)))]

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


def scan_sizes(scan, sizes: dict) -> list:
    """inclusive_scan at config 2's pad sizes (and the merge's):
    one launch a call, bit-equal to the plain version, its own time
    beside torch.cumsum's on the same 0/1 mask."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    out = []
    for what, n in sizes.items():
        x = (torch.arange(n, device=DEVICE) % 3 != 0).to(torch.int32)
        K.reset_counts()
        got = scan.inclusive_scan(x)
        if K.LAUNCHES["inclusive_scan"] != 1:
            raise AssertionError(f"inclusive_scan at n={n}: "
                                 f"{K.LAUNCHES['inclusive_scan']} launches")
        err = require_equal(f"inclusive_scan n={n}", got,
                            scan.inclusive_scan(x, "plain"))
        row = {"size": what, "n": n, "launches_per_call": 1,
               "max_abs_err": err,
               "ms": device_ms(lambda: scan.inclusive_scan(x), reps=20,
                               counter="inclusive_scan"),
               # The whole call: the scratch's zero fill and the kernel.
               "call_ms": device_ms(lambda: scan.inclusive_scan(x), reps=20),
               "library_ms": device_ms(
                   lambda: torch.cumsum(x, 0, dtype=torch.int32), reps=20),
               "bound_ms": bound_ms(2 * nbytes(x))}
        out.append(row)
        log(f"inclusive_scan n={n} ({what}): one launch, bit-equal; "
            f"{row['ms']:.4f} ms ({row['call_ms']:.4f} ms with the scratch's "
            f"zero fill), torch.cumsum {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms")
    return out


# build_sparse_table's sizes on the paths: a config-5 shard's delta, the
# delta, the base (and the window).
TABLE_SIZES = {"shard_delta": 18, "delta": 20, "base": 21}


def table_sizes(reps: int = 20) -> list:
    """build_sparse_table on random int32 values at each TABLE_SIZES size:
    its launches a call, equality with the plain version, its own time
    beside the plain version's and the bound (v read once, every row
    written once)."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.ops.rangemax import build_sparse_table
    g = torch.Generator(device=DEVICE).manual_seed(5)
    out = []
    for what, log_cap in TABLE_SIZES.items():
        cap = 1 << log_cap
        v = torch.randint(-(1 << 31), (1 << 31) - 1, (cap,),
                          dtype=torch.int32, device=DEVICE, generator=g)
        K.reset_counts()
        got = build_sparse_table(v)
        launches = K.LAUNCHES["build_sparse_table"]
        err = require_equal(f"build_sparse_table cap={cap}", got,
                            build_sparse_table(v, impl="plain"))
        row = {"size": what, "cap": cap, "launches_per_call": launches,
               "max_abs_err": err,
               "ms": device_ms(lambda: build_sparse_table(v), reps=reps,
                               counter="build_sparse_table"),
               "plain_ms": cuda_ms(lambda: build_sparse_table(v,
                                                              impl="plain")),
               "bound_ms": bound_ms(nbytes(v, got))}
        out.append(row)
        log(f"build_sparse_table cap=2^{log_cap} ({what}): {launches} "
            f"launches, bit-equal; {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms")
    return out


def sort_cases(universe, r_cap: int, w_cap: int, n_writes: int) -> dict:
    """sort_rows' inputs, name -> (rows, tie, payload):
      universe  (a) the general step's endpoint universe of one config-3
                batch (8-byte ids then constant fill; MAX padding);
      digests   (b) as many rows of random 32-byte digests (hashed keys);
      prefix    (c) as many rows sharing their first 8 bytes (keys under
                one tuple-layer directory prefix), the rest random;
      window    the window path's endpoint sort (conflict/window.py
                _union_ranges): the batch's 2w write endpoints, invalid
                ones MAX, the begins-first tie and the +1 / -1 payload."""
    import torch
    from foundationdb_tpu_torch.ops.digest import planar_to_rows
    n = universe.shape[0]
    rng = np.random.default_rng(29)
    planar = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64).astype(
        np.uint32)
    digests = torch.from_numpy(planar_to_rows(planar)).to(DEVICE)
    planar[:2] = np.array([[0x15000000], [0x2A2A0102]], np.uint32)
    prefix = torch.from_numpy(planar_to_rows(planar)).to(DEVICE)
    w_b = universe[2 * r_cap:2 * r_cap + w_cap]
    w_e = universe[2 * r_cap + w_cap:2 * r_cap + 2 * w_cap]
    valid = (torch.arange(w_cap, device=DEVICE) < n_writes).to(torch.int32)
    keep = valid.bool()[:, None]
    ends = torch.cat([torch.where(keep, w_b, -1), torch.where(keep, w_e, -1)])
    tie = torch.cat([torch.zeros_like(valid), torch.ones_like(valid)])
    return {"universe": (universe, None, None),
            "digests": (digests, None, None), "prefix": (prefix, None, None),
            "window": (ends, tie, torch.cat([valid, -valid]))}


def sort_inputs(universe, r_cap: int, w_cap: int, n_writes: int,
                reps: int = 20) -> list:
    """sort_rows on each of sort_cases: launches a call, equality with the
    plain version, own time, plain time, bound (rows, tie and payload read
    once; rows and payload written once)."""
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.ops.sort import sort_rows
    out = []
    for what, (rows, tie, pay) in sort_cases(universe, r_cap, w_cap,
                                              n_writes).items():
        def run(impl, rows=rows, tie=tie, pay=pay):
            got = sort_rows(rows, tie=tie, payload=pay, impl=impl)
            return got if pay is not None else got[0]
        K.reset_counts()
        got = run(None)
        launches = K.LAUNCHES["sort_rows"]
        err = require_equal(f"sort_rows {what}", got, run("plain"))
        n_bytes = 2 * nbytes(rows) + (0 if pay is None else 2 * nbytes(pay))
        row = {"input": what, "n": rows.shape[0], "tie": tie is not None,
               "payload": pay is not None, "launches_per_call": launches,
               "max_abs_err": err,
               "ms": device_ms(lambda: run(None), reps=reps,
                               counter="sort_rows"),
               "plain_ms": cuda_ms(lambda: run("plain"), reps=2),
               "bound_ms": bound_ms(n_bytes + (0 if tie is None
                                               else nbytes(tie)))}
        out.append(row)
        log(f"sort_rows {what} (n={row['n']}): {launches} launches, "
            f"bit-equal; {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms")
    return out


DEEP_CHAIN = 300


def chain_inputs(t_cap: int, r_pad: int, w_pad: int, u_pad: int,
                 depth: int = DEEP_CHAIN):
    """Fixpoint inputs at the config-2 batch's shapes whose first `depth`
    txns form a chain (txn i reads the key txn i - 1 writes); every other
    read is of a key no txn writes, every other write of a key no txn
    reads, so the Jacobi rounds equal the depth."""
    import torch
    never = u_pad - 1                      # a key no txn writes
    r = np.arange(r_pad)
    r_txn = np.where(r < depth, r, depth + (r - depth) * (t_cap - depth)
                     // max(r_pad - depth, 1))
    r_slot = np.where((r < depth) & (r > 0), r - 1, never)
    w = np.arange(w_pad)
    w_txn = np.minimum(w, t_cap - 1)
    w_slot = np.where(w < depth, w, depth + (w - depth) % (never - depth))
    cols = (np.zeros(t_cap), r_txn, np.ones(r_pad), r_slot, w_txn,
            np.ones(w_pad), w_slot)
    return [torch.from_numpy(np.asarray(c, np.int32)).to(DEVICE)
            for c in cols]


def deep_chain(fused, t_cap, r_pad, w_pad, u_pad) -> dict:
    """intra_batch_fixpoint on a DEEP_CHAIN-deep chain at config-2 width:
    conf and rounds equal to the plain version's, rounds == the depth."""
    args = chain_inputs(t_cap, r_pad, w_pad, u_pad)
    conf, rounds = fused.intra_batch_fixpoint(*args, u_pad)
    conf_p, rounds_p = fused.intra_batch_fixpoint(*args, u_pad, "plain")
    err = require_equal("intra_batch_fixpoint deep chain", conf, conf_p)
    if not int(rounds.item()) == int(rounds_p.item()) == DEEP_CHAIN:
        raise AssertionError(f"deep chain: {int(rounds.item())} rounds, "
                             f"plain {int(rounds_p.item())}, depth "
                             f"{DEEP_CHAIN}")
    row = {"depth": DEEP_CHAIN, "rounds": int(rounds.item()),
           "max_abs_err": err,
           "ms": device_ms(lambda: fused.intra_batch_fixpoint(*args, u_pad),
                           counter="intra_batch_fixpoint"),
           "plain_ms": cuda_ms(lambda: fused.intra_batch_fixpoint(
               *args, u_pad, "plain"), reps=1)}
    log(f"intra_batch_fixpoint deep chain: {row['rounds']} rounds, "
        f"bit-equal; {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms")
    return row


GENERAL_CHAIN = 200


def endpoint_universe(digests):
    """The general step's endpoint universe of one batch, by the plain
    sort: every row of `digests` sorted, MAX padded to the next power of
    two (fused.py GeneralStep.resolve)."""
    from foundationdb_tpu_torch.conflict import fused
    from foundationdb_tpu_torch.ops import digest
    from foundationdb_tpu_torch.ops.sort import sort_rows
    n_rows = digests.shape[0]
    universe = digest.max_rows(fused._next_pow2(n_rows), digests.device)
    sort_rows(digests, out=universe[:n_rows], impl="plain")
    return universe


def general_fixpoint_inputs(digests, m, vmax):
    """interval_fixpoint's inputs for one config-3 batch (digests and the
    unpacked metadata m), built by the plain versions: the history bits
    (general_prep over vmax, each read's history maximum), the sorted
    endpoint universe and each range as a span of its gaps.  Returns
    (general_prep's outputs, the fixpoint's inputs, log_u)."""
    from foundationdb_tpu_torch.conflict import fused
    from foundationdb_tpu_torch.ops import digest
    P = "plain"
    r_cap, w_cap = m["r_txn"].shape[0], m["w_txn"].shape[0]
    g = fused.general_prep(m, vmax, P)
    universe = endpoint_universe(digests)
    pos = digest.searchsorted(universe, digests, True, P)
    r_pos, w_pos = pos[:2 * r_cap], pos[2 * r_cap:]
    fix_in = (g["hist"], m["r_txn"], g["r_live"], r_pos[:r_cap],
              r_pos[r_cap:], m["w_txn"], g["w_ok"], w_pos[:w_cap],
              w_pos[w_cap:])
    return g, fix_in, universe.shape[0].bit_length() - 1


def general_chain_inputs(t_cap: int, r_cap: int, w_cap: int, log_u: int,
                         depth: int = GENERAL_CHAIN):
    """interval_fixpoint's inputs at config 3's widths whose first `depth`
    txns form a chain of ranges: txn i reads gap 4i + 1, which the span
    [4i - 4, 4i + 2) written by txn i - 1 covers and no other write does.
    Every other txn reads an even gap and writes an odd gap of its own
    past the chain, so the Jacobi rounds equal the depth."""
    import torch
    base = 4 * depth + 8
    if base + 2 * t_cap + 2 > 1 << log_u:
        raise ValueError("the chain does not fit the universe")

    def txn_of(i, n):
        return np.where(i < depth, i, depth + (i - depth) * (t_cap - depth)
                        // max(n - depth, 1))

    r = np.arange(r_cap)
    r_txn = txn_of(r, r_cap)
    r_pb = np.where(r < depth, 4 * r + 1, base + 2 * r_txn)
    w = np.arange(w_cap)
    w_txn = txn_of(w, w_cap)
    w_pb = np.where(w < depth, 4 * w, base + 2 * w_txn + 1)
    w_pe = np.where(w < depth, 4 * w + 6, w_pb + 1)
    cols = (np.zeros(t_cap), r_txn, np.ones(r_cap), r_pb, r_pb + 1, w_txn,
            np.ones(w_cap), w_pb, w_pe)
    return [torch.from_numpy(np.asarray(c, np.int32)).to(DEVICE)
            for c in cols]


def general_deep_chain(fused, t_cap, r_cap, w_cap, log_u,
                       depth: int = GENERAL_CHAIN) -> dict:
    """interval_fixpoint on a `depth`-deep chain of ranges at config-3
    width: conf and rounds equal to the plain version's, rounds == the
    depth, one launch a call."""
    from foundationdb_tpu_torch import kernels as K
    args = general_chain_inputs(t_cap, r_cap, w_cap, log_u, depth)
    K.reset_counts()
    conf, rounds = fused.interval_fixpoint(*args, log_u)
    launches = K.LAUNCHES["interval_fixpoint"]
    conf_p, rounds_p = fused.interval_fixpoint(*args, log_u, impl="plain")
    err = require_equal("interval_fixpoint deep chain", conf, conf_p)
    if not int(rounds.item()) == int(rounds_p.item()) == depth:
        raise AssertionError(f"general deep chain: {int(rounds.item())} "
                             f"rounds, plain {int(rounds_p.item())}, depth "
                             f"{depth}")
    row = {"depth": depth, "rounds": int(rounds.item()),
           "launches_per_call": launches, "max_abs_err": err,
           "ms": device_ms(lambda: fused.interval_fixpoint(*args, log_u),
                           counter="interval_fixpoint"),
           "plain_ms": cuda_ms(lambda: fused.interval_fixpoint(
               *args, log_u, impl="plain"), reps=1)}
    log(f"interval_fixpoint deep chain: {row['rounds']} rounds, bit-equal; "
        f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms")
    return row


def merge_bytes(size: int, dsize: int, cap: int, d_cap: int) -> int:
    """Least bytes of one merge: the live rows of both tiers read once (a
    32-byte row and its version), the whole base and delta written once,
    the three scalars."""
    return 36 * (size + dsize + cap + d_cap) + 12


def merge_state(cap: int, d_cap: int, n_b: int, n_d: int, seed: int = 5,
                shared: float = 0.3) -> dict:
    """A synthetic merge input on the card: a base of n_b + 1 live rows
    and a delta of n_d + 1 (each from the zero row, then distinct sorted
    digests, MAX rows past them), a `shared` fraction of the delta's rows
    equal to base rows; base versions in [0, 4000), delta in [3000,
    6000), NEG_INF past the live rows; the base table built."""
    import torch
    from foundationdb_tpu_torch.ops.rangemax import (NEG_INF,
                                                     build_sparse_table)
    rng = np.random.default_rng(seed)

    def rows(n, prefix):
        keys = np.unique(rng.integers(0, 1 << 62, size=n + n // 8 + 8,
                                      dtype=np.int64))
        keys = np.sort(rng.permutation(keys)[:n]).astype(np.uint64) * 2 + 1
        out = np.full((n, 8), prefix, np.uint32)
        out[:, 6] = (keys >> np.uint64(32)).astype(np.uint32)
        out[:, 7] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        return out

    def tier(live, cap_, lo, hi):
        k = np.full((cap_, 8), 0xFFFFFFFF, np.uint32)
        k[0] = 0
        k[1:1 + live.shape[0]] = live
        v = np.full(cap_, NEG_INF, np.int32)
        v[:1 + live.shape[0]] = rng.integers(lo, hi, 1 + live.shape[0])
        return (torch.from_numpy(k.view(np.int32)).to(DEVICE),
                torch.from_numpy(v).to(DEVICE), 1 + live.shape[0])

    b_rows = rows(n_b, 0x6B303030)
    n_sh = min(int(shared * n_d), n_b)
    pool = np.concatenate([b_rows[rng.choice(n_b, n_sh, replace=False)],
                           rows(n_d - n_sh, 0x6B303031)])
    d_rows = pool[np.lexsort(pool.T[::-1])]
    bk, bv, size = tier(b_rows, cap, 0, 4000)
    dk, dv, dsize = tier(d_rows, d_cap, 3000, 6000)

    def scalar(x):
        return torch.tensor([x], dtype=torch.int32, device=DEVICE)

    return {"bk": bk, "bv": bv, "table": build_sparse_table(bv),
            "size": scalar(size), "dk": dk, "dv": dv, "dsize": scalar(dsize),
            "flag": scalar(0)}


def merge_at(what: str, state: dict, cap: int, d_cap: int, scalars,
             first=None, expect_launches=3, reps: int = REPS) -> dict:
    """The merge on copies of `state` (bk, bv, table, size, dk, dv, dsize,
    flag), kernel against plain: its launches a call (with
    expect_launches, exactly that many of its own and at most 4 + 2 with
    the base table's), its own kernels' device ms, the plain version's
    ms and the byte bound."""
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.conflict import fused

    def run(impl, st):
        m = fused.make_merge_step(cap, d_cap, impl=impl)
        return m(st["bk"], st["bv"], st["table"], st["size"], st["dk"],
                 st["dv"], st["dsize"], st["flag"], scalars, first)

    def copy():
        return {k: v.clone() for k, v in state.items()}

    K.reset_counts()
    got = run("kernel", copy())
    own, table = K.LAUNCHES["merge"], K.LAUNCHES["build_sparse_table"]
    total = sum(K.LAUNCHES.values())
    if expect_launches is not None and (
            own != expect_launches or own + table > 4 + 2 or total != own
            + table):
        raise AssertionError(f"merge {what}: {own} launches of its own, "
                             f"{table} of the table, {total} in all")
    err = require_equal(f"merge {what}", got, run("plain", copy()))
    holder = {}

    def setup():
        holder["st"] = copy()

    size, dsize = int(state["size"][0]), int(state["dsize"][0])
    row = {"shape": what, "cap": cap, "d_cap": d_cap, "size": size,
           "dsize": dsize, "launches_per_call": own,
           "launches_with_table": total, "max_abs_err": err,
           "ms": device_ms(lambda: run("kernel", holder["st"]), reps=reps,
                           setup=setup, counter="merge"),
           "plain_ms": cuda_ms(lambda: run("plain", holder["st"]), reps=1,
                               setup=setup),
           "bound_ms": bound_ms(merge_bytes(size, dsize, cap, d_cap))}
    log(f"merge at {what} ({size} + {dsize} rows into {cap}): bit-equal, "
        f"{own} launches ({total} with the table); own {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms")
    return row


# Counters of the wrappers the old inserts ran inside them; the range
# insert moves none of them beyond _union_ranges' own.
INSERT_SHARED = ("inclusive_scan", "sort_rows", "searchsorted",
                 "compact_rows", "union_ranges")
INSERT_LAUNCHES = {"point": 4, "window": 3}


def insert_bytes(n_old: int, n_new: int, q_bytes: int) -> int:
    """Least bytes of a range insert: its inputs besides the tier read once
    (q_bytes), the live rows read once, the result written once and
    [new, old) refilled (36 bytes a row: the key and its version).  The
    rows the ranges' searches read are live rows, so a merge-style insert
    that reads every live row once needs no search."""
    return q_bytes + 36 * (n_old + n_new + max(n_old - n_new, 0))


def insert_at(what: str, kind: str, state: dict, args: tuple,
              expect_launches=True, reps: int = REPS) -> dict:
    """The point insert (kind "point": args u_k, u_e, w_uid, w_ins, now,
    u_own) or window_insert ("window": args w_b, w_e, w_valid, now) on
    copies of `state` (k, v, size, flag, bsize), kernel against plain: its
    launches a call (with expect_launches, INSERT_LAUNCHES[kind] of its
    own and no launch of INSERT_SHARED beyond _union_ranges'), its own
    kernels' device ms, the whole call's, the plain version's ms, the
    bound over live rows and that of an insert by full-capacity passes
    (the delta read and rewritten, as the reference's histograms, scans
    and scatters do)."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.conflict import fused, window
    counter = f"{kind}_insert"

    def run(impl, st):
        tail = torch.zeros((3,), dtype=torch.int32, device=DEVICE)
        if kind == "point":
            u_k, u_e, w_uid, w_ins, now, u_own = args
            fused._point_insert(st["k"], st["v"], st["size"], u_k, u_e,
                                w_uid, w_ins, now, st["flag"],
                                bsize=st["bsize"], tail=tail, impl=impl,
                                u_own=u_own)
        else:
            w_b, w_e, w_valid, now = args
            window.window_insert(window.WindowState(st["k"], st["v"],
                                                    st["size"]),
                                 w_b, w_e, w_valid, now, flag=st["flag"],
                                 bsize=st["bsize"], tail=tail, impl=impl)
        return st["k"], st["v"], st["size"], st["flag"], tail

    def copy():
        return {k: v.clone() for k, v in state.items()}

    K.reset_counts()
    got = run("kernel", copy())
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    own = counts[counter]
    if expect_launches:
        alone = {c: 0 for c in INSERT_SHARED}
        if kind == "window":
            K.reset_counts()
            window._union_ranges(*args[:3])
            alone = {c: K.LAUNCHES[c] for c in INSERT_SHARED}
        moved = {c: counts[c] - alone[c] for c in INSERT_SHARED
                 if counts[c] != alone[c]}
        if own != INSERT_LAUNCHES[kind] or moved:
            raise AssertionError(f"{counter} {what}: {own} launches of its "
                                 f"own, other counters moved: {moved}")
    err = require_equal(f"{counter} {what}", got, run("plain", copy()))
    holder = {}

    def setup():
        holder["st"] = copy()

    k, v = state["k"], state["v"]
    n_old, n_new = int(state["size"][0]), int(got[2][0])
    w = args[0].shape[0]
    # The ranges in (the merged ones, as large as the writes), and for the
    # point insert the unique keys, the writes and the owned mask.
    q_bytes = (nbytes(*args[:2]) if kind == "window"
               else nbytes(*[a for a in args if a is not None]))
    n_in = 3 if kind == "window" else 4
    row = {"shape": what, "cap": k.shape[0], "ranges": w, "size": n_old,
           "new_size": n_new, "launches_per_call": own, "max_abs_err": err,
           "ms": device_ms(lambda: run("kernel", holder["st"]), reps=reps,
                           setup=setup, counter=counter),
           "whole_ms": device_ms(lambda: run("kernel", holder["st"]),
                                 reps=reps, setup=setup),
           "plain_ms": cuda_ms(lambda: run("plain", holder["st"]), reps=2,
                               setup=setup),
           "bound_ms": bound_ms(insert_bytes(n_old, n_new, q_bytes)),
           "full_cap_bound_ms": bound_ms(nbytes(*args[:n_in])
                                         + 2 * nbytes(k, v))}
    log(f"{counter} at {what} ({n_old} -> {n_new} rows of {k.shape[0]}, {w} "
        f"ranges): bit-equal, {own} launches; own {row['ms']:.4f} ms, whole "
        f"call {row['whole_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms (full-capacity passes "
        f"{row['full_cap_bound_ms']:.4f})")
    return row


def insert_row(name: str, at: dict) -> dict:
    """A kernels-line row from an insert_at entry (kept under at_shapes)."""
    from foundationdb_tpu_torch import kernels as K
    src, ref = K.KERNELS[name]
    return {"name": name, "route": "cuda",
            "source": f"foundationdb_tpu_torch/csrc/{src}.cu",
            "replaces": ref, "launches": 0,
            "max_abs_err": at["max_abs_err"], "ms": at["ms"],
            "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "at_shapes": [at]}


def union_bytes(w_b, w_e, w_valid, union) -> int:
    """Least bytes of _union_ranges without its sort: wu_endpoints reads
    the ranges and the mask and writes the 2w endpoint rows, their tie and
    delta, and mb and me as MAX rows; wu_sweep reads the sorted deltas,
    reads each merged start's and end's row once (their writes into mb and
    me are the MAX rows' bytes, counted once), and writes m_incl.  `union`
    is the call's (mb, me, m_incl): the starts are m_incl[-1], the ends
    the rows of me that are not MAX."""
    mb, me, m_incl = union
    w = w_b.shape[0]
    marked = (int(m_incl[-1]) + int((me != -1).any(1).sum())) if w else 0
    return (nbytes(w_b, w_e, w_valid) + 2 * w * (32 + 4 + 4) + 2 * w * 32
            + 2 * w * 4 + 32 * marked + 2 * w * 4)


def union_at(what: str, w_b, w_e, w_valid, expect_launches=True,
             reps: int = REPS) -> dict:
    """_union_ranges on one batch's writes, kernel against plain: its
    launches a call by counter (with expect_launches: wu_endpoints and
    wu_sweep, the sort's, nothing else), its own kernels' device ms (the
    union_ranges counter), the whole call's, the sort's own, the call
    without the sort (whole - sort: every other launch and fill of the
    call and the gaps between them, as a commit's union pays it), every
    counted launch's but the sort's, summed, the plain version's ms and
    the bound (union_bytes).  Every time is taken behind the stream's
    sleep (device_ms), each launch between a pair of events."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.conflict import window

    def run(impl=None):
        return window._union_ranges(w_b, w_e, w_valid, impl)

    K.reset_counts()
    got = run()
    torch.cuda.synchronize()
    counts = {k: v for k, v in K.LAUNCHES.items() if v}
    if expect_launches and (counts.get("union_ranges") != 2
                            or set(counts) - {"union_ranges", "sort_rows"}):
        raise AssertionError(f"union_ranges {what}: launches {counts}")
    want = run("plain")
    err = require_equal(f"union_ranges {what}", got, want)
    whole = device_ms(run, reps=reps)
    sort = device_ms(run, reps=reps, counter="sort_rows")
    row = {"shape": what, "ranges": w_b.shape[0],
           "valid": int(w_valid.sum()), "merged": int(got[2][-1]),
           "launches_per_call": counts, "max_abs_err": err,
           "ms": device_ms(run, reps=reps, counter="union_ranges"),
           "whole_ms": whole, "sort_ms": sort,
           "without_sort_ms": whole - sort,
           # Every counted launch of the call but the sort's, each between
           # its own events (torch's fills are not counted launches).
           "launches_but_sort_ms": sum(
               device_ms(run, reps=reps, counter=c) for c in counts
               if c != "sort_rows"),
           "plain_ms": cuda_ms(lambda: run("plain"), reps=2),
           "bound_ms": bound_ms(union_bytes(w_b, w_e, w_valid, want))}
    log(f"union_ranges at {what} ({row['valid']} of {row['ranges']} ranges "
        f"-> {row['merged']}): bit-equal, launches {counts}; own "
        f"{row['ms']:.4f} ms, whole call {whole:.4f} ms, its sort "
        f"{sort:.4f} ms, without the sort {row['without_sort_ms']:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms")
    return row


def key_rows(ids):
    """Digest rows int32[n, 8] (CPU) of the 15-byte keys b"k%014d" % id."""
    import torch
    from foundationdb_tpu_torch.ops.digest import encode_fixed, planar_to_rows
    ids = np.asarray(ids, dtype=np.int64)
    mat = np.empty((ids.size, 15), dtype=np.uint8)
    mat[:, 0] = ord("k")
    x = ids.copy()
    for d in range(14):
        mat[:, 14 - d] = 48 + x % 10
        x //= 10
    return torch.from_numpy(planar_to_rows(encode_fixed(mat)))


def key_tier(rng, cap: int, n_live: int):
    """A cap-row tier on the card: the zero digest, then n_live - 1 sorted
    distinct keys of ids below 10^9 (key_rows), MAX rows past them; random
    versions in [0, 5000), NEG_INF past the live rows.  (k, v)."""
    import torch
    from foundationdb_tpu_torch.ops.digest import max_rows
    from foundationdb_tpu_torch.ops.rangemax import NEG_INF
    ids = np.sort(rng.choice(10 ** 9, size=n_live - 1, replace=False))
    k = max_rows(cap, "cpu")
    k[0] = 0
    k[1:n_live] = key_rows(ids)
    v = torch.full((cap,), NEG_INF, dtype=torch.int32)
    v[:n_live] = torch.from_numpy(rng.integers(0, 5000, n_live,
                                               dtype=np.int32))
    return k.to(DEVICE), v.to(DEVICE)


def insert_state(kind: str, cap: int, n_live: int, n_ranges: int,
                 n_valid: int, seed: int = 9, u_pad=None, w_pad=None,
                 owned=None):
    """Synthetic inputs of insert_at at a path's shape: a tier of n_live
    sorted rows (key_tier) in a cap-row tier, and for "point" n_valid
    unique keys sorted in u_pad slots (MAX padded), their ends a zero byte
    on, w_pad writes over them about 70% surviving (u_own: an `owned`
    share of the keys, when given); for "window" n_ranges ranges of 1-100
    records, the first n_valid valid.  Returns (state, args)."""
    import torch
    from foundationdb_tpu_torch.ops.digest import max_rows
    rng = np.random.default_rng(seed)
    k, v = key_tier(rng, cap, n_live)
    dev = lambda t: t.to(DEVICE)
    state = {"k": k, "v": v,
             "size": dev(torch.tensor([n_live], dtype=torch.int32)),
             "flag": dev(torch.zeros((1,), dtype=torch.int32)),
             "bsize": dev(torch.tensor([1 << 20], dtype=torch.int32))}
    now = dev(torch.tensor([6000], dtype=torch.int32))
    if kind == "point":
        u_k = max_rows(u_pad, "cpu")
        u_k[:n_valid] = key_rows(np.sort(rng.choice(10 ** 9, size=n_valid,
                                                    replace=False)))
        u_e = u_k.clone()
        u_e[:n_valid, 7] += 1
        w_uid = torch.from_numpy(rng.integers(0, n_valid, w_pad,
                                              dtype=np.int32))
        w_ins = torch.from_numpy((rng.random(w_pad) < 0.7).astype(np.int32))
        u_own = None if owned is None else dev(torch.from_numpy(
            (rng.random(u_pad) < owned).astype(np.int32)))
        return state, (dev(u_k), dev(u_e), dev(w_uid), dev(w_ins), now,
                       u_own)
    a = rng.integers(0, 10 ** 9 - 100, size=n_ranges)
    s = rng.integers(1, 101, size=n_ranges)
    valid = (np.arange(n_ranges) < n_valid).astype(np.int32)
    return state, (dev(key_rows(a)), dev(key_rows(a + s)),
                   dev(torch.from_numpy(valid)), now)


# The range probes' shapes on the paths, for probe_state: (what, wrapper,
# path, capacity and live rows of the base (the window) and of the delta,
# query slots, live queries, point or 1-100-record ranges, owned share).
# Live rows are those of the warmed states chip_smoke.py builds (config 2:
# 9,765 and 3,343; config 3: 213,442 and 63,553, the window 540,494), the
# config-5 shard's as phase 9 finds shard 1 (97,495 and 32,305), and the
# sharded window's: on config 3's keys one shard holds every row and every
# valid query (the config3 row's shape) and three are empty, none of
# their queries valid; spread traffic gives each ~110,000 rows and a
# quarter of the queries.
PROBE_SHAPES = [
    ("config2", "history_probe", "point",
     (1 << 21, 9_765), (1 << 20, 3_343), 49_152, 47_733, "point", None),
    ("config3_general", "history_probe", "general",
     (1 << 21, 213_442), (1 << 20, 63_553), 524_288, 400_000, "range", None),
    ("config5_shard", "history_probe", "sharded",
     (1 << 20, 97_495), (1 << 18, 32_305), 196_608, 190_000, "point", 0.25),
    ("config3", "window_query", "window",
     (1 << 21, 540_494), None, 400_000, 400_000, "range", None),
    ("sharded_window_empty", "window_query", "sharded_window",
     (1 << 21, 1), None, 400_000, 400_000, "range", 0.0),
    ("sharded_window_spread", "window_query", "sharded_window",
     (1 << 21, 110_000), None, 400_000, 400_000, "range", 0.25),
]


def probe_state(base, delta, slots: int, n_live: int, kind: str, owned,
                seed: int = 11):
    """Synthetic inputs of one PROBE_SHAPES row, built as insert_state
    builds its tiers (key_tier): the tiers and their sparse tables, then
    `slots` query slots whose first n_live hold queries (point keys sorted
    and unique, their ends a zero byte on; or ranges of 1-100 records in
    random order), MAX rows past them; the owned share (a random mask,
    when given; all live otherwise), snapshots in [0, 5000).  A dict of
    the probe's arguments."""
    import torch
    from foundationdb_tpu_torch.ops.digest import max_rows
    from foundationdb_tpu_torch.ops.rangemax import build_sparse_table
    rng = np.random.default_rng(seed)
    st = {}
    st["bk"], st["bv"] = key_tier(rng, *base)
    st["table"] = build_sparse_table(st["bv"], impl="plain")
    if delta is not None:
        st["dk"], st["dv"] = key_tier(rng, *delta)
        st["dtable"] = build_sparse_table(st["dv"], impl="plain")
    q_b, q_e = max_rows(slots, "cpu"), max_rows(slots, "cpu")
    if kind == "point":
        q_b[:n_live] = key_rows(np.sort(rng.choice(10 ** 9, size=n_live,
                                                   replace=False)))
        q_e[:n_live] = q_b[:n_live]
        q_e[:n_live, 7] += 1
    else:
        a = rng.integers(0, 10 ** 9 - 100, size=n_live)
        q_b[:n_live] = key_rows(a)
        q_e[:n_live] = key_rows(a + rng.integers(1, 101, size=n_live))
    live = np.arange(slots) < n_live
    if owned is not None:
        live &= rng.random(slots) < owned
    st["q_b"], st["q_e"] = q_b.to(DEVICE), q_e.to(DEVICE)
    st["live"] = torch.from_numpy(live.astype(np.int32)).to(DEVICE)
    st["snap"] = torch.from_numpy(rng.integers(0, 5000, slots,
                                               dtype=np.int32)).to(DEVICE)
    return st


def probe_bytes_of(tiers, q_bytes: int, n_searches: int, n_ranges: int,
                   n_out: int) -> int:
    """Least bytes of a range probe: the query bytes it must read
    (q_bytes), its output (4 bytes a slot), per tier the rows n_searches
    binary searches touch (search_bytes) and two range-max gathers per
    range searched.  A range's begin and end searches count once: they
    walk the same rows but where a live boundary lies inside the range
    (never, for a point range; rarely, for 1-100 records of 50M)."""
    return (q_bytes + 4 * n_out + sum(search_bytes(t, n_searches)
                                      for t in tiers)
            + 8 * n_ranges * len(tiers))


def probe_at(what: str, name: str, path: str, fn, n_bytes: int,
             reps: int = REPS, **info) -> dict:
    """history_probe or window_query (`name`) at one of its shapes: kernel
    against plain (fn(impl)), its launches a call, its own kernels'
    device ms, the plain version's ms and the byte bound; `path` is the
    path that runs it at this shape."""
    from foundationdb_tpu_torch import kernels as K
    K.reset_counts()
    got = fn("kernel")
    launches = K.LAUNCHES[name]
    err = require_equal(f"{name} {what}", got, fn("plain"))
    row = {"shape": what, "path": path, **info,
           "launches_per_call": launches, "max_abs_err": err,
           "ms": device_ms(lambda: fn("kernel"), reps=reps, counter=name),
           "plain_ms": cuda_ms(lambda: fn("plain"), reps=2),
           "bound_ms": bound_ms(n_bytes)}
    log(f"{name} at {what}: bit-equal, {launches} launch(es); own "
        f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms")
    return row


def probe_inputs(what: str, slots=None):
    """The synthetic inputs of PROBE_SHAPES' row `what` (with `slots`, only
    that many query slots, as many live as fit): (wrapper name, path,
    fn(impl), bound bytes, info).  A masked probe (an owned share, or
    window_query's valid mask) needs the rows of its live queries only."""
    from foundationdb_tpu_torch.conflict import window
    from foundationdb_tpu_torch.ops import digest
    _, name, path, base, delta, n_slots, n_live, kind, owned = next(
        r for r in PROBE_SHAPES if r[0] == what)
    slots = n_slots if slots is None else slots
    st = probe_state(base, delta, slots, min(n_live, slots), kind, owned)
    n_q = int(st["live"].sum())
    if name == "history_probe":
        own = None if owned is None else st["live"]

        def fn(i):
            return digest.history_probe(st["bk"], st["table"], st["dk"],
                                        st["dtable"], st["q_b"], st["q_e"],
                                        i, own=own)
        n_q = slots if own is None else n_q
        n_bytes = probe_bytes_of((st["bk"], st["dk"]), 64 * n_q + (
            0 if own is None else 4 * slots), n_q, n_q, slots)
    else:
        def fn(i):
            return window.window_query(st["bk"], st["bv"], st["q_b"],
                                       st["q_e"], st["snap"], st["live"],
                                       impl=i)
        # The valid mask, and each valid query's ends and snapshot.
        n_bytes = probe_bytes_of((st["bk"],), 68 * n_q + 4 * slots,
                                 n_q, n_q, slots)
    info = {"cap": st["bk"].shape[0], "slots": slots, "searched": n_q}
    return name, path, fn, n_bytes, info


def probe_case(what: str, reps: int = REPS) -> dict:
    """probe_at on the synthetic inputs of PROBE_SHAPES' row `what`."""
    name, path, fn, n_bytes, info = probe_inputs(what)
    return probe_at(what, name, path, fn, n_bytes, reps=reps, **info)


def _fix_codes(fused, rw_in, u_pad, scal, too_old, impl):
    """The compact step's resolve: the fixpoint with the codes (conf,
    rounds, the insert mask, the codes)."""
    import torch
    codes = torch.empty(too_old.shape, dtype=torch.int8, device=DEVICE)
    return (*fused.intra_batch_fixpoint(*rw_in, u_pad, impl, codes_out=codes,
                                        scal=scal, too_old=too_old), codes)


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
    drive = drive_point(cs, batches)
    rate, p50, merges = drive["rate"], drive["p50_ms"], drive["merges"]
    results = drive["codes"][N_WARMUP:N_WARMUP + N_MEASURED]
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
    return launches, path, batches[:N_WARMUP + N_MEASURED + N_LATENCY]


# ------------------------------------------------------- config 3 phases
def rows_of(planar):
    import torch
    from foundationdb_tpu_torch.ops.digest import planar_to_rows
    return torch.from_numpy(planar_to_rows(planar)).to(DEVICE)


def window_inputs(enc, base: int):
    """The window path's view of a batch: every read with its txn's
    snapshot, every write, all valid; versions relative to `base`."""
    import torch
    nr, nw = enc.r_txn.shape[0], enc.w_txn.shape[0]
    snap = (enc.t_snap[enc.r_txn] - base).astype(np.int32)
    ones = torch.ones((max(nr, nw),), dtype=torch.int32, device=DEVICE)
    return (rows_of(enc.r_begin), rows_of(enc.r_end),
            torch.from_numpy(snap).to(DEVICE), ones[:nr],
            rows_of(enc.w_begin), rows_of(enc.w_end), ones[:nw])


def warmed_general_state():
    """A backend on the card after 3 config-3 batches and a merge, one more
    batch (the delta non-empty) and the next batch packed and stamped; a
    window (path 3) holding the same 5 batches' writes; the stream."""
    import torch
    from foundationdb_tpu_torch.conflict import window
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
    cs = TorchConflictSet(0, capacity=CAPACITY, delta_capacity=DELTA_CAPACITY,
                          device=DEVICE)
    stream = make_stream3(np.random.default_rng(17), 6)
    for v, enc, _ in stream[:3]:
        cs.resolve_encoded_async(enc, v, floor(v)).wait_codes()
    cs.merge()
    v, enc, _ = stream[3]
    cs.resolve_encoded_async(enc, v, floor(v)).wait_codes()
    v, enc, _ = stream[4]
    packed = cs._pack(enc)
    cs._stamp(packed, v, cs.oldest_version, enc.n_txns)
    cs.oldest_version = floor(v)
    cs.synchronize()
    win = window.make_window_state(CAPACITY, 0, DEVICE)
    for v, enc, _ in stream[:5]:
        *_, wb, we, wv = window_inputs(enc, 0)
        window.window_insert(win, wb, we, wv, v)
    torch.cuda.synchronize()
    return cs, packed, win, stream


def compare_general(cs, packed, win, stream):
    """Each new wrapper, kernel against plain at config-3 shapes, and the
    programs #4-#7."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.conflict import fused, window
    from foundationdb_tpu_torch.ops import digest
    from foundationdb_tpu_torch.ops.sort import sort_rows
    P = "plain"
    t_cap, r_cap, w_cap = packed["caps"]
    n_rows = 2 * (r_cap + w_cap)
    buf = torch.from_numpy(packed["buf"]).to(DEVICE)
    digests = buf[:32 * n_rows].view(torch.int32).view(n_rows, 8)
    meta = buf[32 * n_rows:].view(torch.int32)
    m = fused.unpack_meta(meta, t_cap, r_cap, w_cap)
    r_b, r_e = digests[:r_cap], digests[r_cap:2 * r_cap]
    w_b = digests[2 * r_cap:2 * r_cap + w_cap]
    w_e = digests[2 * r_cap + w_cap:]

    # Intermediates of the general step, from the plain versions.
    vmax = digest.history_probe(cs.bk, cs.table, cs.dk, cs.dtable, r_b, r_e,
                                P)
    g, fix_in, log_u = general_fixpoint_inputs(digests, m, vmax)
    conf, rounds, w_ins, codes = _fix_codes3(fused, fix_in, log_u, m, g, P)
    log(f"config 3: {int(rounds[0])} Jacobi rounds on this batch, "
        f"{int(w_ins.sum())} surviving writes of {int(m['w_valid'].sum())}")
    # Path 3's inputs: the next batch's reads against the window of the
    # five before it; its writes.
    v5, enc5, _ = stream[5]
    q_b, q_e, q_snap, q_valid, ww_b, ww_e, ww_valid = window_inputs(enc5, 0)
    nq = q_b.shape[0]
    now5 = torch.tensor([v5], dtype=torch.int32, device=DEVICE)

    def delta_copy():
        return {k: getattr(cs, k).clone() for k in
                ("bk", "bv", "table", "size", "dk", "dv", "dtable", "dsize",
                 "flag")}

    def win_copy():
        return {"bk": win.bk.clone(), "bv": win.bv.clone(),
                "size": win.size.clone()}

    def gc_run(impl, st):
        return tuple(window.window_gc(window.WindowState(
            st["bk"], st["bv"], st["size"]), floor(v5), floor(v5), impl=impl))

    # window_gc's least bytes at this state (gc_bytes), beside the bound
    # of wg_keep, the keep-mask kernel of the earlier multi-launch
    # window_gc: the versions in and a keep mask out.
    win_gc_bytes = gc_bytes(win, floor(v5), floor(v5))
    log(f"window_gc: bound {bound_ms(win_gc_bytes):.5f} ms (the in-place "
        f"call's least bytes, gc_bytes) against the old row's "
        f"{bound_ms(nbytes(win.bv) + 4 * CAPACITY):.5f} (wg_keep's alone)")

    def win_insert_run(impl, st):
        st2, ovf = window.window_insert(window.WindowState(
            st["bk"], st["bv"], st["size"]), ww_b, ww_e, ww_valid, now5,
            impl=impl)
        return (*st2, ovf)

    def step_run(impl, st):
        step = fused.make_resolve_step(CAPACITY, cs.d_cap, t_cap, r_cap,
                                       w_cap, impl=impl)
        return step(st["bk"], st["bv"], st["table"], st["size"], st["dk"],
                    st["dv"], st["dtable"], st["dsize"], st["flag"],
                    digests, meta)

    def query_run(impl):
        return window.window_query(win.bk, win.bv, q_b, q_e, q_snap, q_valid,
                                   impl=impl)

    meta_in = [m[k] for k in ("r_txn", "r_valid", "w_txn", "w_valid",
                              "t_snap", "t_has_reads", "t_valid")]
    bits = query_run("kernel")
    # The general step's endpoint placement: its universe (the batch's
    # rows sorted, MAX padded), every row of the batch a query.
    universe = endpoint_universe(digests)
    placed = digest.searchsorted(universe, digests, True, P)
    # name -> (fn(impl) or (run, state copy), least bytes); no single
    # PyTorch call computes any of these functions (library_ms null).
    cases = {
        # The table rows a batch of searches touches (search_bytes), the
        # queries in and the positions out.
        "searchsorted": (lambda i: digest.searchsorted(universe, digests,
                                                       True, i),
                         search_bytes(universe, n_rows)
                         + nbytes(digests, placed)),
        # Rows in once and out once (the permutation is scratch).
        "sort_rows": (lambda i: sort_rows(digests, impl=i)[0],
                      2 * nbytes(digests)),
        "general_prep": (lambda i: fused.general_prep(m, vmax, i),
                         nbytes(*meta_in, vmax, *g.values())),
        # Conf, the round count, the codes and the insert mask (the
        # fixpoint's last phase, general_codes); the bound is one pass over
        # the inputs, the codes' inputs and the outputs, whatever the
        # rounds (see the row's "rounds").
        "interval_fixpoint": (
            lambda i: _fix_codes3(fused, fix_in, log_u, m, g, i),
            nbytes(*fix_in, conf, m["t_valid"], g["too_old"], m["w_valid"],
                   codes, w_ins)),
        # wu_endpoints and wu_sweep (union_bytes: the sort's bytes are
        # sort_rows' row).
        "union_ranges": (lambda i: window._union_ranges(w_b, w_e, w_ins, i),
                         union_bytes(w_b, w_e, w_ins,
                                     window._union_ranges(w_b, w_e, w_ins,
                                                          P))),
        # wq_query: the queries in, the bits out, the table rows a batch of
        # searches touches (a range's two searches once, probe_bytes_of),
        # two range-max gathers per query.
        "window_query": (query_run,
                         nbytes(q_b, q_e, q_snap, q_valid, bits)
                         + search_bytes(win.bk, nq) + 8 * nq),
        # wg_gc, in place: gc_bytes (the live versions in, the kept rows
        # from the first dropped one on moved, the freed rows refilled).
        "window_gc": ((gc_run, win_copy), win_gc_bytes),
    }
    rows = []
    for name, (fn, n_bytes) in cases.items():
        if isinstance(fn, tuple):
            run, copy_fn = fn
            holder = {}

            def setup(copy_fn=copy_fn, holder=holder):
                holder["st"] = copy_fn()

            def go(i, run=run, holder=holder):
                return run(i, holder["st"])

            setup()
            got = go("kernel")
            want = run("plain", copy_fn())
            err = require_equal(name, got, want)
            ms = device_ms(lambda: go("kernel"), setup=setup, counter=name)
            plain = cuda_ms(lambda: go("plain"), reps=2, setup=setup)
        else:
            got = fn("kernel")
            err = require_equal(name, got, fn("plain"))
            ms = device_ms(lambda: fn("kernel"), counter=name)
            plain = cuda_ms(lambda: fn("plain"), reps=2)
        src, ref = K.KERNELS[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"foundationdb_tpu_torch/csrc/{src}.cu",
                     "replaces": ref, "launches": 0, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain,
                     "bound_ms": bound_ms(n_bytes), "bound_by": "bytes",
                     "library_ms": None})
        log(f"{name}: bit-equal; own kernels {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bound_ms(n_bytes):.4f} ms")

    # window_insert on the general step's warmed delta (its row), and on
    # path 3's window with the next batch's writes (insert_at).
    ins = insert_row("window_insert", insert_at(
        "config3_delta", "window", {"k": cs.dk, "v": cs.dv, "size": cs.dsize,
                                    "flag": cs.flag, "bsize": cs.size},
        (w_b, w_e, w_ins, m["now_rel"])))
    ins["at_shapes"].append(insert_at(
        "window_2_21", "window", {"k": win.bk, "v": win.bv, "size": win.size,
                                  "flag": torch.zeros_like(win.size),
                                  "bsize": win.size.clone()},
        (ww_b, ww_e, ww_valid, now5)))
    rows.append(ins)
    # The whole union without its sort, on the general step's writes and
    # on the window path's (union_at).
    uni = next(r for r in rows if r["name"] == "union_ranges")
    uni["at_shapes"] = [union_at("config3_general", w_b, w_e, w_ins),
                        union_at("window_2_21", ww_b, ww_e, ww_valid)]
    srch = next(r for r in rows if r["name"] == "searchsorted")
    K.reset_counts()
    digest.searchsorted(universe, digests, True)
    srch.update(launches_per_call=K.LAUNCHES["searchsorted"],
                table_rows=universe.shape[0], queries=n_rows)
    if srch["launches_per_call"] != 1:
        raise AssertionError(f"searchsorted: {srch['launches_per_call']} "
                             "launches a call")
    del universe, placed
    next(r for r in rows if r["name"] == "general_prep").update(
        one_operation("general_prep", lambda: fused.general_prep(m, vmax)))
    fix = next(r for r in rows if r["name"] == "interval_fixpoint")
    fix["rounds"] = int(rounds[0])
    fix.update(one_operation("interval_fixpoint", lambda: _fix_codes3(
        fused, fix_in, log_u, m, g, None)))
    # The fixpoint alone (no codes), its own kernel's time.
    fix["alone_ms"] = device_ms(lambda: fused.interval_fixpoint(
        *fix_in, log_u), counter="interval_fixpoint")
    log(f"interval_fixpoint: with the codes {fix['ms']:.5f} ms, alone "
        f"{fix['alone_ms']:.5f} ms")
    # window_gc on its own copy of the window, called again and again (a
    # gc of a gc'd window drops nothing more and rebases again).
    gc_state = win_copy()
    gc_row = next(r for r in rows if r["name"] == "window_gc")
    gc_row.update(one_operation("window_gc", lambda: gc_run(None, gc_state)))
    gc_row["bound_ms_wg_keep"] = bound_ms(nbytes(win.bv) + 4 * CAPACITY)
    del gc_state
    # The gc at its floor moves no row (every version-0 boundary below it
    # is a written range's end, after its begin); 3,000 versions higher it
    # drops the first three batches' rows; on a synthetic 2^21 window it
    # moves rows in every chunk of its grid.
    gc_row["at_states"] = [
        gc_at("config3_window", win, floor(v5), floor(v5)),
        gc_at("config3_window_floor_plus_3000", win, floor(v5) + 3000,
              floor(v5) + 3000),
        gc_at("synthetic_2_21", gc_synthetic(CAPACITY, CAPACITY - 12_345,
                                             5000), 5000, 1234)]
    fix["deep_chain"] = general_deep_chain(fused, t_cap, r_cap, w_cap, log_u)

    from foundationdb_tpu_torch.ops.sort import sort_rounds
    srt = next(r for r in rows if r["name"] == "sort_rows")
    srt["at_inputs"] = sort_inputs(digests, r_cap, w_cap,
                                   int(m["w_valid"].sum()))
    for r in srt["at_inputs"]:
        if r["launches_per_call"] != 1 + 2 * sort_rounds(r["n"]):
            raise AssertionError(f"sort_rows {r['input']}: "
                                 f"{r['launches_per_call']} launches")
    abc = [r["ms"] for r in srt["at_inputs"] if r["input"] != "window"]
    srt["spread_abc"] = max(abc) / min(abc)
    log(f"sort_rows: slowest of (a), (b), (c) {srt['spread_abc']:.3f}x "
        f"the fastest")

    # A range's two searches count once (probe_bytes_of).
    probe_bytes = (nbytes(r_b, r_e, vmax) + search_bytes(cs.bk, r_cap)
                   + search_bytes(cs.dk, r_cap) + 4 * 4 * r_cap)
    programs = {}
    # The history probe at the general step's shape (every read slot
    # against the warmed tiers), and window_query's row at its shape.
    programs["history_probe_general"] = probe_at(
        "config3_general", "history_probe", "general",
        lambda i: digest.history_probe(cs.bk, cs.table, cs.dk, cs.dtable,
                                       r_b, r_e, i),
        probe_bytes_of((cs.bk, cs.dk), nbytes(r_b, r_e), r_cap, r_cap,
                       r_cap),
        cap=CAPACITY, slots=r_cap, searched=r_cap, size=int(cs.size[0]),
        dsize=int(cs.dsize[0]))
    wq = next(r for r in rows if r["name"] == "window_query")
    wq["at_shapes"] = [probe_at(
        "config3", "window_query", "window", query_run,
        probe_bytes_of((win.bk,), nbytes(q_b, q_e, q_snap, q_valid),
                       nq, nq, nq),
        cap=CAPACITY, slots=nq, searched=int(q_valid.sum()),
        size=int(win.size[0]))]
    for prog, run, copy_fn, n_bytes in (
            # The batch in, the history probe, the delta read and
            # rewritten, the codes and tail out.
            ("general_step", step_run, delta_copy,
             nbytes(digests, meta) + probe_bytes + 2 * nbytes(cs.dk, cs.dv)
             + t_cap + 12),
            # The versions and the table rows the searches touch in, the
            # queries in, the bits out.
            ("window_query", None, None,
             nbytes(win.bv, q_b, q_e, q_snap, q_valid, bits)
             + search_bytes(win.bk, nq)),
            ("window_insert", win_insert_run, win_copy,
             2 * nbytes(win.bk, win.bv) + nbytes(ww_b, ww_e, ww_valid)),
            ("window_gc", gc_run, win_copy, win_gc_bytes)):
        if run is None:
            def kern():
                query_run("kernel")

            setup = None
            plain = cuda_ms(lambda: query_run("plain"), 2)
        else:
            require_equal(prog, run("kernel", copy_fn()),
                          run("plain", copy_fn()))
            holder = {}

            def setup(holder=holder, copy_fn=copy_fn):
                holder["st"] = copy_fn()

            def kern(run=run, holder=holder):
                run("kernel", holder["st"])

            plain = cuda_ms(lambda: run("plain", holder["st"]), 2, setup)
        ms = cuda_ms(kern, setup=setup)
        dev_ms = device_ms(kern, setup=setup)
        programs[prog] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                          "bound_ms": bound_ms(n_bytes)}
        log(f"program {prog}: bit-equal; kernel {ms:.3f} ms "
            f"({dev_ms:.3f} ms without host gaps), plain {plain:.3f} ms")
    # Beside it, the whole state read and written once (the bound of the
    # earlier out-of-place window_gc).
    programs["window_gc"]["bound_ms_whole_state"] = bound_ms(
        2 * nbytes(win.bk, win.bv))
    return rows, programs


def _fix_codes3(fused, fix_in, log_u, m, g, impl):
    """interval_fixpoint with the codes (as GeneralStep.resolve calls it):
    (conf, rounds, w_ins, codes)."""
    import torch
    codes = torch.empty((m["t_valid"].shape[0],), dtype=torch.int8,
                        device=DEVICE)
    return (*fused.interval_fixpoint(
        *fix_in, log_u, impl=impl, codes_out=codes, t_valid=m["t_valid"],
        too_old=g["too_old"], w_valid=m["w_valid"]), codes)


def gc_synthetic(cap: int, size: int, oldest: int, seed: int = 3):
    """A window state of capacity cap with `size` live rows (sorted and
    unique: lane 0 the row index, the other lanes random) whose versions
    run alternately below and above `oldest` in runs of 1-4 rows, so
    window_gc drops ~30% of the rows, spread over every chunk of its grid;
    rows past size MAX at NEG_INF."""
    import torch
    from foundationdb_tpu_torch.conflict import window
    from foundationdb_tpu_torch.ops.rangemax import NEG_INF
    rng = np.random.default_rng(seed)
    rows = np.full((cap, 8), 0xFFFFFFFF, np.uint32)
    rows[:size, 0] = np.arange(size, dtype=np.uint32)
    rows[:size, 1:] = rng.integers(0, 1 << 32, size=(size, 7),
                                   dtype=np.uint64).astype(np.uint32)
    lengths = rng.integers(1, 5, size=size)
    run = np.repeat(np.arange(lengths.size) % 2 == 0, lengths)[:size]
    bv = np.full(cap, NEG_INF, np.int32)
    bv[:size] = np.where(run, rng.integers(oldest - 1000, oldest, size),
                         rng.integers(oldest, oldest + 1000, size))
    return window.WindowState(
        torch.from_numpy(rows.view(np.int32)).to(DEVICE),
        torch.from_numpy(bv).to(DEVICE),
        torch.tensor([size], dtype=torch.int32, device=DEVICE))


def gc_at(what: str, state, oldest_rel: int, rebase: int,
          reps: int = REPS) -> dict:
    """window_gc on copies of `state`, kernel against plain: live rows
    before and after, launches a call, own ms (the
    window_gc counter's launches), the whole call's device ms behind the
    sleep (any fill or copy of the call included), plain ms, the bound by
    gc_bytes."""
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.conflict import window
    holder = {}

    def setup():
        holder["st"] = window.WindowState(*(t.clone() for t in state))

    def run(impl=None):
        return tuple(window.window_gc(holder["st"], oldest_rel, rebase,
                                      impl=impl))

    setup()
    want = tuple(t.clone() for t in run("plain"))
    setup()
    K.reset_counts()
    got = run()
    launches = K.LAUNCHES["window_gc"]
    err = require_equal(f"window_gc at {what}", got, want)
    sz, new = int(state.size[0]), int(want[2][0])
    row = {"what": what, "size": sz, "new_size": new,
           "launches_per_call": launches, "max_abs_err": err,
           "ms": device_ms(run, reps=reps, setup=setup, counter="window_gc"),
           "call_ms": device_ms(run, reps=reps, setup=setup),
           "plain_ms": cuda_ms(lambda: run("plain"), reps=2, setup=setup),
           "bound_ms": bound_ms(gc_bytes(state, oldest_rel, rebase))}
    log(f"window_gc at {what} ({sz} -> {new} rows): bit-equal, "
        f"{launches} launch(es); own {row['ms']:.5f} ms, call "
        f"{row['call_ms']:.5f} ms, plain {row['plain_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.5f} ms")
    return row


def gc_bytes(state, oldest_rel: int, rebase: int) -> int:
    """Least bytes of window_gc in place on `state` (read from the plain
    keep mask): the live versions read, the prefix's versions rewritten
    when rebasing, each kept row from the first dropped one on read (32
    bytes) and written with its version (36), and the freed rows [new
    size, size) refilled (36 each)."""
    import torch
    sz = int(state.size[0])
    bv = state.bv[:sz]
    above = bv >= oldest_rel
    prev = torch.cat([torch.ones_like(above[:1]), above[:-1]])
    keep = above | prev
    if sz:
        keep[0] = True
    dropped = (~keep).nonzero()
    first = int(dropped[0]) if dropped.numel() else sz
    total = int(keep.sum())
    return (4 * sz + (4 * first if rebase else 0) + 68 * (total - first)
            + 36 * (sz - total))


def general_path(smi: str):
    """Path 2: TorchConflictSet on config 3 (and the launch counts of its
    run)."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
    log("generating the config-3 stream")
    batches = make_stream3(np.random.default_rng(2027),
                           N_WARMUP3 + N_MEASURED3 + N_LATENCY3)
    K.reset_counts()
    cs = TorchConflictSet(0, capacity=CAPACITY, delta_capacity=DELTA_CAPACITY,
                          device=DEVICE)
    for v, enc, _ in batches[:N_WARMUP3]:
        cs.resolve_encoded_async(enc, v, floor(v)).wait_codes()
    merges0 = cs.profile["merges"]
    cs.synchronize()
    rounds0 = int(cs.jacobi_rounds[0])
    inflight, results, n_ranges = deque(), [], 0
    t0 = time.perf_counter()
    for v, enc, _ in batches[N_WARMUP3:N_WARMUP3 + N_MEASURED3]:
        inflight.append((enc, cs.resolve_encoded_async(enc, v, floor(v))))
        if len(inflight) > DEPTH:
            e, h = inflight.popleft()
            results.append(h.wait_codes().copy())
            n_ranges += e.n_ranges
    while inflight:
        e, h = inflight.popleft()
        results.append(h.wait_codes().copy())
        n_ranges += e.n_ranges
    rate = n_ranges / (time.perf_counter() - t0)
    merges = cs.profile["merges"] - merges0
    cs.synchronize()
    rounds = (int(cs.jacobi_rounds[0]) - rounds0) / N_MEASURED3
    lats = []
    for v, enc, _ in batches[N_WARMUP3 + N_MEASURED3:]:
        t1 = time.perf_counter()
        cs.resolve_encoded_async(enc, v, floor(v)).wait_codes()
        lats.append(time.perf_counter() - t1)
    p50 = float(np.percentile(lats, 50) * 1e3)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    packs = []
    for _, enc, _ in batches[N_WARMUP3 + N_MEASURED3:]:
        t1 = time.perf_counter()
        TorchConflictSet._pack(enc)
        packs.append(time.perf_counter() - t1)
    pack_ms = float(np.percentile(packs, 50) * 1e3)
    commit_rate = float(np.mean([np.mean(r == 2) for r in results]))
    if merges < 1:
        raise AssertionError("the measured config-3 batches crossed no merge")
    if cs.profile["compact_batches"] or not cs.profile["general_batches"]:
        raise AssertionError("config 3 did not run on the general path")
    print(f"path_general: {rate:.1f} ranges/s at depth {DEPTH} over "
          f"{N_MEASURED3} batches ({merges} merges, {rounds:.2f} Jacobi "
          f"rounds per batch), p50 resolve {p50:.3f} ms at depth 1 (host "
          f"packing alone {pack_ms:.3f} ms), commit rate {commit_rate:.4f} "
          f"-- {smi}", flush=True)
    if not 0.05 <= commit_rate <= 0.95:
        raise AssertionError(f"config 3 contention out of range: "
                             f"{commit_rate}")
    path = {"ranges_per_s": rate, "p50_resolve_ms": p50,
            "p50_pack_ms": pack_ms, "commit_rate": commit_rate,
            "merges_measured": merges, "jacobi_rounds_per_batch": rounds,
            "batches_measured": N_MEASURED3, "depth": DEPTH,
            "txns_per_batch": TXNS3, "card": smi}
    return launches, path, batches


def small_stream3(seed: int):
    """Small batches of the config-3 generator, too-old snapshots
    included."""
    return make_stream3(np.random.default_rng(seed), N_ORACLE3,
                        RECORDS_SMALL, TXNS_SMALL, too_old=0.02)


def oracle_parity3(make_cs, stream, label: str = "parity_general"):
    """A backend's verdicts against the oracle, over the full 1,024-byte
    keys, on small batches of the config-3 generator."""
    from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet
    cs = make_cs()
    oracle = OracleConflictSet(0)
    seen = set()
    for i, (v, enc, draws) in enumerate(stream):
        want = np.asarray([int(x) for x in oracle.resolve(
            transactions3(draws), v, floor(v))], dtype=np.int8)
        got = cs.resolve_encoded_async(enc, v, floor(v)).wait_codes()
        bad = int(np.sum(got != want))
        if bad:
            raise AssertionError(f"{label}: {bad} verdicts differ from the "
                                 f"oracle on batch {i}")
        seen.update(int(c) for c in want)
    if seen != {0, 1, 2}:
        raise AssertionError(f"{label}: the batches lack a verdict: {seen}")
    print(f"{label}: verdicts equal the oracle on {N_ORACLE3} batches "
          f"of {TXNS_SMALL} txns over {RECORDS_SMALL} records (full "
          f"{KEY_BYTES}-byte keys; committed, conflicted and too-old txns)",
          flush=True)


def state_equality3(batches):
    """The kernel path against impl="plain" at full config-3 size, every
    state array and the codes after every batch, across a merge."""
    from foundationdb_tpu_torch.conflict.torch_backend import (
        TorchConflictSet, state_to_numpy)
    kw = dict(capacity=CAPACITY, delta_capacity=DELTA_CAPACITY,
              gc_interval_batches=2, device=DEVICE)
    kern, plain = TorchConflictSet(0, **kw), TorchConflictSet(0, impl="plain",
                                                               **kw)
    for v, enc, _ in batches[:4]:
        a = kern.resolve_encoded_async(enc, v, floor(v)).wait_codes()
        b = plain.resolve_encoded_async(enc, v, floor(v)).wait_codes()
        if not np.array_equal(a, b):
            raise AssertionError("config 3: kernel and plain verdicts differ")
        sa, sb = state_to_numpy(kern), state_to_numpy(plain)
        for k in sa:
            if not np.array_equal(np.asarray(sa[k]), np.asarray(sb[k])):
                raise AssertionError(f"config 3: kernel and plain state "
                                     f"differ: {k}")
    if kern.profile["merges"] < 1:
        raise AssertionError("config-3 state-equality stream crossed no "
                             "merge")
    print(f"state_general: kernel path equals the plain path on 4 config-3 "
          f"batches and {kern.profile['merges']} merge(s), every state array",
          flush=True)


def window_path(smi: str, batches):
    """Path 3: a one-shard window, window_query -> window_insert every
    batch, window_gc every GC_EVERY3 batches; bits and state held against
    the plain versions at full size, then against the oracle's history on
    small batches.  Returns the launch counts of the kernel run."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.conflict import window
    from foundationdb_tpu_torch.conflict.oracle import (VersionHistory,
                                                        combine_write_ranges)
    kern = window.make_window_state(CAPACITY, 0, DEVICE)
    plain = window.make_window_state(CAPACITY, 0, DEVICE)
    K.reset_counts()
    base, lats, gcs, n_ranges, conflicts = 0, [], 0, 0, 0
    for i, (v, enc, _) in enumerate(batches[:N_WINDOW3]):
        q_b, q_e, snap, q_v, w_b, w_e, w_v = window_inputs(enc, base)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bits = window.window_query(kern.bk, kern.bv, q_b, q_e, snap, q_v)
        _, ovf = window.window_insert(kern, w_b, w_e, w_v, v - base)
        if (i + 1) % GC_EVERY3 == 0:
            window.window_gc(kern, floor(v) - base, floor(v) - base)
            gcs += 1
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t1)
        n_ranges += enc.n_ranges
        want = window.window_query(plain.bk, plain.bv, q_b, q_e, snap, q_v,
                                   impl="plain")
        window.window_insert(plain, w_b, w_e, w_v, v - base, impl="plain")
        if (i + 1) % GC_EVERY3 == 0:
            window.window_gc(plain, floor(v) - base, floor(v) - base,
                             impl="plain")
            base = floor(v)
        require_equal(f"window bits, batch {i}", bits, want)
        require_equal(f"window state, batch {i}", tuple(kern), tuple(plain))
        if int(ovf[0]):
            raise AssertionError(f"window overflow on batch {i}")
        conflicts += int(bits.sum())
    launches = dict(K.LAUNCHES)
    p50 = float(np.percentile(lats, 50) * 1e3)
    rate = n_ranges / sum(lats)
    conflict_share = conflicts / sum(b[1].r_txn.shape[0]
                                     for b in batches[:N_WINDOW3])
    del kern, plain

    # The oracle's history on small batches of the same generator.
    small = window.make_window_state(1 << 16, 0, DEVICE)
    hist, base, checked, gc_floor = VersionHistory(0), 0, 0, 0
    for i, (v, enc, draws) in enumerate(make_stream3(
            np.random.default_rng(2029), N_ORACLE3, RECORDS_SMALL,
            TXNS_SMALL)):
        q_b, q_e, snap, q_v, w_b, w_e, w_v = window_inputs(enc, base)
        bits = window.window_query(small.bk, small.bv, q_b, q_e, snap,
                                   q_v).cpu().numpy()
        txns = transactions3(draws)
        reads = [(r.begin, r.end, t.read_snapshot) for t in txns
                 for r in t.read_conflict_ranges]
        for j, (b, e, sn) in enumerate(reads):
            # Below the GC floor a verdict is no longer defined.
            if sn >= gc_floor:
                checked += 1
                if bool(bits[j]) != (hist.query_max(b, e) > sn):
                    raise AssertionError(f"window bits differ from the "
                                         f"oracle's history, batch {i}")
        window.window_insert(small, w_b, w_e, w_v, v - base)
        hist.insert_many(combine_write_ranges(
            [(w.begin, w.end) for t in txns
             for w in t.write_conflict_ranges]), v)
        if i == 3:
            gc_floor = floor(v)
            window.window_gc(small, gc_floor - base, gc_floor - base)
            hist.remove_before(gc_floor)
            base = gc_floor
    print(f"path_window: {rate:.1f} ranges/s over {N_WINDOW3} config-3 "
          f"batches ({gcs} gc), p50 batch {p50:.3f} ms (query + insert), "
          f"{conflict_share:.4f} of reads newer than their snapshot; bits "
          f"and state equal the plain versions on every batch, and bits "
          f"equal the oracle's history on {checked} reads of {N_ORACLE3} "
          f"small batches -- {smi}", flush=True)
    path = {"ranges_per_s": rate, "p50_batch_ms": p50, "gcs": gcs,
            "batches": N_WINDOW3, "reads_conflicting": conflict_share,
            "oracle_reads_checked": checked, "card": smi}
    return launches, path


# ---------------------------------------------------------------- config 5
# BASELINE.json configs[4], "Sharded version window across 4 chips:
# psum-merged conflict bitmap, 1M in-flight ranges" (bench.py:86-95,
# run_config5 at bench.py:423): four key-range shards, here all on one
# card, 2^20 boundaries and a 2^18 delta per shard; 65,536 txns a batch,
# 2 point reads + 1 point write each, uniform over 100M keys; equi-depth
# splits from a 2,000-txn sample; the floor frozen at 0 while the stream
# fills the window to >= 1,000,000 committed in-flight writes at pipeline
# depth 3; then the at-capacity probe of bench.py:520-537.
N_SHARDS = 4
CONFIG5_TXNS = 65_536
CONFIG5_TARGET = 1_000_000
CONFIG5_CAPACITY = 1 << 22          # across the shards
CONFIG5_DELTA = 1 << 20
CONFIG5_DEPTH = 3
CONFIG5_SAMPLE_TXNS = 2_000
CONFIG5_BATCHES = 24                # generated ahead; the fill stops early
N_LATENCY5, N_PROBE5 = 4, 2048
N_PARITY5, PARITY5_TXNS = 2, 2_000
# The sharded general path: the config-3 stream through four shards.
CAPACITY3S, DELTA3S, N_SHARDED3 = 1 << 19, 1 << 18, 8
N_SPREAD_WINDOW, SMALL_WINDOW = 4, 1 << 12


def shard_mesh():
    from foundationdb_tpu_torch.parallel import make_conflict_mesh
    return make_conflict_mesh([DEVICE] * N_SHARDS)


def config5_splits(rng):
    """Equi-depth splits from the writes of a 2,000-txn sample batch, as
    bench.py:454-456 cuts them."""
    from foundationdb_tpu_torch.parallel import splits_from_sample
    sample, _, _ = gen_batch(rng, 1_000, KEYSPACE_LOW, False,
                             CONFIG5_SAMPLE_TXNS)
    return splits_from_sample(sample.w_begin, N_SHARDS)


def make_stream5(rng, count: int):
    out, version = [], 2_000
    for _ in range(count):
        prev, version = version, version + VERSIONS_PER_BATCH
        out.append((version, *gen_batch(rng, prev, KEYSPACE_LOW, False,
                                        CONFIG5_TXNS)))
    return out


def sharded_backend(splits, impl=None, capacity=CONFIG5_CAPACITY // N_SHARDS,
                    delta=CONFIG5_DELTA // N_SHARDS, gc=8):
    from foundationdb_tpu_torch.parallel import ShardedTorchConflictSet
    return ShardedTorchConflictSet(shard_mesh(), 0, capacity=capacity,
                                   delta_capacity=delta,
                                   gc_interval_batches=gc, splits=splits,
                                   impl=impl)


def save_shards(cs):
    from foundationdb_tpu_torch.parallel.sharded_resolver import \
        SHARDED_STATE_KEYS
    cs.synchronize()
    return [{k: getattr(sh, k).clone() for k in SHARDED_STATE_KEYS}
            for sh in cs.shards]


def load_shards(cs, saved):
    for sh, st in zip(cs.shards, saved):
        for k, v in st.items():
            getattr(sh, k).copy_(v)


def shard_tensors(cs):
    from foundationdb_tpu_torch.parallel.sharded_resolver import \
        SHARDED_STATE_KEYS
    return tuple(getattr(sh, k) for sh in cs.shards
                 for k in SHARDED_STATE_KEYS)


def warm_sharded(splits, stream, capacity, delta):
    """A sharded backend after 3 batches of `stream`, a merge and one more
    batch (the delta non-empty), the next batch packed and stamped, and a
    plain-version backend holding the same state."""
    cs = sharded_backend(splits, capacity=capacity, delta=delta)
    for v, enc, *_ in stream[:3]:
        cs.resolve_encoded_async(enc, v, floor(v)).wait_codes()
    cs.merge()
    v, enc, *_ = stream[3]
    cs.resolve_encoded_async(enc, v, floor(v)).wait_codes()
    v, enc, *_ = stream[4]
    packed = cs._pack(enc)
    cs._stamp(packed, v, cs.oldest_version, enc.n_txns)
    cs.oldest_version = floor(v)
    plain = sharded_backend(splits, impl="plain", capacity=capacity,
                            delta=delta)
    plain.d_cap = cs.d_cap
    saved = save_shards(cs)
    for sh, st in zip(plain.shards, saved):
        for k, t in st.items():
            setattr(sh, k, t.clone())
    plain.synchronize()
    return cs, plain, packed, saved


def time_program(programs, prog, kern, plain, load_k, load_p, n_bytes):
    """A sharded program, kernel against plain on the same state (restored
    before every call by load_*), then timed on the timeline, as the sum
    of its own kernels' device times (kernel_sum_ms), and its plain
    version on the timeline."""
    load_k()
    load_p()
    err = require_equal(prog, kern(), plain())
    ms = cuda_ms(kern, setup=load_k)
    dev_ms = kernel_sum_ms(kern, setup=load_k)
    plain_ms = cuda_ms(plain, 2, load_p)
    programs[prog] = {"ms": ms, "kernel_sum_ms": dev_ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms(n_bytes),
                      "max_abs_err": err}
    log(f"program {prog}: bit-equal; kernel {ms:.3f} ms ({dev_ms:.3f} ms "
        f"summed over its kernels), plain {plain_ms:.3f} ms, bound "
        f"{bound_ms(n_bytes):.4f} ms")


def kernel_row(name, fn, n_bytes, library=None, setup=None):
    """A wrapper's row: kernel against plain, its own launches timed."""
    from foundationdb_tpu_torch import kernels as K
    if setup is not None:
        setup()
    got = fn("kernel")
    if setup is not None:
        setup()
    err = require_equal(name, got, fn("plain"))
    ms = device_ms(lambda: fn("kernel"), setup=setup, counter=name)
    plain = cuda_ms(lambda: fn("plain"), reps=2, setup=setup)
    lib = None if library is None else device_ms(library)
    src, ref = K.KERNELS[name]
    log(f"{name}: bit-equal; own kernels {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {bound_ms(n_bytes):.4f} ms")
    return {"name": name, "route": "cuda",
            "source": f"foundationdb_tpu_torch/csrc/{src}.cu",
            "replaces": ref, "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bound_ms(n_bytes),
            "bound_by": "bytes", "library_ms": lib}


def combine_row(cs, fused, buf, packed, hists) -> dict:
    """shard_combine's row at config 5, as the sharded compact step calls
    it: the four shards' hists (their values from the plain versions) in
    place in compact_prep's scratch, one view a shard (CompactStep.unpack
    with four hists), combined by ShardedTorchConflictSet._combine.  Its
    own launches, the whole call behind the stream's sleep (chain_ms) and
    its device operations by torch.profiler: 1 launch, 1 kernel and no
    copy or fill a call."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.ops import shard
    step = fused.make_resolve_step_compact(cs.capacity, cs.d_cap,
                                           *packed["shapes"])
    views = step.unpack(buf, len(hists))["hists"]
    for v, h in zip(views, hists):
        v.copy_(h)
    row = kernel_row("shard_combine",
                     lambda i: shard.shard_combine(views, impl=i),
                     nbytes(hists) + 4 * hists.shape[1],
                     library=lambda: torch.amax(hists, dim=0))
    K.reset_counts()
    require_equal("shard_combine in place", cs._combine(views),
                  shard.shard_combine(hists, impl="plain"))
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    kernels, others = device_ops(lambda: cs._combine(views))
    if launches != {"shard_combine": 1} or kernels != 1 or others != 0:
        raise AssertionError(f"shard_combine: {launches} launches, "
                             f"{kernels} kernels and {others} other device "
                             "operations a call, not 1, 1 and 0")
    row.update(launches_per_call=launches["shard_combine"],
               kernels_per_call=kernels,
               other_ops_per_call=others,
               chain_ms=device_ms(lambda: cs._combine(views), reps=20))
    log(f"shard_combine: the sharded step's call {row['chain_ms']:.5f} ms "
        f"behind the sleep, {kernels} kernel and {others} other device "
        "operations a call")
    return row


def compare_sharded(splits5, stream5, stream3):
    """Phase 9: the shard kernels and programs #8 (the sharded compact and
    general steps, the sharded merge) and #9 (the sharded window step and
    gc), kernel against plain at the paths' shapes."""
    import torch
    from foundationdb_tpu_torch.conflict import fused, window
    from foundationdb_tpu_torch.ops import digest, shard
    from foundationdb_tpu_torch.parallel import ShardedWindow
    rows, programs = [], {}
    cs, plain, packed, saved = warm_sharded(
        splits5, stream5, CONFIG5_CAPACITY // N_SHARDS,
        CONFIG5_DELTA // N_SHARDS)
    host_buf = torch.from_numpy(packed["buf"]).pin_memory()
    t_cap, r_pad, w_pad, u_pad, lw = packed["shapes"]
    step = fused.make_resolve_step_compact(cs.capacity, cs.d_cap,
                                           *packed["shapes"], impl="plain")
    buf = host_buf.to(DEVICE)
    sh1 = cs.shards[1]
    h = step.history(sh1.bk, sh1.table, sh1.dk, sh1.dtable, buf, sh1.bounds)
    hists = torch.stack([step.history(sh.bk, sh.table, sh.dk, sh.dtable, buf,
                                      sh.bounds)["rw"]["hist"]
                         for sh in cs.shards])
    u_b, u_e = h["u_b"], h["u_e"]
    clip_out = shard.clip_rows(u_b, u_e, *sh1.bounds, impl="plain")
    log(f"config 5: shard 1 owns {int(clip_out[2].sum())} of {u_pad} unique "
        f"keys (u_n {int(h['scal'][0])})")
    rows.append(kernel_row(
        "clip_rows", lambda i: shard.clip_rows(u_b, u_e, *sh1.bounds, impl=i),
        nbytes(u_b, u_e, *clip_out)))
    # The history probe of shard 1: its clipped keys, the owned ones
    # searched (the owned mask read, their rows read, every slot written).
    cu_b, cu_e, owned = clip_out[:3]
    n_own = int(owned.sum())
    programs["history_probe_shard"] = probe_at(
        "config5_shard", "history_probe", "sharded",
        lambda i: digest.history_probe(sh1.bk, sh1.table, sh1.dk, sh1.dtable,
                                       cu_b, cu_e, i, own=owned),
        probe_bytes_of((sh1.bk, sh1.dk), 64 * n_own + nbytes(owned), n_own,
                       n_own, u_pad),
        cap=cs.capacity, slots=u_pad, searched=n_own, size=int(sh1.size[0]),
        dsize=int(sh1.dsize[0]))
    rows.append(combine_row(cs, fused, buf, packed, hists))
    # The point insert of shard 1 at the shard's shape (the point_insert
    # row's config5_shard entry): its owned keys, the combined verdicts.
    w_ins = step.resolve(h, shard.shard_combine(hists, impl="plain"),
                         torch.empty((t_cap + fused.OUT_EXTRA,),
                                     dtype=torch.int8, device=DEVICE))
    programs["point_insert_shard"] = insert_at(
        "config5_shard", "point", {"k": sh1.dk, "v": sh1.dv,
                                   "size": sh1.dsize, "flag": sh1.flag,
                                   "bsize": sh1.size},
        (u_b, u_e, h["w_uid"], w_ins, h["scal"][4:5], h["u_own"]))

    def load_k():
        load_shards(cs, saved)

    def load_p():
        load_shards(plain, saved)

    def run_step(c):
        out, _ = c._run_step(packed, host_buf)
        return (out,) + shard_tensors(c)

    def probe_bytes(sh, n_q, q_bytes):
        return (q_bytes + search_bytes(sh.bk, n_q) + search_bytes(sh.dk, n_q)
                + 4 * 4 * n_q + 4 * n_q)

    # The batch in once; per shard the probe of its clipped keys and its
    # delta read and rewritten; the codes and tail out.
    step_bytes = (nbytes(buf) + t_cap + 12 + sum(
        probe_bytes(sh, u_pad, nbytes(u_b, u_e)) + 2 * nbytes(sh.dk, sh.dv)
        for sh in cs.shards))
    time_program(programs, "sharded_step", lambda: run_step(cs),
                 lambda: run_step(plain), load_k, load_p, step_bytes)
    scalars = (cs._rel(cs.oldest_version),
               max(cs.oldest_version - cs.version_base, 0))

    def run_merge(c):
        c._merge_state(fused.make_merge_step(c.capacity, c.d_cap, c.impl),
                       scalars)
        c._refresh_dtable()
        return shard_tensors(c)

    # Per shard the least bytes of its merge (merge_bytes), its base table
    # and its delta table written.
    sharded_merge_bytes = sum(
        merge_bytes(int(sh.size[0]), int(sh.dsize[0]), cs.capacity, cs.d_cap)
        + nbytes(sh.table, sh.dtable) for sh in cs.shards)
    time_program(programs, "sharded_merge", lambda: run_merge(cs),
                 lambda: run_merge(plain), load_k, load_p,
                 sharded_merge_bytes)
    # One shard's merge alone, at the shard's shape (the merge row's
    # config5_shard entry).
    load_k()
    sh0 = cs.shards[0]
    programs["sharded_merge"]["one_shard"] = merge_at(
        "config5_shard", {k: getattr(sh0, k).clone() for k in
                          ("bk", "bv", "table", "size", "dk", "dv", "dsize",
                           "flag")},
        cs.capacity, cs.d_cap, scalars, first=sh0.lo)
    del cs, plain, saved, hists, h, buf
    torch.cuda.empty_cache()

    # The sharded general step at config 3, equi-depth splits from its
    # writes.
    splits3 = general_splits(stream3)
    cs, plain, packed, saved = warm_sharded(splits3, stream3, CAPACITY3S,
                                            DELTA3S)
    host_buf = torch.from_numpy(packed["buf"]).pin_memory()
    t_cap, r_cap, w_cap = packed["caps"]
    digests, meta = cs._general_views(host_buf, packed["caps"])

    def load_k():
        load_shards(cs, saved)

    def load_p():
        load_shards(plain, saved)

    # A range's two searches count once (probe_bytes_of).
    gen_bytes = (nbytes(digests, meta) + t_cap + 12 + sum(
        probe_bytes(sh, r_cap, 2 * nbytes(digests[:r_cap]))
        + 2 * nbytes(sh.dk, sh.dv) for sh in cs.shards))
    time_program(programs, "sharded_general_step", lambda: run_step(cs),
                 lambda: run_step(plain), load_k, load_p, gen_bytes)
    del cs, plain, saved
    torch.cuda.empty_cache()

    # The sharded window at kr=4, q=1, 2^21 boundaries per shard: the
    # window of the first five config-3 batches, then the sixth batch's
    # step; the gc at its floor.
    wins = [ShardedWindow(shard_mesh(), CAPACITY, impl=i)
            for i in (None, "plain")]
    for v, enc, _ in stream3[:5]:
        wins[0].resolve_step(*window_inputs(enc, 0), v)
    torch.cuda.synchronize()
    wsaved = [tuple(t.clone() for t in st) for st in wins[0].shard_states()]
    v5, enc5, _ = stream3[5]
    inputs = window_inputs(enc5, 0)
    nq, nw = inputs[0].shape[0], inputs[4].shape[0]
    # window_query on shards 0 and 1 of the sharded window: the step's
    # queries clipped to the shard, the valid ones searched.  On config
    # 3's keys shard 0 holds every row and valid query, shard 1 none.
    for d in (0, 1):
        st_d = wins[0].shard_states()[d]
        lo_d, hi_d = next(iter(wins[0].replicas[d].values()))[1]
        cqb, cqe, qv, _ = shard.clip_rows(inputs[0], inputs[1], lo_d, hi_d,
                                          valid=inputs[3], impl="plain")
        n_valid = int(qv.sum())
        programs[f"window_query_shard{d}"] = probe_at(
            f"sharded_window_shard{d}", "window_query", "sharded_window",
            lambda i, st_d=st_d, cqb=cqb, cqe=cqe, qv=qv: window.window_query(
                st_d.bk, st_d.bv, cqb, cqe, inputs[2], qv, impl=i),
            probe_bytes_of((st_d.bk,), 68 * n_valid + nbytes(qv),
                           n_valid, n_valid, nq),
            cap=CAPACITY, slots=nq, searched=n_valid,
            size=int(st_d.size[0]))

    def wload(w):
        def load():
            for st, sv in zip(w.shard_states(), wsaved):
                for t, s in zip(st, sv):
                    t.copy_(s)
        return load

    def wstep(w):
        bits, ovf = w.resolve_step(*inputs, v5)
        return (bits, ovf) + tuple(t for st in w.shard_states() for t in st)

    def wgc(w):
        w.gc(floor(v5), floor(v5))
        return tuple(t for st in w.shard_states() for t in st)

    st0 = wins[0].shard_states()[0]
    # Per shard: the queries in, the table rows the searches touch, the
    # state read and rewritten by the insert; the bits out.
    wstep_bytes = (nbytes(*inputs) + 4 * nq + N_SHARDS * (
        search_bytes(st0.bk, nq) + 8 * nq
        + 2 * nbytes(st0.bk, st0.bv)))
    time_program(programs, "sharded_window_step", lambda: wstep(wins[0]),
                 lambda: wstep(wins[1]), wload(wins[0]), wload(wins[1]),
                 wstep_bytes)
    # gc_bytes of each shard (one holds config 3's every row, the others
    # one each), beside every shard's state read and written whole (the
    # bound of the earlier out-of-place window_gc).
    wload(wins[0])()
    time_program(programs, "sharded_gc", lambda: wgc(wins[0]),
                 lambda: wgc(wins[1]), wload(wins[0]), wload(wins[1]),
                 sum(gc_bytes(st, floor(v5), floor(v5))
                     for st in wins[0].shard_states()))
    programs["sharded_gc"]["bound_ms_whole_state"] = bound_ms(
        N_SHARDS * 2 * nbytes(st0.bk, st0.bv))
    flag = torch.ones((1,), dtype=torch.int32, device=DEVICE)
    target = tuple(t.clone() for t in st0)

    def commit_setup():
        for t, s in zip(target, wsaved[1]):
            t.copy_(s)

    # shard_commit on a set overflow: the saved window copied back.
    def commit(impl):
        shard.shard_commit(flag, wsaved[0], target, impl=impl)
        return tuple(t.clone() for t in target)

    rows.append(kernel_row("shard_commit", commit,
                           2 * nbytes(*wsaved[0]) + 4, setup=commit_setup))
    log(f"sharded window: {nq} queries and {nw} writes a step; shard sizes "
        f"{wins[0].shard_sizes()}")
    return rows, programs


def general_splits(stream3):
    """Equi-depth splits from the writes of the config-3 stream's first
    batch."""
    from foundationdb_tpu_torch.parallel import splits_from_sample
    return splits_from_sample(stream3[0][1].w_begin, N_SHARDS)


def sharded_path(smi: str, splits, batches):
    """Path 4: config 5, four shards on one card, through the entry point a
    resolver calls; the fill, the depth-1 latency and the at-capacity
    probe, with the launch counts of that run."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
    from foundationdb_tpu_torch.txn.types import CommitTransactionRef, KeyRange
    K.reset_counts()
    cs = sharded_backend(splits)
    v, enc, probe_kids, _ = batches[0]
    codes = cs.resolve_encoded_async(enc, v, 0).wait_codes().copy()
    inserted, n_ranges, used = int(np.sum(codes == 2)), 0, 1
    inflight = deque()

    def drain_one():
        nonlocal inserted, n_ranges
        e, h = inflight.popleft()
        inserted += int(np.sum(h.wait_codes() == 2))
        n_ranges += e.n_ranges

    t0 = time.perf_counter()
    while inserted < CONFIG5_TARGET:
        if used + N_LATENCY5 >= len(batches):
            raise AssertionError("config 5: the stream ran out before the "
                                 "window held the target")
        v, enc, _, _ = batches[used]
        used += 1
        inflight.append((enc, cs.resolve_encoded_async(enc, v, 0)))
        while len(inflight) >= CONFIG5_DEPTH:
            drain_one()
    while inflight:
        drain_one()
    dt = time.perf_counter() - t0
    fill_batches = used
    lats = []
    for v, enc, _, _ in batches[used:used + N_LATENCY5]:
        t1 = time.perf_counter()
        inserted += int(np.sum(cs.resolve_encoded_async(enc, v, 0)
                               .wait_codes() == 2))
        lats.append(time.perf_counter() - t1)
    used += N_LATENCY5
    p50 = float(np.percentile(lats, 50) * 1e3)
    # The at-capacity probe: 2,048 of the first batch's committed writes,
    # re-read at snapshot 0, must all conflict.
    nr = CONFIG5_TXNS * READS
    committed = np.asarray(probe_kids[nr:])[codes == 2][:N_PROBE5]
    probe = [CommitTransactionRef(
        read_snapshot=0, read_conflict_ranges=[KeyRange(k, k + b"\x00")])
        for k in (b"k%014d" % int(x) for x in committed)]
    verdicts = cs.resolve(probe, v + VERSIONS_PER_BATCH, 0)
    conflicts = sum(1 for x in verdicts if int(x) == 0)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    sizes = cs.shard_sizes()
    packs = []
    for _, enc, _, _ in batches[used - N_LATENCY5:used]:
        t1 = time.perf_counter()
        TorchConflictSet._pack_compact(enc)
        packs.append(time.perf_counter() - t1)
    pack_ms = float(np.percentile(packs, 50) * 1e3)
    rate = n_ranges / dt
    merges = cs.profile["merges"]
    print(f"path_sharded: {inserted} committed in-flight writes after "
          f"{used} batches ({fill_batches} to fill at depth "
          f"{CONFIG5_DEPTH}, {merges} merges), fill {rate:.1f} ranges/s, "
          f"p50 resolve {p50:.3f} ms at depth 1 (host packing alone "
          f"{pack_ms:.3f} ms), shard base sizes {sizes}, probe "
          f"{conflicts}/{len(probe)} conflicts -- {smi}", flush=True)
    if inserted < CONFIG5_TARGET:
        raise AssertionError(f"config 5 holds {inserted} writes")
    if len(probe) != N_PROBE5 or conflicts != len(probe):
        raise AssertionError(f"config 5 probe: {conflicts}/{len(probe)}")
    if min(sizes) <= 1 or max(sizes) > 2 * np.mean(sizes):
        raise AssertionError(f"config 5 shards unbalanced: {sizes}")
    if cs.profile["general_batches"] != 0:
        raise AssertionError("config 5 left the compact path")
    path = {"in_flight_writes": inserted, "fill_ranges_per_s": rate,
            "fill_batches": fill_batches, "batches": used,
            "p50_resolve_ms": p50, "p50_pack_ms": pack_ms,
            "merges": merges, "shard_base_sizes": sizes,
            "probe_conflicts": conflicts, "probe_reads": len(probe),
            "n_shards": N_SHARDS, "depth": CONFIG5_DEPTH,
            "txns_per_batch": CONFIG5_TXNS, "card": smi}
    return launches, path


def sharded_parity(splits5):
    """The sharded backend's verdicts against the oracle on small config-5
    batches (low contention) and on zipf batches over 1M keys (high
    contention, deep intra-batch chains), and on small config-3 batches
    through the sharded general path."""
    from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet
    from foundationdb_tpu_torch.parallel import splits_from_sample
    rng = np.random.default_rng(5056)
    for name, keyspace, zipf in (("low", KEYSPACE_LOW, False),
                                 ("high", KEYSPACE, True)):
        stream = make_stream(rng, N_PARITY5, keyspace, zipf, PARITY5_TXNS)
        cs = sharded_backend(splits_from_sample(stream[0][1].w_begin,
                                                N_SHARDS), gc=2)
        oracle = OracleConflictSet(0)
        for i, (v, enc, kids, snaps) in enumerate(stream):
            want = np.asarray([int(x) for x in oracle.resolve(
                to_transactions(kids, snaps), v, floor(v))], dtype=np.int8)
            got = cs.resolve_encoded_async(enc, v, floor(v)).wait_codes()
            if not np.array_equal(got, want):
                raise AssertionError(f"sharded parity ({name} contention): "
                                     f"{int(np.sum(got != want))} verdicts "
                                     f"differ on batch {i}")
        cs.merge()
        if min(cs.shard_sizes()) <= 1:
            raise AssertionError(f"sharded parity ({name}): a shard holds "
                                 f"nothing: {cs.shard_sizes()}")
    print(f"parity_sharded: verdicts equal the oracle on {N_PARITY5} "
          f"low-contention config-5 batches and {N_PARITY5} zipf batches of "
          f"{PARITY5_TXNS} txns, four shards with equi-depth splits",
          flush=True)
    stream = small_stream3(2031)
    oracle_parity3(lambda: sharded_backend(general_splits(stream),
                                           capacity=CAPACITY3S,
                                           delta=DELTA3S), stream,
                   "parity_sharded_general")


def sharded_state_equality(splits5, batches):
    """The sharded kernel path against impl="plain" at full config-5 size,
    every shard's state and the codes after every batch, across a
    merge."""
    from foundationdb_tpu_torch.parallel import sharded_state_to_numpy
    kern = sharded_backend(splits5, gc=2)
    plain = sharded_backend(splits5, impl="plain", gc=2)
    for v, enc, _, _ in batches[:3]:
        a = kern.resolve_encoded_async(enc, v, 0).wait_codes()
        b = plain.resolve_encoded_async(enc, v, 0).wait_codes()
        if not np.array_equal(a, b):
            raise AssertionError("config 5: kernel and plain verdicts differ")
        sa, sb = sharded_state_to_numpy(kern), sharded_state_to_numpy(plain)
        for k in sa:
            if not np.array_equal(np.asarray(sa[k]), np.asarray(sb[k])):
                raise AssertionError(f"config 5: kernel and plain state "
                                     f"differ: {k}")
    if kern.profile["merges"] < 1:
        raise AssertionError("config-5 state-equality stream crossed no "
                             "merge")
    print(f"state_sharded: kernel path equals the plain path on 3 config-5 "
          f"batches and {kern.profile['merges']} merge(s), every array of "
          f"every shard", flush=True)


def sharded_general(smi: str, batches3):
    """The config-3 stream through four shards (equi-depth splits from its
    writes): codes equal the one-device general path's on every batch."""
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
    from foundationdb_tpu_torch.ops.digest import planar_to_s24
    splits = general_splits(batches3)
    one = TorchConflictSet(0, capacity=CAPACITY, delta_capacity=DELTA_CAPACITY,
                           device=DEVICE)
    want = [one.resolve_encoded_async(enc, v, floor(v)).wait_codes().copy()
            for v, enc, _ in batches3[:N_SHARDED3]]
    del one
    cs = sharded_backend(splits, capacity=CAPACITY3S, delta=DELTA3S, gc=4)
    lats, straddle = [], 0
    cuts = planar_to_s24(np.ascontiguousarray(splits[1:-1].T))
    for i, (v, enc, _) in enumerate(batches3[:N_SHARDED3]):
        t1 = time.perf_counter()
        got = cs.resolve_encoded_async(enc, v, floor(v)).wait_codes()
        lats.append(time.perf_counter() - t1)
        bad = int(np.sum(got != want[i]))
        if bad:
            raise AssertionError(f"sharded general: {bad} codes differ from "
                                 f"one device on batch {i}")
        rb, re_ = planar_to_s24(enc.r_begin), planar_to_s24(enc.r_end)
        straddle += int(sum(np.sum((rb < c) & (re_ > c)) for c in cuts))
    sizes = cs.shard_sizes()
    if cs.profile["general_batches"] != N_SHARDED3 or cs.profile["merges"] < 1:
        raise AssertionError(f"sharded general: {cs.profile}")
    if min(sizes) <= 1:
        raise AssertionError(f"sharded general: a shard holds nothing: "
                             f"{sizes}")
    p50 = float(np.percentile(lats, 50) * 1e3)
    print(f"path_sharded_general: codes equal the one-device general path on "
          f"{N_SHARDED3} config-3 batches ({straddle} reads straddle a "
          f"split, {cs.profile['merges']} merges), p50 resolve {p50:.3f} ms "
          f"at depth 1, shard base sizes {sizes} -- {smi}", flush=True)
    return {"batches": N_SHARDED3, "reads_straddling": straddle,
            "p50_resolve_ms": p50, "shard_base_sizes": sizes,
            "merges": cs.profile["merges"], "card": smi}


def random_ranges(rng, n: int):
    """n ranges of uniform random full-width digests as rows: begin, and
    an end a little above it (lane 1 raised), most inside one shard."""
    import torch
    from foundationdb_tpu_torch.ops.digest import planar_to_rows
    b = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64).astype(
        np.uint32)
    b[1] &= 0x7FFFFFFF
    e = b.copy()
    e[1] += rng.integers(1, 1 << 20, size=n).astype(np.uint32)
    return (torch.from_numpy(planar_to_rows(b)).to(DEVICE),
            torch.from_numpy(planar_to_rows(e)).to(DEVICE))


def sharded_window_path(smi: str, batches):
    """Path 5: ShardedWindow at kr=4, q=1 on one card, 2^21 boundaries per
    shard, on the config-3 batches of path 3 (their bits equal the
    one-shard window's), with the launch counts of that run; then spread
    batches against the plain versions and an overflow that leaves every
    shard unchanged."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.conflict import window
    from foundationdb_tpu_torch.parallel import ShardedWindow
    one = window.make_window_state(CAPACITY, 0, DEVICE)
    want, base = [], 0
    for i, (v, enc, _) in enumerate(batches[:N_WINDOW3]):
        q_b, q_e, snap, q_v, w_b, w_e, w_v = window_inputs(enc, base)
        want.append(window.window_query(one.bk, one.bv, q_b, q_e, snap, q_v))
        window.window_insert(one, w_b, w_e, w_v, v - base)
        if (i + 1) % GC_EVERY3 == 0:
            window.window_gc(one, floor(v) - base, floor(v) - base)
            base = floor(v)
    del one
    torch.cuda.synchronize()
    K.reset_counts()
    sw = ShardedWindow(shard_mesh(), CAPACITY)
    base, lats, n_ranges = 0, [], 0
    for i, (v, enc, _) in enumerate(batches[:N_WINDOW3]):
        inputs = window_inputs(enc, base)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bits, ovf = sw.resolve_step(*inputs, v - base)
        if (i + 1) % GC_EVERY3 == 0:
            sw.gc(floor(v) - base, floor(v) - base)
            base = floor(v)
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t1)
        n_ranges += enc.n_ranges
        require_equal(f"sharded window bits, batch {i}", bits, want[i])
        if int(ovf[0]):
            raise AssertionError(f"sharded window overflow on batch {i}")
    launches = dict(K.LAUNCHES)
    sizes3 = sw.shard_sizes()
    del sw, want
    p50 = float(np.percentile(lats, 50) * 1e3)
    rate = n_ranges / sum(lats)
    # Spread batches: uniform random full-width digests at config 3's
    # counts, kernels against the plain versions, bits and state.
    rng = np.random.default_rng(2032)
    nq, nw = batches[0][1].r_txn.shape[0], batches[0][1].w_txn.shape[0]
    wins = [ShardedWindow(shard_mesh(), CAPACITY, impl=i)
            for i in (None, "plain")]
    for i in range(N_SPREAD_WINDOW):
        q_b, q_e = random_ranges(rng, nq)
        w_b, w_e = random_ranges(rng, nw)
        snap = torch.from_numpy(rng.integers(0, 1000 * i + 1, size=nq,
                                             dtype=np.int32)).to(DEVICE)
        ones = torch.ones((max(nq, nw),), dtype=torch.int32, device=DEVICE)
        outs = [w.resolve_step(q_b, q_e, snap, ones[:nq], w_b, w_e,
                               ones[:nw], 1000 * (i + 1)) for w in wins]
        require_equal(f"spread window bits, batch {i}", outs[0], outs[1])
        for a, b in zip(wins[0].state_to_numpy(), wins[1].state_to_numpy()):
            if not np.array_equal(a, b):
                raise AssertionError(f"spread window state, batch {i}")
    sizes_spread = wins[0].shard_sizes()
    if min(sizes_spread) <= 1:
        raise AssertionError(f"spread batches left a shard empty: "
                             f"{sizes_spread}")
    del wins
    # Overflow: a small window, one batch spread, then a skewed batch that
    # overflows shard 2 alone; every shard must keep its state.
    small = [ShardedWindow(shard_mesh(), SMALL_WINDOW, impl=i)
             for i in (None, "plain")]
    q_b, q_e = random_ranges(rng, 1024)
    snap = torch.zeros((1024,), dtype=torch.int32, device=DEVICE)
    ones = torch.ones((max(SMALL_WINDOW, 1024),), dtype=torch.int32,
                      device=DEVICE)
    w_b, w_e = random_ranges(rng, 512)
    for w in small:
        w.resolve_step(q_b, q_e, snap, ones[:1024], w_b, w_e, ones[:512], 10)
    before = [w.state_to_numpy() for w in small]
    # SMALL_WINDOW disjoint point-like ranges whose lane 0 (0x80000001, as
    # int32 bits) lies in shard 2's quarter of the even splits.
    w_b, _ = random_ranges(rng, SMALL_WINDOW)
    w_b[:, 0] = -(1 << 31) + 1
    w_e = w_b.clone()
    w_e[:, 7] += 1
    for w, b in zip(small, before):
        bits, ovf = w.resolve_step(q_b, q_e, snap, ones[:1024], w_b, w_e,
                                   ones[:SMALL_WINDOW], 20)
        if int(ovf[0]) != 1:
            raise AssertionError("the skewed batch did not overflow")
        for x, y in zip(w.state_to_numpy(), b):
            if not np.array_equal(x, y):
                raise AssertionError("an overflowed step changed a shard")
    print(f"path_sharded_window: {rate:.1f} ranges/s over {N_WINDOW3} "
          f"config-3 batches (1 gc), p50 step {p50:.3f} ms; bits equal the "
          f"one-shard window's on every batch (even splits put these keys "
          f"on shard 0: shard sizes {sizes3}); on {N_SPREAD_WINDOW} spread "
          f"batches (shard sizes {sizes_spread}) bits and state equal the "
          f"plain versions; an overflow of one shard left every shard "
          f"unchanged -- {smi}", flush=True)
    path = {"ranges_per_s": rate, "p50_step_ms": p50,
            "batches": N_WINDOW3, "shard_sizes_config3": sizes3,
            "shard_sizes_spread": sizes_spread, "card": smi}
    return launches, path


# ------------------------------------------------------- supervised paths
# The supervision layer (conflict/supervisor.py) over the paths above.  Its
# fallback is the exact CPU mirror, which would still give right verdicts
# if a kernel failed, so every phase that injects no fault requires every
# batch on the card (check_supervised).  Phase 16's 500-txn batches keep
# the mirror's replay (the oracle's quadratic intra-batch check) short;
# phase 17 fills fewer batches than phase 10 (the mirror folds every
# committed write on the host).
TXNS_DEGRADE, N_DEGRADE, N_INFLIGHT = 500, 16, 7
N_SHARED, SHARED_TXNS, SHARED_KEYS, SHARED_PREFIXES = 6, 1_000, 20_000, 4
N_SUPERVISED5 = 10


class port_knobs:
    """The port's server knobs set for a block, restored after."""

    def __init__(self, **values) -> None:
        self.values = values

    def __enter__(self):
        from foundationdb_tpu_torch.core.knobs import server_knobs
        self.knobs = server_knobs()
        self.saved = {k: getattr(self.knobs, k) for k in self.values}
        for k, v in self.values.items():
            setattr(self.knobs, k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.knobs, k, v)


def check_supervised(sup, n_batches: int, device_cls: str,
                     device: str = DEVICE) -> dict:
    """A supervised run that injected no fault: never degraded, every
    batch on the card, the device set the one expected, on `device`."""
    st = sup.status()
    bad = (st["degraded"] is not False or st["degrades"] != 0
           or st["fallback_batches"] != 0 or st["promotions"] != 0
           or st["device_batches"] != n_batches)
    dev = sup.device
    if bad or type(dev).__name__ != device_cls or \
            dev.device.type != device:
        raise AssertionError(f"supervised set left the card or missed a "
                             f"batch ({n_batches} batches, "
                             f"{type(dev).__name__}): {st}")
    return st


def drive_point(cs, batches, txns=None) -> dict:
    """Phase 3's drive: N_WARMUP batches, N_MEASURED at depth DEPTH,
    N_LATENCY at depth 1, through resolve_encoded_async (a supervised set
    also gets each batch's object form, for its mirror).  Returns every
    batch's codes, ranges/s at depth, the merges in those batches and the
    p50 ms at depth 1."""
    def submit(i):
        v, enc, _, _ = batches[i]
        if txns is None:
            return cs.resolve_encoded_async(enc, v, floor(v))
        return cs.resolve_encoded_async(enc, v, floor(v),
                                        transactions=txns[i])

    profile = cs.profile if hasattr(cs, "profile") else cs.device.profile
    codes = [submit(i).wait_codes().copy() for i in range(N_WARMUP)]
    merges0 = profile["merges"]
    inflight, n_ranges = deque(), 0
    t0 = time.perf_counter()
    for i in range(N_WARMUP, N_WARMUP + N_MEASURED):
        inflight.append((i, submit(i)))
        while len(inflight) > DEPTH or (
                i == N_WARMUP + N_MEASURED - 1 and inflight):
            j, h = inflight.popleft()
            codes.append(h.wait_codes().copy())
            n_ranges += batches[j][1].n_ranges
    rate = n_ranges / (time.perf_counter() - t0)
    merges = profile["merges"] - merges0
    lats = []
    for i in range(N_WARMUP + N_MEASURED, len(batches)):
        t1 = time.perf_counter()
        codes.append(submit(i).wait_codes().copy())
        lats.append(time.perf_counter() - t1)
    return {"codes": codes, "rate": rate, "merges": merges,
            "p50_ms": float(np.percentile(lats, 50) * 1e3)}


def supervised_point_path(smi: str, batches):
    """Phase 14: new_conflict_set("torch") -- the supervised set -- over
    phase 3's config-2 stream at CONFLICT_PIPELINE_DEPTH 8, beside the
    bare set on the same stream; codes equal batch for batch.  Returns
    the launches, the path line's figures, and the stream's object form
    and supervised codes (phase 19 holds the Resolver role to them)."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.conflict.api import new_conflict_set
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
    txns = [to_transactions(kids, snaps) for _, _, kids, snaps in batches]
    bare = TorchConflictSet(0, capacity=CAPACITY,
                            delta_capacity=DELTA_CAPACITY, device=DEVICE)
    want = drive_point(bare, batches)
    bare_rate, bare_p50 = want["rate"], want["p50_ms"]
    del bare
    torch.cuda.empty_cache()
    with port_knobs(CONFLICT_PIPELINE_DEPTH=DEPTH):
        K.reset_counts()
        sup = new_conflict_set("torch", capacity=CAPACITY,
                               delta_capacity=DELTA_CAPACITY, device=DEVICE)
        # The mirror's fold-through of a device batch: the recheck flags,
        # the sampled attribution and the insert of the surviving writes.
        fold = []
        for name in ("_needs_recheck", "_attribute_device_batch",
                     "_mirror_apply"):
            fn = getattr(sup, name)

            def timed(*a, fn=fn, name=name, **kw):
                t1 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    if name == "_needs_recheck":
                        fold.append(0.0)
                    fold[-1] += time.perf_counter() - t1

            setattr(sup, name, timed)
        got = drive_point(sup, batches, txns)
        rate, p50 = got["rate"], got["p50_ms"]
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
    for i, (a, b) in enumerate(zip(got["codes"], want["codes"])):
        if not np.array_equal(a, b):
            raise AssertionError(f"supervised codes differ from the bare "
                                 f"set's on batch {i}")
    st = check_supervised(sup, len(batches), "TorchConflictSet")
    if st["rechecked_batches"] != 0:
        raise AssertionError(f"15-byte keys rechecked: {st}")
    fold_ms = float(np.percentile(fold, 50) * 1e3)
    print(f"path_supervised: {rate:.1f} ranges/s at depth {DEPTH} (bare "
          f"{bare_rate:.1f}), p50 resolve {p50:.3f} ms at depth 1 (bare "
          f"{bare_p50:.3f}), pipeline_stalls {st['pipeline_stalls']}, "
          f"mirror fold-through p50 {fold_ms:.3f} ms a batch, codes equal "
          f"the bare set's on {len(batches)} batches, 0 rechecked -- {smi}",
          flush=True)
    path = {"ranges_per_s": rate, "bare_ranges_per_s": bare_rate,
            "p50_resolve_ms": p50, "bare_p50_resolve_ms": bare_p50,
            "pipeline_stalls": st["pipeline_stalls"],
            "p50_mirror_fold_ms": fold_ms, "batches": len(batches),
            "depth": DEPTH, "card": smi}
    return launches, path, txns, got["codes"]


def shared_prefix_stream(seed: int):
    """Point txns (2 reads, 1 write) whose keys share one of
    SHARED_PREFIXES 31-byte prefixes, an 8-digit id after: every key
    digests to its prefix's digest (the keys tenants of one application
    write).  zipf(1.2) ids over SHARED_KEYS."""
    from foundationdb_tpu_torch.ops.digest import PREFIX_BYTES
    from foundationdb_tpu_torch.txn.types import CommitTransactionRef, KeyRange
    rng = np.random.default_rng(seed)
    prefixes = [(b"tenant%02d/" % i).ljust(PREFIX_BYTES, b"p")
                for i in range(SHARED_PREFIXES)]
    out, version = [], 1_000 + WINDOW
    for _ in range(N_SHARED):
        prev, version = version, version + VERSIONS_PER_BATCH
        ids = rng.zipf(1.2, size=(SHARED_TXNS, READS + 1)) % SHARED_KEYS
        pick = rng.integers(0, SHARED_PREFIXES, size=ids.shape)
        snaps = np.maximum(prev - rng.integers(0, 2 * VERSIONS_PER_BATCH,
                                               size=SHARED_TXNS), 0)
        txns = []
        for t in range(SHARED_TXNS):
            keys = [prefixes[p] + b"%08d" % k
                    for p, k in zip(pick[t], ids[t])]
            txns.append(CommitTransactionRef(
                read_conflict_ranges=[KeyRange(k, k + b"\x00")
                                      for k in keys[:READS]],
                write_conflict_ranges=[KeyRange(keys[READS],
                                                keys[READS] + b"\x00")],
                read_snapshot=int(snaps[t])))
        out.append((version, txns))
    return out


def supervised_long_keys(smi: str):
    """Phase 15: keys past the digest prefix through the supervised set
    (each flagged batch re-resolved exactly by the mirror) and the bare
    set: phase 6's small config-3 batches and a shared-prefix stream.
    The supervised verdicts must equal the oracle's; the bare set's extra
    aborts against the oracle are counted, and the txns it commits that
    the oracle aborts (a reader behind a writer the bare set aborted
    wrongly, whose write then never blocks it)."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.conflict.api import new_conflict_set
    from foundationdb_tpu_torch.conflict.encoded import EncodedBatch
    from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
    streams = {
        "config3": [(v, transactions3(draws))
                    for v, _, draws in small_stream3(2028)],
        "shared_prefix": shared_prefix_stream(2029)}
    launches = dict.fromkeys(K.LAUNCHES, 0)
    out = {}
    for label, stream in streams.items():
        # The bare set first, so the counters below count the supervised
        # set's launches alone.
        bare = TorchConflictSet(0, capacity=CAPACITY,
                                delta_capacity=DELTA_CAPACITY, device=DEVICE)
        bare_codes = [bare.resolve_encoded_async(
            EncodedBatch.from_transactions(txns), v, floor(v))
            .wait_codes().copy() for v, txns in stream]
        del bare
        sup = new_conflict_set("torch", capacity=CAPACITY,
                               delta_capacity=DELTA_CAPACITY, device=DEVICE)
        oracle = OracleConflictSet(0)
        extra = flipped = commits = n = 0
        K.reset_counts()
        for i, (v, txns) in enumerate(stream):
            want = np.asarray([int(x) for x in oracle.resolve(
                txns, v, floor(v))], dtype=np.int8)
            got = np.asarray([int(x) for x in sup.resolve(
                txns, v, floor(v))], dtype=np.int8)
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"long keys ({label}): {int(np.sum(got != want))} "
                    f"supervised verdicts differ from the oracle on batch "
                    f"{i}")
            b = bare_codes[i]
            extra += int(np.sum((b == 0) & (want == 2)))
            flipped += int(np.sum((b == 2) & (want != 2)))
            commits += int(np.sum(want == 2))
            n += len(txns)
        st = check_supervised(sup, len(stream), "TorchConflictSet")
        if st["rechecked_batches"] <= 0:
            raise AssertionError(f"long keys ({label}): nothing rechecked")
        out[label] = {"batches": len(stream), "txns": n,
                      "rechecked_batches": st["rechecked_batches"],
                      "oracle_commits": commits, "bare_extra_aborts": extra,
                      "bare_extra_abort_rate": extra / n,
                      "bare_commits_oracle_aborts": flipped}
        torch.cuda.synchronize()
        for k, c in K.LAUNCHES.items():
            launches[k] += c
        del sup
        torch.cuda.empty_cache()
    c3, sp = out["config3"], out["shared_prefix"]
    print(f"long_keys: supervised verdicts equal the oracle on "
          f"{c3['batches']} config-3 batches ({c3['rechecked_batches']} "
          f"rechecked) and {sp['batches']} shared-prefix batches "
          f"({sp['rechecked_batches']} rechecked); the bare set's extra "
          f"aborts: config 3 {c3['bare_extra_aborts']}/{c3['txns']} txns, "
          f"shared 31-byte prefix {sp['bare_extra_aborts']}/{sp['txns']} "
          f"txns ({100 * sp['bare_extra_abort_rate']:.2f}% of txns, of "
          f"{sp['oracle_commits']} the oracle commits); txns the bare set "
          f"commits and the oracle aborts (behind a writer it aborted "
          f"wrongly): config 3 {c3['bare_commits_oracle_aborts']}, shared "
          f"prefix {sp['bare_commits_oracle_aborts']} -- {smi}", flush=True)
    out["card"] = smi
    return launches, out


def degrade_stream(seed: int):
    """N_DEGRADE small config-2 batches of TXNS_DEGRADE txns; every other
    one also carries a clear of 1-100 keys, so it takes the general step
    and the mirror holds ranges that are not points (the promotion's
    rebuild replays those through the general step too)."""
    from foundationdb_tpu_torch.txn.types import CommitTransactionRef, KeyRange
    rng = np.random.default_rng(seed)
    out = []
    for i, (v, _, kids, snaps) in enumerate(
            make_stream(rng, N_DEGRADE, txns=TXNS_DEGRADE)):
        txns = to_transactions(kids, snaps)
        if i % 2:
            a = int(rng.integers(0, KEYSPACE - SCAN_MAX))
            b = a + int(rng.integers(1, SCAN_MAX + 1))
            txns.append(CommitTransactionRef(write_conflict_ranges=[
                KeyRange(b"k%014d" % a, b"k%014d" % b)]))
        out.append((v, txns))
    return out


def supervised_degrade(smi: str):
    """Phase 16: force_device_error = ["timeout"] on one dispatch with
    N_INFLIGHT batches in flight at depth 8, a monitor whose re-probe is
    due at once: one degrade (the in-flight batches replay in order
    through the mirror), one promotion (a TorchConflictSet on the card
    rebuilt from the mirror, through the compact and the general step),
    then the device again; codes equal the oracle's over the whole
    stream."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet
    from foundationdb_tpu_torch.conflict.supervisor import (
        BackendHealthMonitor, SupervisedConflictSet)
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
    from foundationdb_tpu_torch.core.trace import recent_events
    stream = degrade_stream(2030)
    with port_knobs(CONFLICT_PIPELINE_DEPTH=DEPTH):
        K.reset_counts()
        sup = SupervisedConflictSet(
            lambda oldest_version=0: TorchConflictSet(
                oldest_version, capacity=CAPACITY,
                delta_capacity=DELTA_CAPACITY, device=DEVICE),
            monitor=BackendHealthMonitor(reprobe_interval_s=0.0))
        handles = []
        for i, (v, txns) in enumerate(stream):
            if i == N_INFLIGHT:
                if len(sup._pending) != N_INFLIGHT or sup.degraded:
                    raise AssertionError("degrade: batches not in flight")
                sup.force_device_error = ["timeout"]
            handles.append(sup.resolve_async(txns, v, floor(v)))
            if i == N_INFLIGHT and not sup.degraded:
                raise AssertionError("degrade: the injected timeout did "
                                     "not degrade")
        oracle = OracleConflictSet(0)
        for i, (h, (v, txns)) in enumerate(zip(handles, stream)):
            want = np.asarray([int(x) for x in oracle.resolve(
                txns, v, floor(v))], dtype=np.int8)
            if not np.array_equal(h.wait_codes(), want):
                raise AssertionError(f"degrade: codes differ from the "
                                     f"oracle on batch {i}")
            if (i <= N_INFLIGHT) != h.via_fallback:
                raise AssertionError(f"degrade: batch {i} took the wrong "
                                     f"route (via_fallback {h.via_fallback})")
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
    st = sup.status()
    after = N_DEGRADE - N_INFLIGHT - 1
    if (st["degrades"], st["promotions"], st["fallback_batches"],
            st["device_batches"]) != (1, 1, N_INFLIGHT + 1, after) \
            or st["degraded"] or type(sup.device).__name__ != \
            "TorchConflictSet" or sup.device.device.type != DEVICE:
        raise AssertionError(f"degrade and promotion: {st}")
    prof = sup.device.profile
    general_after = sum(i % 2 for i in range(N_INFLIGHT + 1, N_DEGRADE))
    rebuilt = (prof["batches"] - after,
               prof["general_batches"] - general_after)
    if rebuilt[1] <= 0:
        raise AssertionError(f"promotion replayed no range: {prof}")
    segments = recent_events("ConflictBackendPromoted")[-1]["Segments"]
    print(f"degrade: a timeout injected at dispatch {N_INFLIGHT} with "
          f"{N_INFLIGHT} batches in flight at depth {DEPTH}: 1 degrade, "
          f"{N_INFLIGHT + 1} batches replayed in order through the mirror, "
          f"1 promotion (the device rebuilt from {segments} mirror "
          f"segments in {rebuilt[0]} batches, {rebuilt[1]} of them general "
          f"steps), then {after} device batches; codes equal the oracle's "
          f"on all {N_DEGRADE} batches of {TXNS_DEGRADE} txns -- {smi}",
          flush=True)
    return launches, {"degrades": 1, "promotions": 1,
                      "fallback_batches": N_INFLIGHT + 1,
                      "device_batches_after": after,
                      "rebuild_batches": rebuilt[0],
                      "rebuild_general_steps": rebuilt[1],
                      "mirror_segments": segments, "card": smi}


def supervised_sharded(smi: str, splits, batches):
    """Phase 17: ShardedTorchConflictSet.supervised on phase 10's mesh
    with config 5's splits, capacity and delta, filled at depth 3 over
    N_SUPERVISED5 batches, then the 2,048 at-capacity re-reads."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.parallel import ShardedTorchConflictSet
    from foundationdb_tpu_torch.txn.types import CommitTransactionRef, KeyRange
    txns = [to_transactions(kids, snaps)
            for _, _, kids, snaps in batches[:N_SUPERVISED5 + 1]]
    with port_knobs(CONFLICT_PIPELINE_DEPTH=CONFIG5_DEPTH):
        K.reset_counts()
        sup = ShardedTorchConflictSet.supervised(
            shard_mesh(), 0, capacity=CONFIG5_CAPACITY // N_SHARDS,
            delta_capacity=CONFIG5_DELTA // N_SHARDS, gc_interval_batches=8,
            splits=splits)
        v, enc, probe_kids, _ = batches[0]
        codes = sup.resolve_encoded_async(enc, v, 0, transactions=txns[0]
                                          ).wait_codes().copy()
        inserted, n_ranges = int(np.sum(codes == 2)), 0
        inflight = deque()
        t0 = time.perf_counter()
        for i in range(1, N_SUPERVISED5 + 1):
            v, enc, _, _ = batches[i]
            inflight.append((enc, sup.resolve_encoded_async(
                enc, v, 0, transactions=txns[i])))
            while len(inflight) >= CONFIG5_DEPTH or (
                    i == N_SUPERVISED5 and inflight):
                e, h = inflight.popleft()
                inserted += int(np.sum(h.wait_codes() == 2))
                n_ranges += e.n_ranges
        rate = n_ranges / (time.perf_counter() - t0)
        nr = CONFIG5_TXNS * READS
        committed = np.asarray(probe_kids[nr:])[codes == 2][:N_PROBE5]
        probe = [CommitTransactionRef(
            read_snapshot=0, read_conflict_ranges=[KeyRange(k, k + b"\x00")])
            for k in (b"k%014d" % int(x) for x in committed)]
        verdicts = sup.resolve(probe, v + VERSIONS_PER_BATCH, 0)
        conflicts = sum(1 for x in verdicts if int(x) == 0)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
    st = check_supervised(sup, N_SUPERVISED5 + 2, "ShardedTorchConflictSet")
    print(f"path_supervised_sharded: {inserted} committed in-flight writes "
          f"after {N_SUPERVISED5 + 1} batches at depth {CONFIG5_DEPTH} "
          f"({sup.device.profile['merges']} merges), fill {rate:.1f} "
          f"ranges/s, probe {conflicts}/{len(probe)} conflicts, "
          f"pipeline_stalls {st['pipeline_stalls']}, no degrade -- {smi}",
          flush=True)
    if len(probe) != N_PROBE5 or conflicts != len(probe):
        raise AssertionError(f"supervised config 5 probe: "
                             f"{conflicts}/{len(probe)}")
    return launches, {"in_flight_writes": inserted,
                      "fill_ranges_per_s": rate,
                      "batches": N_SUPERVISED5 + 1,
                      "probe_conflicts": conflicts,
                      "probe_reads": len(probe), "depth": CONFIG5_DEPTH,
                      "card": smi}


def auto_backend(smi: str):
    """Phase 18: new_conflict_set("auto") on the card is the supervised
    torch set on `cuda`; one small config-2 batch through it."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.conflict.api import new_conflict_set
    K.reset_counts()
    sup = new_conflict_set("auto")
    if type(sup).__name__ != "SupervisedConflictSet":
        raise AssertionError(f'"auto" gave {type(sup).__name__}')
    v, enc, kids, snaps = make_stream(np.random.default_rng(2031), 1,
                                      txns=N_LOWC_SMALL_TXNS)[0]
    sup.resolve_encoded_async(enc, v, floor(v), transactions=to_transactions(
        kids, snaps)).wait_codes()
    torch.cuda.synchronize()
    check_supervised(sup, 1, "TorchConflictSet")
    if sup.device.device.type != "cuda":
        raise AssertionError(f'"auto" runs on {sup.device.device}')
    print(f'auto: new_conflict_set("auto") is SupervisedConflictSet over '
          f'TorchConflictSet on {sup.device.device} (capacity '
          f'{sup.device.capacity}) -- {smi}', flush=True)
    return dict(K.LAUNCHES)


# ------------------------------------------------------ the Resolver role
N_ROLE = N_WARMUP + N_MEASURED
STATE_EVERY = 100               # 1% of a batch's txns are state txns
PROXIES = ("p0", "p1")
N_ROLE_SMALL, ROLE_SMALL_TXNS, ROLE_SMALL_KEYS = 6, 1_000, 2_000


def role_requests(versions, txns) -> list:
    """The role's requests over a stream: batches alternate between p0 and
    p1 on one version chain (batch 0's predecessor is the recovery
    version, 0); a proxy's last_received_version is the version of its
    own previous batch; every STATE_EVERY-th txn is a state transaction
    with one mutation."""
    from dataclasses import replace
    from foundationdb_tpu_torch.txn.types import Mutation
    out, prev, last = [], 0, {}
    for i, (v, tx) in enumerate(zip(versions, txns)):
        proxy = PROXIES[i % 2]
        state = list(range(0, len(tx), STATE_EVERY))
        tx = list(tx)
        for t in state:
            tx[t] = replace(tx[t], mutations=[Mutation.set_value(
                b"\xff/conf/%d/%d" % (i, t), b"v%d" % t)])
        out.append({"prev": prev, "version": v, "lrv": last.get(proxy, 0),
                    "proxy": proxy, "txns": tx, "state": state})
        last[proxy] = v
        prev = v
    return out


def role_order(n: int) -> list:
    """Delivery order: the warmup batches in order, then every pair
    second-first (the second is parked until the first has resolved)."""
    order = list(range(min(N_WARMUP, n)))
    for j in range(N_WARMUP, n, 2):
        order += [j + 1, j] if j + 1 < n else [j]
    return order


class RoleReply:
    """A reply promise that logs (request, time sent, value)."""

    def __init__(self, log: list, key) -> None:
        self.log, self.key = log, key

    def send(self, value) -> None:
        self.log.append((self.key, time.perf_counter(), value))


def drive_role(role, reqs) -> dict:
    """Deliver `reqs` to the role in role_order, then resend the chain's
    last batch.  A pair's second request must park.  Returns the replies
    by request (the resend under "resend"), their times, the delivery
    times, and the resolves the resend added (must be 0)."""
    from foundationdb_tpu_torch.server import ResolveTransactionBatchRequest

    def request(r, key, log):
        return ResolveTransactionBatchRequest(
            r["prev"], r["version"], r["lrv"], r["txns"],
            txn_state_transactions=r["state"], proxy_id=r["proxy"],
            reply=RoleReply(log, key))

    log, delivered, parked = [], {}, 0
    for i in role_order(len(reqs)):
        delivered[i] = time.perf_counter()
        role.resolve_batch(request(reqs[i], i, log))
        parked = max(parked, role.parked())
    if parked != 1 or role.parked() != 0:
        raise AssertionError(f"parking: at most {parked} parked, "
                             f"{role.parked()} left")
    resolved = role.resolved_batches
    role.resolve_batch(request(reqs[-1], "resend", log))
    replies = {k: v for k, _, v in log}
    times = {k: t for k, t, _ in log}
    if [k for k, _, _ in log] != list(range(len(reqs))) + ["resend"]:
        raise AssertionError(f"replies out of chain order: "
                             f"{[k for k, _, _ in log]}")
    if replies["resend"] is not replies[len(reqs) - 1]:
        raise AssertionError("the resend was not answered from the cache")
    return {"replies": replies, "times": times, "delivered": delivered,
            "resend_resolves": role.resolved_batches - resolved}


def check_state_broadcast(role, reqs, replies) -> int:
    """Each reply carries exactly the other proxy's state txns resolved
    after its last_received_version and before its version, with their
    local verdicts; total_state_bytes counts the entries the role still
    holds.  Returns the entries broadcast."""
    entries, sent = [], 0
    for i, r in enumerate(reqs):
        want = [e for e in entries
                if r["lrv"] < e[0] < r["version"] and e[1] != r["proxy"]]
        got = [(v, p, s, int(verdict)) for v, p, s, _, verdict in
               replies[i].state_transactions]
        if got != want:
            raise AssertionError(f"state broadcast of batch {i}: {len(got)} "
                                 f"entries, expected {len(want)}")
        sent += len(got)
        entries += [(r["version"], r["proxy"], seq,
                     int(replies[i].committed[t]))
                    for seq, t in enumerate(r["state"])]
    held = sum(m.expected_size() for e in role.state_txns for m in e[3])
    if held != role.total_state_bytes or not sent:
        raise AssertionError(f"state bytes {role.total_state_bytes}, held "
                             f"{held}, broadcast {sent}")
    return sent


def role_small_stream(seed: int):
    """A small contended stream of 15-byte point keys: one read and one
    write a txn, zipf(1.2) over ROLE_SMALL_KEYS keys, snapshots up to 7
    batches behind (some below the floor), a third of the txns reporting
    their conflicting keys, tenants and tags set.  One read a txn: a txn
    whose reads conflict both with the history and within the batch is
    blamed on the history's read by the oracle and on the batch's first
    by the supervised set's mirror (both true culprits; the reference's
    two do the same)."""
    from foundationdb_tpu_torch.txn.types import CommitTransactionRef, KeyRange
    rng = np.random.default_rng(seed)
    versions, txns, version = [], [], 1_000
    for _ in range(N_ROLE_SMALL):
        prev, version = version, version + VERSIONS_PER_BATCH
        batch = []
        for t in range(ROLE_SMALL_TXNS):
            r, w = [b"k%014d" % (int(k) % ROLE_SMALL_KEYS)
                    for k in rng.zipf(1.2, size=2)]
            batch.append(CommitTransactionRef(
                read_conflict_ranges=[KeyRange(r, r + b"\x00")],
                write_conflict_ranges=[KeyRange(w, w + b"\x00")],
                read_snapshot=max(prev - int(rng.integers(
                    0, 7 * VERSIONS_PER_BATCH)), 0),
                report_conflicting_keys=bool(rng.random() < 1 / 3),
                tenant_id=int(rng.integers(-1, 4)),
                tag=("", "t/a", "t/b")[int(rng.integers(0, 3))]))
        versions.append(version)
        txns.append(batch)
    return versions, txns


def role_parity(smi: str) -> dict:
    """The role on the card against a role over the port's oracle on a
    small contended stream: every reply field for field, the counters and
    the heat tables equal.  Every abort is attributed exactly
    (CONFLICT_ATTRIBUTION_SAMPLE raised to the batch size), as the
    oracle's are; txns read one key (role_small_stream says why), so the
    supervised set's conflicting ranges are the oracle's too."""
    from foundationdb_tpu_torch.server import Resolver
    versions, txns = role_small_stream(2033)
    reqs = role_requests(versions, txns)
    with port_knobs(MAX_WRITE_TRANSACTION_LIFE_VERSIONS=WINDOW,
                    CONFLICT_ATTRIBUTION_SAMPLE=ROLE_SMALL_TXNS):
        card = Resolver("r1", 0, backend="torch", proxy_ids=list(PROXIES),
                        capacity=CAPACITY, delta_capacity=DELTA_CAPACITY)
        oracle = Resolver("r2", 0, backend="cpu", proxy_ids=list(PROXIES))
        got, want = drive_role(card, reqs), drive_role(oracle, reqs)

    def fields(reply):
        return ([int(c) for c in reply.committed],
                {i: list(r) for i, r in reply.conflicting_ranges.items()},
                dict(reply.attribution_exact),
                [(v, p, s, int(x)) for v, p, s, _, x in
                 reply.state_transactions])

    for i in range(len(reqs)):
        if fields(got["replies"][i]) != fields(want["replies"][i]):
            raise AssertionError(f"role on the card differs from the "
                                 f"oracle role on small batch {i}")
    for name in ("TxnResolved", "TxnConflicts", "HeatConflictRanges",
                 "HeatConservativeTxns", "TxnResolvedDegraded"):
        a = card.metrics.counter(name).value
        b = oracle.metrics.counter(name).value
        if a != b:
            raise AssertionError(f"{name}: {a} on the card, {b} oracle")
    for table in ("ranges", "tenants", "tags", "range_tags",
                  "range_tenants"):
        # Equal as tables: the oracle attributes a batch's history
        # conflicts before its intra-batch ones, the mirror in txn order,
        # so rows new to the table arrive in another order (which no
        # query reads: top-K and splits sort).
        if getattr(card.heat, table) != getattr(oracle.heat, table):
            raise AssertionError(f"heat table {table} differs")
    if card.heat_status() != oracle.heat_status():
        raise AssertionError("heat_status differs")
    check_supervised(card.conflict_set, len(reqs), "TorchConflictSet")
    codes = np.concatenate([fields(got["replies"][i])[0]
                            for i in range(len(reqs))])
    counts = {c: int(np.sum(codes == c)) for c in (0, 1, 2)}
    if min(counts.values()) == 0:
        raise AssertionError(f"small stream degenerate: {counts}")
    reported = sum(len(got["replies"][i].conflicting_ranges)
                   for i in range(len(reqs)))
    print(f"role_parity: the role on the card equals a role over the "
          f"oracle on {len(reqs)} batches of {ROLE_SMALL_TXNS} txns "
          f"(verdicts {counts}, {reported} reporters answered, "
          f"{card.heat.total_conflicts} conflicts attributed, "
          f"{len(card.heat.ranges)} heat rows): replies, counters and heat "
          f"tables equal -- {smi}", flush=True)
    return {"batches": len(reqs), "verdicts": counts, "reported": reported,
            "conflicts_attributed": card.heat.total_conflicts}


def resolver_path(smi: str, batches, txns, want_codes):
    """Phase 19: the port's Resolver role on the card over phase 14's
    config-2 stream (N_WARMUP + N_MEASURED batches, its object form), its
    floor WINDOW behind each version as floor(v); replies, parking, the
    resend, the state broadcast and the codes checked; the path_resolver
    line.  Then the small contended stream against an oracle role."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.conflict.encoded import EncodedBatch
    from foundationdb_tpu_torch.server import Resolver
    reqs = role_requests([b[0] for b in batches[:N_ROLE]], txns[:N_ROLE])
    with port_knobs(MAX_WRITE_TRANSACTION_LIFE_VERSIONS=WINDOW):
        role = Resolver("r0", 0, backend="torch", proxy_ids=list(PROXIES),
                        capacity=CAPACITY, delta_capacity=DELTA_CAPACITY)
        # Timers: the set's call, the object-form encode inside it, the
        # role's whole run of a request, and its load sampling alone.
        spans = {"set": [], "encode": [], "own": [], "sample": []}
        encode = EncodedBatch.__dict__["from_transactions"]

        def timed_encode(cls, transactions):
            t1 = time.perf_counter()
            try:
                return encode.__func__(cls, transactions)
            finally:
                spans["encode"].append((t1, time.perf_counter()))

        for owner, name, key in ((role.conflict_set,
                                  "resolve_with_conflicts", "set"),
                                 (role, "_resolve_one", "own"),
                                 (role, "_sample_batch", "sample")):
            fn = getattr(owner, name)

            def timed(*a, fn=fn, key=key, **kw):
                t1 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    spans[key].append((t1, time.perf_counter()))

            setattr(owner, name, timed)
        EncodedBatch.from_transactions = classmethod(timed_encode)
        try:
            K.reset_counts()
            drive = drive_role(role, reqs)
            torch.cuda.synchronize()
            launches = dict(K.LAUNCHES)
        finally:
            EncodedBatch.from_transactions = encode
    replies = drive["replies"]
    for i, r in enumerate(reqs):
        got = np.asarray([int(c) for c in replies[i].committed], np.int8)
        if not np.array_equal(got, want_codes[i]):
            raise AssertionError(f"the role's codes differ from phase 14's "
                                 f"on batch {i}")
    if drive["resend_resolves"] != 0 or len(spans["set"]) != len(reqs) \
            or len(spans["encode"]) != len(reqs):
        raise AssertionError(f"the resend resolved: "
                             f"{drive['resend_resolves']} batches, "
                             f"{len(spans['set'])} set calls")
    st = check_supervised(role.conflict_set, len(reqs), "TorchConflictSet")
    if st["rechecked_batches"] != 0 or \
            role.metrics.counter("TxnResolvedDegraded").value != 0:
        raise AssertionError(f"rechecked or degraded: {st}")
    if role.metrics.counter("TxnResolved").value != N_ROLE * TXNS:
        raise AssertionError("TxnResolved miscounted")
    broadcast = check_state_broadcast(role, reqs, replies)

    # Figures over the measured batches (chain order N_WARMUP..N_ROLE-1).
    measured = range(N_WARMUP, N_ROLE)
    order = role_order(N_ROLE)
    t0 = drive["delivered"][order[N_WARMUP]]
    t1 = max(drive["times"][i] for i in measured)
    n_ranges = sum(batches[i][1].n_ranges for i in measured)
    rate = n_ranges / (t1 - t0)
    lat = [drive["times"][i] - drive["delivered"][i] for i in measured]
    own = [b - a for a, b in spans["own"]]
    set_s = [b - a for a, b in spans["set"]]
    encode_s = [b - a for a, b in spans["encode"]]
    sample = [b - a for a, b in spans["sample"]]
    # A request's run starts when the role takes it up: its queue wait is
    # from delivery to there (a parked one waits for its predecessor).
    starts = sorted(a for a, _ in spans["own"])
    chain_start = {i: starts[n] for n, i in enumerate(range(N_ROLE))}
    queue = [chain_start[i] - drive["delivered"][i] for i in measured]

    def p50(xs, idx=measured):
        return float(np.percentile([xs[i] for i in idx], 50) * 1e3)

    host = [o - s for o, s in zip(own, set_s)]
    hists = {h: role.metrics.histogram(h).snapshot().percentile(0.5) * 1e3
             for h in ("Resolve", "QueueWait")}
    path = {"ranges_per_s": rate, "p50_request_ms": float(
                np.percentile(lat, 50) * 1e3),
            "p50_set_call_ms": p50(set_s),
            "p50_object_encode_ms": p50(encode_s), "p50_own_ms": p50(own),
            "p50_host_beyond_set_ms": p50(host),
            "p50_sample_batch_ms": p50(sample),
            "p50_queue_wait_ms": float(np.percentile(queue, 50) * 1e3),
            "resolve_hist_p50_ms": hists["Resolve"],
            "queue_wait_hist_p50_ms": hists["QueueWait"],
            "state_entries_broadcast": broadcast,
            "total_state_bytes": role.total_state_bytes,
            "heat_rows": len(role.heat.ranges), "batches": N_ROLE,
            "measured": len(measured), "txns_per_batch": TXNS, "card": smi}
    print(f"path_resolver: {rate:.1f} ranges/s over {len(measured)} "
          f"chain-serialised requests, p50 {path['p50_request_ms']:.3f} ms "
          f"a request (delivery to reply; every other parked behind its "
          f"predecessor), the set's call p50 {path['p50_set_call_ms']:.3f} "
          f"ms (its object-form encode {path['p50_object_encode_ms']:.3f} "
          f"ms; Resolve histogram p50 bucket {hists['Resolve']:.3f} ms), "
          f"the role's host work beyond it p50 "
          f"{path['p50_host_beyond_set_ms']:.3f} ms of which _sample_batch "
          f"{path['p50_sample_batch_ms']:.3f} ms, QueueWait p50 "
          f"{path['p50_queue_wait_ms']:.3f} ms (histogram bucket "
          f"{hists['QueueWait']:.3f} ms); {broadcast} state entries "
          f"broadcast, the resend answered from the cache, codes equal "
          f"phase 14's on {N_ROLE} batches -- {smi}", flush=True)
    del role
    torch.cuda.empty_cache()
    path["parity"] = role_parity(smi)
    torch.cuda.empty_cache()
    # Phase 26 sends the same requests over TCP and holds the remote
    # role's replies to this in-process role's.
    in_process = [reply_of_role(replies[i]) for i in range(len(reqs))]
    return launches, path, (reqs, in_process)


def reply_of_role(reply) -> tuple:
    """A resolve reply as (codes, state broadcast, conflicting ranges,
    exactness), every field plain, for bit-for-bit comparison."""
    return (np.asarray([int(c) for c in reply.committed], np.int8),
            [(v, p, s, [(int(m.type), m.param1, m.param2) for m in muts],
              int(c)) for v, p, s, muts, c in reply.state_transactions],
            {k: [tuple(r) for r in v]
             for k, v in reply.conflicting_ranges.items()},
            dict(reply.attribution_exact))


def entry_points(smi: str) -> dict:
    """Phase 19's last part: the entry points of entry.py on the card.
    entry()'s window_query against its plain version on the same
    arguments, at snapshot 0 (no conflict) and -1 (every query
    conflicts); dryrun_multichip(4) over a mesh naming `cuda` four times.
    Returns the launches."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.entry import dryrun_multichip, entry
    K.reset_counts()
    fn, args = entry()
    if args[0].device.type != DEVICE:
        raise AssertionError(f"entry() runs on {args[0].device}")
    for shift in (0, -1):
        a = args[:4] + (args[4] + shift,) + args[5:]
        got = fn(*a)
        torch.cuda.synchronize()
        want = fn(*a, impl="plain")
        if not torch.equal(got, want) or \
                int(got.sum()) != (0 if shift == 0 else got.numel()):
            raise AssertionError(f"entry(): window_query at snapshot "
                                 f"{shift} differs from its plain version")
    dryrun_multichip(4)
    torch.cuda.synchronize()
    print(f"entry: window_query at the reference's shapes (2^12 window, "
          f"256 queries) equals its plain version; dryrun_multichip(4) on "
          f"{torch.cuda.get_device_name(0)} agrees with the oracle -- {smi}",
          flush=True)
    return dict(K.LAUNCHES)


# ---------------------------------------------------- the resolution plane
# Phase 20: N Resolver roles behind the commit proxies' resolution stage
# (server/commit_proxy.py, server/master.py, server/cluster.py).  Stream A
# keeps each txn inside one quarter of the ids, on the N = 4 cuts, so
# N = 2 and 4 must equal N = 1 bit for bit.  Stream B is config 2 as
# generated: a txn that one resolver aborts still leaves its writes at the
# resolvers that committed it locally (as in the reference), so there each
# resolver is held against a point oracle over its own fragments, and the
# aborts N resolvers make beyond one resolver's are counted.
PLANE_NS = (1, 2, 4)
# Stream A's readings: N = 1 is read again last, so that its builder's
# time is seen twice in one run.
PLANE_A_READINGS = (("1", 1), ("2", 2), ("4", 4), ("1 again", 1))
PLANE_SHARDS, PLANE_CELLS = 16, 4
# Cut to hold phase 20 near 150 s on the card (2 + 6 and 3 + 9 took
# 237.8 s there): batch counts, never the 100K-txn width; stream A cut
# again from 1 + 4 to 1 + 2 to make room for phase 24.
N_PLANE_A = (1, 2)              # stream A: warmup, measured batches
N_PLANE_B = (2, 5)              # stream B
PLANE_SMALL_CAPACITY = 1 << 12
# The small straddling stream: waves of txns, the wave after which one
# balancing step must move a boundary, and the write window it runs under
# (its snapshots lag up to 5 waves: some are too old, and the proxies'
# ownership histories are trimmed).
STRADDLE_WAVES, STRADDLE_TXNS, STRADDLE_MOVE_AFTER = 12, 24, 5
STRADDLE_LIFE = 4 * VERSIONS_PER_BATCH
STRADDLE_Z = (b"\x3f\xff", b"\x7f\xff")


def plane_boundaries(n: int) -> list:
    """seed_resolver_boundaries over a 16-shard key-servers map that cuts
    the KEYSPACE ids evenly: what DD's even-volume shards give for equal
    records (static byte splits would put every b"k..." key on one
    resolver)."""
    from foundationdb_tpu_torch.server import seed_resolver_boundaries
    begins = [b""] + [b"k%014d" % (KEYSPACE * i // PLANE_SHARDS)
                      for i in range(1, PLANE_SHARDS)]
    ends = begins[1:] + [b"\xff"]
    return seed_resolver_boundaries(
        [(b, e, [i]) for i, (b, e) in enumerate(zip(begins, ends))], n)


def plane_stream(rng, count: int, cells: int = 0) -> list:
    """`count` config-2 batches in object form, [(version, txns)]; with
    `cells`, stream A's (each txn inside one cell)."""
    out, version = [], 1_000
    for _ in range(count):
        prev, version = version, version + VERSIONS_PER_BATCH
        kids, snaps = point_draws(rng, prev, KEYSPACE, True, cells=cells)
        out.append((version, to_transactions(kids, snaps)))
    return out


def request_ranges(req) -> int:
    return sum(len(t.read_conflict_ranges) + len(t.write_conflict_ranges)
               for t in req.transactions)


def codes_of(committed) -> np.ndarray:
    return np.fromiter(map(int, committed), np.int8, len(committed))


class GcClock:
    """The Python collector's time and full collections while installed
    in gc.callbacks."""

    def __init__(self) -> None:
        self.s, self.full, self._t = 0.0, 0, None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.s += time.perf_counter() - self._t
            self.full += info["generation"] == 2
            self._t = None


def instrument_plane(plane) -> dict:
    """Timers on a plane: each proxy's request build (seconds a call,
    and the index maps it returned last) and each role's resolve_batch
    (seconds a call, launches by wrapper, the last request it answered)."""
    from foundationdb_tpu_torch import kernels as K
    n = len(plane.resolvers)
    spans = {"build": [], "index_maps": None, "role_s": [[] for _ in
                                                         range(n)],
             "role_launches": [dict.fromkeys(K.LAUNCHES, 0)
                               for _ in range(n)],
             "request": [None] * n}
    for proxy in plane.proxies.values():
        def build(*a, fn=proxy._build_resolution_requests):
            t1 = time.perf_counter()
            requests, index_maps = fn(*a)
            spans["build"].append(time.perf_counter() - t1)
            spans["index_maps"] = index_maps
            return requests, index_maps

        proxy._build_resolution_requests = build
    for k, role in enumerate(plane.resolvers):
        def resolve(req, fn=role.resolve_batch, k=k):
            before = dict(K.LAUNCHES)
            t1 = time.perf_counter()
            fn(req)
            spans["role_s"][k].append(time.perf_counter() - t1)
            for name, c in K.LAUNCHES.items():
                spans["role_launches"][k][name] += c - before[name]
            spans["request"][k] = req

        role.resolve_batch = resolve
    return spans


def check_plane_roles(plane, n_batches: int, spans=None,
                      device: str = DEVICE) -> None:
    """Every role's set on `device`, never degraded, every batch there;
    with `spans`, every role launched the point path's wrappers (the
    merge only where one ran)."""
    for k, role in enumerate(plane.resolvers):
        check_supervised(role.conflict_set, n_batches, "TorchConflictSet",
                         device)
        if role.metrics.counter("TxnResolvedDegraded").value != 0:
            raise AssertionError(f"resolver {k} resolved degraded")
        if spans is None:
            continue
        launched = spans["role_launches"][k]
        missing = [w for w in PATH_KERNELS["point"]
                   if w != "merge" and launched[w] <= 0]
        if missing:
            raise AssertionError(f"resolver {k} did not launch {missing}")


def plane_aligned(smi: str, stream) -> dict:
    """Stream A at N = 1, 2, 4 and 1 again, one proxy: the merged
    verdicts of every reading equal the first N = 1's batch for batch;
    the requests' build ms, each resolver's share and ranges/s, bench.py's
    aggregate model, the plane's serial wall and the collector's ms over
    the measured batches."""
    import gc
    import torch
    from foundationdb_tpu_torch.server import ResolutionPlane
    warm = N_PLANE_A[0]
    out, base = {}, None
    for label, n in PLANE_A_READINGS:
        plane = ResolutionPlane(n, ["p0"], boundaries=plane_boundaries(n),
                                device=DEVICE, capacity=CAPACITY,
                                delta_capacity=DELTA_CAPACITY)
        spans = instrument_plane(plane)
        codes, walls, ranges, prev = [], [], [0] * n, 0
        clock = GcClock()
        for i, (v, txns) in enumerate(stream):
            if i == warm:
                gc.callbacks.append(clock)
            t1 = time.perf_counter()
            reply = plane.resolve("p0", txns, prev, v)
            walls.append(time.perf_counter() - t1)
            prev = v
            codes.append(codes_of(reply.committed))
            if i >= warm:
                for k in range(n):
                    ranges[k] += request_ranges(spans["request"][k])
        gc.callbacks.remove(clock)
        torch.cuda.synchronize()
        check_plane_roles(plane, len(stream), spans)
        if base is None:
            base = codes
        for i, (a, b) in enumerate(zip(codes, base)):
            if not np.array_equal(a, b):
                raise AssertionError(f"stream A: N = {label} differs from "
                                     f"N = 1 on batch {i} "
                                     f"({int(np.sum(a != b))} txns)")
        elapsed = [sum(spans["role_s"][k][warm:]) for k in range(n)]
        total = sum(ranges)
        out[label] = {
            "build_p50_ms": float(np.percentile(spans["build"][warm:], 50)
                                  * 1e3),
            "shares": [r / total for r in ranges],
            "per_resolver_ranges_per_s": [r / s for r, s in
                                          zip(ranges, elapsed)],
            "aggregate_ranges_per_s_model": total / max(elapsed),
            "serial_wall_p50_ms": float(np.percentile(walls[warm:], 50)
                                        * 1e3),
            "gc_ms_per_batch": clock.s * 1e3 / (len(stream) - warm),
            "gc_full_collections": clock.full,
            "ranges": total}
        del plane, spans
        torch.cuda.empty_cache()
    flat = np.concatenate(base)
    verdicts = {c: int(np.sum(flat == c)) for c in (0, 1, 2)}
    if verdicts[0] == 0 or verdicts[2] == 0:
        raise AssertionError(f"stream A degenerate: {verdicts}")
    for n, f in out.items():
        print(f"path_plane A N={n}: request build p50 "
              f"{f['build_p50_ms']:.1f} ms "
              f"a batch, shares "
              f"{[round(s, 4) for s in f['shares']]}, per resolver "
              f"{[round(r, 1) for r in f['per_resolver_ranges_per_s']]} "
              f"ranges/s, aggregate (model: total ranges over the slowest "
              f"resolver's time, one role a process) "
              f"{f['aggregate_ranges_per_s_model']:.1f} ranges/s, serial "
              f"wall p50 {f['serial_wall_p50_ms']:.1f} ms a batch, the "
              f"collector {f['gc_ms_per_batch']:.1f} ms a batch "
              f"({f['gc_full_collections']} full) -- {smi}",
              flush=True)
    return {"per_n": out, "verdicts": verdicts, "batches": len(stream),
            "measured": len(stream) - warm}


def plane_straddling(smi: str, stream) -> dict:
    """Stream B at N = 4: two proxies alternating on one chain, 1% state
    txns, a balancing step after every batch.  Each resolver's codes equal
    a point oracle over its own fragments and the merged verdicts their
    min; each proxy receives every other proxy's committed state txn
    once; at least one move adopted by both proxies.  Against one resolver
    (the point oracle over the whole txns) it counts the extra aborts and
    the commits one resolver would abort (a txn aborted by a phantom write
    no longer blocks a later one of its batch)."""
    import torch
    from foundationdb_tpu_torch.server import ResolutionPlane
    from foundationdb_tpu_torch.txn.types import CommitResult
    n, warm = 4, N_PLANE_B[0]
    reqs = role_requests([v for v, _ in stream], [t for _, t in stream])
    plane = ResolutionPlane(n, list(PROXIES), boundaries=plane_boundaries(n),
                            device=DEVICE, capacity=CAPACITY,
                            delta_capacity=DELTA_CAPACITY)
    spans = instrument_plane(plane)
    oracles, whole = [PointOracle() for _ in range(n)], PointOracle()
    moves, received, state = [], {p: [] for p in PROXIES}, []
    extra = fewer = aborts = aborts_one = 0
    shares, walls = [], []
    for i, r in enumerate(reqs):
        v = r["version"]
        t1 = time.perf_counter()
        reply = plane.resolve(r["proxy"], r["txns"], r["prev"], v)
        walls.append(time.perf_counter() - t1)
        got = codes_of(reply.committed)
        want = np.full(len(got), 2, np.int8)
        ranges = []
        for k in range(n):
            req = spans["request"][k]
            local = codes_of(req.reply.value.committed)
            oc = oracles[k].resolve_txns(req.transactions, v, floor(v))
            if not np.array_equal(local, oc):
                raise AssertionError(f"stream B batch {i}: resolver {k} "
                                     f"differs from its point oracle")
            np.minimum.at(want, np.asarray(spans["index_maps"][k],
                                           np.int64), oc)
            ranges.append(request_ranges(req))
        if not np.array_equal(got, want):
            raise AssertionError(f"stream B batch {i}: merged verdicts are "
                                 f"not the min of the resolvers' oracles")
        one = whole.resolve_txns(r["txns"], v, floor(v))
        if i >= warm:
            extra += int(np.sum((got != 2) & (one == 2)))
            fewer += int(np.sum((got == 2) & (one != 2)))
            aborts += int(np.sum(got != 2))
            aborts_one += int(np.sum(one != 2))
        shares.append([x / sum(ranges) for x in ranges])
        for e in reply.state_transactions:
            if e[4] != CommitResult.COMMITTED:
                raise AssertionError(f"an aborted state txn applied: {e}")
            received[r["proxy"]].append(e[:3])
        state += [(v, r["proxy"], seq, int(got[t]))
                  for seq, t in enumerate(r["state"])]
        move = plane.balance(v)
        if move is not None:
            moves.append({"after_batch": i,
                          "begin": move[0].begin.decode("latin-1"),
                          "end": move[0].end.decode("latin-1"),
                          "to": move[1], "version": move[2]})
    torch.cuda.synchronize()
    check_plane_roles(plane, len(reqs), spans)
    if not moves or any(p._resolver_changes_hwm <= 0
                        for p in plane.proxies.values()):
        raise AssertionError(f"stream B: no boundary move adopted ({moves})")
    for p in PROXIES:
        last = max(r["version"] for r in reqs if r["proxy"] == p)
        want_state = [e[:3] for e in state
                      if e[1] != p and e[3] == 2 and e[0] < last]
        if received[p] != want_state:
            raise AssertionError(f"stream B: proxy {p} received "
                                 f"{len(received[p])} foreign state txns, "
                                 f"expected {len(want_state)}")
    measured = len(reqs) - warm
    path = {"extra_aborts": extra, "extra_commits": fewer,
            "aborts": aborts, "aborts_one_resolver": aborts_one,
            "txns": measured * TXNS, "moves": moves,
            "shares_first_batch": shares[0], "shares_last_batch": shares[-1],
            "build_p50_ms": float(np.percentile(spans["build"][warm:], 50)
                                  * 1e3),
            "serial_wall_p50_ms": float(np.percentile(walls[warm:], 50)
                                        * 1e3),
            "state_received": {p: len(x) for p, x in received.items()},
            "batches": len(reqs), "measured": measured}
    print(f"path_plane B N=4: {extra} extra aborts and {fewer} extra "
          f"commits over one resolver ({aborts} aborts against "
          f"{aborts_one} in {measured} x {TXNS} txns), {len(moves)} "
          f"moves, split at "
          f"{[(m['begin'], m['to']) for m in moves]}, shares "
          f"{[round(s, 4) for s in shares[0]]} first, "
          f"{[round(s, 4) for s in shares[-1]]} last; request build p50 "
          f"{path['build_p50_ms']:.1f} ms, serial wall p50 "
          f"{path['serial_wall_p50_ms']:.1f} ms a batch; each resolver "
          f"equals its "
          f"point oracle -- {smi}", flush=True)
    del plane, spans
    torch.cuda.empty_cache()
    return path


def parity_stream(seed: int = 11, waves: int = 16, per_wave: int = 24):
    """The reference's aligned parity stream
    (tests/test_resolution_plane.py _parity_stream), in the port's types
    and the small cases' shape [(proxy, prev, version, txns)]: waves
    aligned to four cells on the N = 4 static split points (a txn never
    straddles a boundary), snapshots 1-2 waves behind, a \\xff state txn
    every 5th wave."""
    import random
    from foundationdb_tpu_torch.txn.types import (CommitTransactionRef,
                                                  KeyRange, Mutation,
                                                  MutationType)
    rng = random.Random(seed)
    cells, cell_keys = 4, 64
    bounds = [bytes([(256 * i) // cells]) for i in range(cells)]

    def txn(reads=(), writes=(), mutations=(), snapshot=0):
        return CommitTransactionRef(
            read_conflict_ranges=[KeyRange(b, e) for b, e in reads],
            write_conflict_ranges=[KeyRange(b, e) for b, e in writes],
            mutations=list(mutations), read_snapshot=snapshot)

    stream = []
    for w in range(waves):
        version, prev = 1000 * (w + 1), 1000 * w
        txns = []
        for _ in range(per_wave):
            cell = rng.randrange(cells)
            snapshot = max(0, 1000 * (w - rng.randint(1, 2)))
            ks = [bounds[cell] + b"/k%03d" % rng.randrange(cell_keys)
                  for _ in range(3)]
            txns.append(txn(reads=[(k, k + b"\x00") for k in ks[:2]],
                            writes=[(ks[2], ks[2] + b"\x00")],
                            snapshot=snapshot))
        if w % 5 == 1:
            sysk = b"\xff/parity/%02d" % rng.randrange(4)
            txns.append(txn(
                reads=[(sysk, sysk + b"\x00")],
                writes=[(sysk, sysk + b"\x00")],
                mutations=[Mutation(MutationType.SetValue, sysk, b"v")],
                snapshot=max(0, 1000 * (w - 1))))
        stream.append((0, prev, version, txns))
    return stream


def straddle_stream(seed: int = 2036):
    """A small contended stream that straddles resolver boundaries, two
    proxies alternating on one chain: [(proxy, prev, version, txns)].
    Keys b"<c>/s<i>" over 16 first bytes c, 60% of draws on the four below
    \\x40; a txn reads one key (a quarter of them a range between two
    draws) and writes another (85%), at a snapshot 0-5 waves behind; a
    third of the point readers report their conflicting keys (a range read
    may reach one resolver as two fragments, which the device path blames
    together and the oracle one by one), tenants and tags set; a \\xff
    state txn every 3rd wave, a ClearRange across \\xff every 4th, a txn
    with no ranges now and then.  At wave 4 the keys STRADDLE_Z are
    written; at waves 7 and 8, after the forced move, they are read at a
    snapshot older than that write and than the move: they must conflict
    through the previous owner's history."""
    import random
    from foundationdb_tpu_torch.txn.types import (CommitTransactionRef,
                                                  KeyRange, Mutation,
                                                  MutationType)
    rng = random.Random(seed)
    hot = [0x05, 0x15, 0x25, 0x35]
    cold = list(range(0x45, 0x100, 0x10))

    def key():
        c = rng.choice(hot) if rng.random() < 0.6 else rng.choice(cold)
        return bytes([c]) + b"/s%d" % rng.randrange(3)

    def point(k):
        return KeyRange(k, k + b"\x00")

    stream = []
    for w in range(STRADDLE_WAVES):
        version, prev = 1000 * (w + 1), 1000 * w
        txns = []
        for t in range(STRADDLE_TXNS):
            snap = max(0, prev - 1000 * rng.randrange(6))
            if rng.random() < 0.04:
                txns.append(CommitTransactionRef(read_snapshot=snap))
                continue
            a, b = key(), key()
            read = KeyRange(min(a, b), max(a, b)) \
                if a != b and rng.random() < 0.25 else point(a)
            writes, muts = [], []
            if rng.random() < 0.85:
                k = key()
                writes.append(point(k))
                muts.append(Mutation(MutationType.SetValue, k, b"v"))
            txns.append(CommitTransactionRef(
                read_conflict_ranges=[read], write_conflict_ranges=writes,
                mutations=muts, read_snapshot=snap,
                report_conflicting_keys=(read.end == a + b"\x00" and
                                         rng.random() < 1 / 3),
                tenant_id=rng.randrange(-1, 3),
                tag=rng.choice(["", "t/a", "t/b"])))
        if w == 4:
            txns += [CommitTransactionRef(write_conflict_ranges=[point(z)],
                                          read_snapshot=prev)
                     for z in STRADDLE_Z]
        if w in (7, 8):
            txns += [CommitTransactionRef(
                read_conflict_ranges=[point(z)],
                write_conflict_ranges=[point(b"\x01/old%d" % w)],
                read_snapshot=4500, report_conflicting_keys=True)
                for z in STRADDLE_Z]
        if w % 3 == 1:
            sysk = b"\xff/plane/%d" % rng.randrange(3)
            txns.append(CommitTransactionRef(
                read_conflict_ranges=[point(sysk)],
                write_conflict_ranges=[point(sysk)],
                mutations=[Mutation(MutationType.SetValue, sysk, b"v")],
                read_snapshot=prev))
        if w % 4 == 2:
            txns.append(CommitTransactionRef(
                write_conflict_ranges=[KeyRange(b"\xfe/z", b"\xff\x01")],
                mutations=[Mutation(MutationType.ClearRange, b"\xfe/z",
                                    b"\xff\x01")],
                read_snapshot=prev))
        stream.append((w % 2, prev, version, txns))
    return stream


def old_snapshot_reads(stream) -> list:
    """(wave, index) of the stream's reads of STRADDLE_Z."""
    return [(w, i) for w, (_, _, _, txns) in enumerate(stream)
            for i, t in enumerate(txns) if t.read_conflict_ranges and
            t.read_conflict_ranges[0].begin in STRADDLE_Z]


def reply_fields(reply) -> tuple:
    """A merged reply as plain data: verdicts, the committed foreign state
    txns (version, origin, seq, verdict), the reporters' ranges."""
    return ([int(c) for c in reply.committed],
            [(e[0], e[1], e[2], int(e[4])) for e in
             reply.state_transactions],
            {i: list(r) for i, r in reply.conflicting_ranges.items()})


def drive_small_plane(plane, stream, proxies, move_after=None):
    """The stream through `plane`; one balancing step after wave
    `move_after`.  Returns each batch's reply_fields and the moves."""
    out, moves = [], []
    for w, (p, prev, version, txns) in enumerate(stream):
        out.append(reply_fields(plane.resolve(proxies[p], txns, prev,
                                              version)))
        if w == move_after:
            moves.append(plane.balance(version))
    return out, moves


def plane_small(smi: str, device: str = DEVICE) -> dict:
    """The small exact case: the parity stream and the straddling stream
    at N = 1, 2 and 4 through a plane whose roles' sets are on `device`
    and through one over the port's oracle; replies equal batch for batch
    (verdicts, foreign state txns, reporters' ranges), the moves equal, a
    move at N > 1, the reads of STRADDLE_Z across it conflicting, no
    degrade.  Every abort is attributed exactly, as the oracle's are
    (CONFLICT_ATTRIBUTION_SAMPLE raised); a txn reads one range, so the
    supervised set's culprit is the oracle's (role_small_stream)."""
    from foundationdb_tpu_torch.server import ResolutionPlane
    cases = {"parity": (parity_stream(), None, ("p0",), None),
             "straddle": (straddle_stream(), STRADDLE_MOVE_AFTER, PROXIES,
                          STRADDLE_LIFE)}
    summary = {}
    for name, (stream, move_after, proxies, life) in cases.items():
        knobs = {"CONFLICT_ATTRIBUTION_SAMPLE": 10 * STRADDLE_TXNS}
        if life:
            knobs["MAX_WRITE_TRANSACTION_LIFE_VERSIONS"] = life
        for n in PLANE_NS:
            with port_knobs(**knobs):
                card = ResolutionPlane(n, list(proxies), device=device,
                                       capacity=PLANE_SMALL_CAPACITY)
                oracle = ResolutionPlane(n, list(proxies), backend="cpu")
                got, got_moves = drive_small_plane(card, stream, proxies,
                                                   move_after)
                want, want_moves = drive_small_plane(oracle, stream, proxies,
                                                     move_after)
            check_plane_roles(card, len(stream), device=device)
            for i, (a, b) in enumerate(zip(got, want)):
                if a != b:
                    raise AssertionError(f"small {name} N = {n}: the plane "
                                         f"on {device} differs from the "
                                         f"oracle plane on batch {i}")
            if got_moves != want_moves or (move_after is not None and
                                           (n > 1) != (got_moves[0]
                                                       is not None)):
                raise AssertionError(f"small {name} N = {n}: moves "
                                     f"{got_moves}, oracle {want_moves}")
            flat = [c for b in got for c in b[0]]
            old_reads = [got[w][0][i] for w, i in old_snapshot_reads(stream)]
            if any(c != 0 for c in old_reads):
                raise AssertionError(f"small {name} N = {n}: an old "
                                     f"snapshot read across the move did "
                                     f"not conflict: {old_reads}")
            summary[f"{name}_{n}"] = {
                "verdicts": {c: flat.count(c) for c in (0, 1, 2)},
                "state_received": sum(len(b[1]) for b in got),
                "reported": sum(len(b[2]) for b in got),
                "old_snapshot_reads": len(old_reads),
                "moved": [(m[0].begin.decode("latin-1"), m[1])
                          for m in got_moves if m]}
    print(f"plane_small: the parity and straddling streams at N = "
          f"{PLANE_NS} through the plane on {device} equal the oracle plane "
          f"({summary}) -- {smi}", flush=True)
    return summary


def plane_path(smi: str) -> tuple:
    """Phase 20: streams A and B and the small exact case, the launches
    counted over the three (the oracle planes launch nothing)."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    rng = np.random.default_rng(2020)
    stream_a = plane_stream(rng, sum(N_PLANE_A), cells=PLANE_CELLS)
    stream_b = plane_stream(rng, sum(N_PLANE_B))
    K.reset_counts()
    with port_knobs(MAX_WRITE_TRANSACTION_LIFE_VERSIONS=WINDOW):
        aligned = plane_aligned(smi, stream_a)
        del stream_a
        straddling = plane_straddling(smi, stream_b)
        del stream_b
    small = plane_small(smi)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    path = {"aligned": aligned, "straddling": straddling, "small": small,
            "txns_per_batch": TXNS, "capacity": CAPACITY,
            "delta_capacity": DELTA_CAPACITY, "card": smi}
    print(f"path_plane: {json.dumps(path)}", flush=True)
    return launches, path


# ---------------------------------------------------- the scheduling plane
# Phase 21: the scheduling plane around the resolution plane -- the GRV
# proxies' predictor admission (server/grv_proxy.py), the commit proxy's
# reorder, repair collection and replies (server/commit_proxy.py commit())
# and the ratekeeper's heat poll (server/ratekeeper.py) -- in the regime of
# bench.py sched (:735-760, :972-1012): SCHED_TXNS txns a batch, 2 point
# reads + 1 point write each, zipf(1.2) over the 1M ids, snapshots 0-2
# batches behind, seed 4242 (bench.py's draws; numpy's generators may
# draw another stream under another numpy, so path_sched prints the
# stream's md5 and numpy's version), 2 warmup + 7 counted batches (cut
# from bench.py's 3 + 10 to make room for phase 23: 9 batches still
# cross a merge, every 8), 1,000 versions a batch, the floor 5 batches
# back.
# Every txn declares its tag (the key-prefix bucket of its first read,
# bench.py _sched_tag), reports its conflicting keys and opts into repair.
SCHED_TXNS, SCHED_BATCHES, SCHED_WARMUP, SCHED_SEED = 8192, 9, 2, 4242
SCHED_TAG_BUCKETS = 64
_SCHED_ALL = {"SCHED_PREDICTOR_ENABLED": True, "SCHED_REORDER_ENABLED": True,
              "SCHED_REPAIR_ENABLED": True}
_SCHED_LADDER = {"SCHED_REPAIR_ENABLED": True, "TXN_REPAIR_MAX_ATTEMPTS": 3}
# bench.py sched's seven configurations, by the knobs each sets.
SCHED_CONFIGS = {
    "off": {},
    "predictor": {"SCHED_PREDICTOR_ENABLED": True},
    "reorder": {"SCHED_REORDER_ENABLED": True},
    "repair": {"SCHED_REPAIR_ENABLED": True},
    "all": _SCHED_ALL,
    "ladder": _SCHED_LADDER,
    "all+ladder": {**_SCHED_ALL, **_SCHED_LADDER}}
# The readings: (label, configuration, N, proxies, attribution sample);
# a sample of None keeps the knob's default.
SCHED_READINGS = [(name, name, 1, ("p0",), None) for name in SCHED_CONFIGS]
SCHED_READINGS += [("all+ladder N=4", "all+ladder", 4, PROXIES, None),
                   ("all+ladder exact", "all+ladder", 1, ("p0",),
                    SCHED_TXNS)]
# The small exact case: all+ladder at N = 2 (two proxies, the ids cut in
# half) on a few hundred txns a batch over a small keyspace.
SCHED_SMALL_TXNS, SCHED_SMALL_BATCHES, SCHED_SMALL_WARMUP = 256, 12, 2
SCHED_SMALL_KEYS = 4096


def sched_tag(key: bytes, keyspace: int) -> str:
    """bench.py _sched_tag: the key-prefix bucket of a txn's first read,
    the identity the GRV predictor dooms."""
    return "b%02d" % (int(key[1:15]) * SCHED_TAG_BUCKETS // keyspace)


def sched_stream(seed: int = SCHED_SEED, batches: int = SCHED_BATCHES,
                 txns: int = SCHED_TXNS, keyspace: int = KEYSPACE,
                 reads: int = READS) -> list:
    """[(prev, version, txns)]: point_draws' batches (for reads = 2,
    bench.py gen_batch's draws), each txn with `reads` point reads and one
    point write, its tag, reporting its conflicting keys."""
    from foundationdb_tpu_torch.txn.types import (CommitTransactionRef,
                                                  KeyRange)
    rng = np.random.default_rng(seed)
    out, version = [], 1_000
    for _ in range(batches):
        prev, version = version, version + VERSIONS_PER_BATCH
        kids, snaps = point_draws(rng, prev, keyspace, True, txns,
                                  reads=reads)
        keys = [b"k%014d" % int(k) for k in kids]
        nr = txns * reads
        batch = []
        for t in range(txns):
            rk, wk = keys[t * reads:(t + 1) * reads], keys[nr + t]
            batch.append(CommitTransactionRef(
                read_conflict_ranges=[KeyRange(k, k + b"\x00") for k in rk],
                write_conflict_ranges=[KeyRange(wk, wk + b"\x00")],
                read_snapshot=int(snaps[t]), report_conflicting_keys=True,
                tag=sched_tag(rk[0], keyspace)))
        out.append((prev, version, batch))
    return out


def stream_digest(stream) -> str:
    """md5 of a stream's keys, snapshots and versions: numpy's generators
    may draw other values under another numpy, and this names the
    stream a reading ran on."""
    import hashlib
    h = hashlib.md5()
    for prev, version, txns in stream:
        h.update(b"%d %d" % (prev, version))
        for t in txns:
            for r in t.read_conflict_ranges + t.write_conflict_ranges:
                h.update(r.begin)
            h.update(b"%d" % t.read_snapshot)
    return h.hexdigest()


def drive_sched(plane, stream, proxies, warmup: int, spans=None) -> dict:
    """The stream through the plane's scheduling stages as bench.py's
    SchedBenchPipeline drives its model: round i is proxy
    proxies[i % len(proxies)]'s; it admits that GRV proxy's deferred
    requests and the batch's fresh ones (read version: the batch's prev),
    commits the admitted on the chain at the batch's version, commits
    each repair batch at version + rung * step (step = 1,000 /
    (TXN_REPAIR_MAX_ATTEMPTS + 1): below the next batch's version), then
    feeds the predictors.  After the stream, rounds with no fresh requests
    until no GRV proxy holds one.  With `spans` (instrument_sched), each
    round's seconds.  Returns the original requests, whether each is
    counted (its batch past `warmup`), the repair batches' sizes and the
    commits made."""
    from foundationdb_tpu_torch.core.knobs import server_knobs
    from foundationdb_tpu_torch.server import CommitTransactionRequest, Reply
    from foundationdb_tpu_torch.server.grv_proxy import SCHED_MAX_DEFERRALS
    max_attempts = int(server_knobs().TXN_REPAIR_MAX_ATTEMPTS)
    step = VERSIONS_PER_BATCH // (max_attempts + 1)
    drain = 2 * len(proxies) * SCHED_MAX_DEFERRALS
    originals, counted, repair_sizes, commits = [], [], [], 0
    chain, version, i = 0, stream[0][1], 0    # the roles recover at 0
    while True:
        if i < len(stream):
            prev, version, txns = stream[i]
        elif any(g.scheduler_status()["deferred_held"]
                 for g in plane.grv_proxies.values()):
            if i >= len(stream) + drain:
                raise AssertionError("deferred requests never admitted")
            prev, version, txns = version, version + VERSIONS_PER_BATCH, []
        else:
            break
        pid = proxies[i % len(proxies)]
        count = warmup <= i < len(stream)
        if spans is not None:
            spans["round"] = i
            if count:
                spans["counted"].add(i)
        fresh = [CommitTransactionRequest(t, repair_eligible=True,
                                          reply=Reply()) for t in txns]
        originals += fresh
        counted += [count] * len(fresh)
        t0 = time.perf_counter()
        batch = plane.admit(pid, fresh, prev)
        t1 = time.perf_counter()
        rung = 0
        while batch:
            if rung > max_attempts:
                raise AssertionError(f"a repair batch past the attempt "
                                     f"budget at version {version}")
            v = version + rung * step
            if rung:
                repair_sizes.append(len(batch))
            t_c = time.perf_counter()
            batch = plane.commit(pid, batch, chain, v)
            if spans is not None:
                spans["repair_commit" if rung else "main_commit"].append(
                    (i, time.perf_counter() - t_c))
            chain, rung, commits = v, rung + 1, commits + 1
        t2 = time.perf_counter()
        plane.feed()
        if spans is not None:
            t3 = time.perf_counter()
            spans["admission"].append((i, t1 - t0))
            spans["poll"].append((i, t3 - t2))
            spans["whole"].append((i, t3 - t0))
        i += 1
    return {"originals": originals, "counted": counted,
            "repair_sizes": repair_sizes, "commits": commits, "rounds": i}


def instrument_sched(plane) -> dict:
    """Timers on a plane's scheduling stages: each commit proxy's reorder,
    resolution (with the merged codes of each call) and repair
    collection, each role's resolve_batch and its supervised set's exact
    attribution: (round, seconds) a call.  drive_sched adds each round's
    admission, poll and whole seconds and the rounds it counts."""
    spans = {"round": 0, "counted": set(), "admission": [], "poll": [],
             "whole": [], "reorder": [], "resolution": [], "roles": [],
             "collect": [], "attribution": [], "main_commit": [],
             "repair_commit": [], "codes": []}

    def timed(name, fn, keep=None):
        def call(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            spans[name].append((spans["round"], time.perf_counter() - t0))
            if keep is not None:
                keep(out)
            return out
        return call

    for proxy in plane.proxies.values():
        proxy._reorder = timed("reorder", proxy._reorder)
        proxy._collect_repairs = timed("collect", proxy._collect_repairs)
        proxy.resolve = timed(
            "resolution", proxy.resolve,
            lambda reply: spans["codes"].append(codes_of(reply.committed)))
    for role in plane.resolvers:
        role.resolve_batch = timed("roles", role.resolve_batch)
        cs = role.conflict_set
        if hasattr(cs, "_attribute_device_batch"):
            cs._attribute_device_batch = timed("attribution",
                                               cs._attribute_device_batch)
    return spans


def sched_ms(spans) -> dict:
    """ms a counted round for each span; "rest" is the round's time
    outside the named stages (the replies, the commits' bookkeeping);
    main_commit_each and repair_commit_each, ms a commit() call."""
    counted = spans["counted"]
    n = max(len(counted), 1)
    ms = {k: sum(s for r, s in spans[k] if r in counted) * 1e3 / n
          for k in ("admission", "reorder", "resolution", "roles",
                    "collect", "poll", "attribution", "whole")}
    ms["rest"] = ms["whole"] - sum(ms[k] for k in (
        "admission", "reorder", "resolution", "collect", "poll"))
    # A repair batch's whole commit, and a main batch's, ms a call.
    for k in ("main_commit", "repair_commit"):
        calls = [s for r, s in spans[k] if r in counted]
        ms[k + "_each"] = sum(calls) * 1e3 / max(len(calls), 1)
    return ms


def reply_of(req) -> tuple:
    """A commit request's answer as plain data."""
    r = req.reply
    if r.error is None:
        return ("ok", r.value.version, r.value.txn_batch_id,
                r.value.txn_batch_index)
    return ("err", r.error.name, [tuple(x) for x in
                                  getattr(r.error, "details", None) or ()])


def sched_outcome(plane, run) -> dict:
    """A drive's outcome, checked: every original request answered
    exactly once (a Reply refuses a second answer), none deferred more
    than SCHED_MAX_DEFERRALS times; the commit rate over the counted
    requests (each counted once, whatever was deferred or repaired) and
    the stage counters (bench.py sched's names), the GRV and commit
    proxies' status."""
    from foundationdb_tpu_torch.server.grv_proxy import SCHED_MAX_DEFERRALS
    reqs, counted = run["originals"], run["counted"]
    unanswered = sum(1 for r in reqs if not r.reply.sent)
    defers = max((getattr(r, "_sched_defers", 0) for r in reqs), default=0)
    if unanswered or defers > SCHED_MAX_DEFERRALS:
        raise AssertionError(f"{unanswered} requests unanswered, one "
                             f"deferred {defers} times")
    total = sum(counted)
    committed = sum(1 for r, c in zip(reqs, counted)
                    if c and r.reply.error is None)
    proxy = [p.scheduler_status() for p in plane.proxies.values()]
    stage = {k: sum(d[k] for d in proxy) for k in proxy[0]}
    grv = [g.scheduler_status() for g in plane.grv_proxies.values()]
    sizes = run["repair_sizes"]
    return {"commit_rate": committed / max(total, 1),
            "committed": committed, "total": total,
            "deferrals": sum(g["deferrals"] for g in grv),
            "repairs": stage["repairs_attempted"],
            "repairs_ok": stage["repairs_succeeded"],
            "repairs_exhausted": stage["repairs_exhausted"],
            "backed_off": stage["repairs_backed_off"],
            "reorder_moved": stage["reorder_swaps"],
            "reorder_batches": stage["reorder_batches"],
            "max_defers": defers, "commits": run["commits"],
            "repair_batches": len(sizes), "repair_txns": sum(sizes),
            "repair_batch_max": max(sizes, default=0),
            "proxy_status": proxy, "grv_status": grv}


def sched_small(smi: str, device: str = DEVICE) -> dict:
    """The small exact case: drive_sched with every stage on (all+ladder)
    at N = 2, two proxies, the ids cut in half, SCHED_SMALL_TXNS txns a
    batch over SCHED_SMALL_KEYS ids, every abort attributed exactly
    (CONFLICT_ATTRIBUTION_SAMPLE raised).  (a) Two reads a txn: the plane
    over supervised sets on `device` against one on the CPU; (b) one read
    a txn: the plane on `device` against one over the port's oracle (a
    txn's culprit is then the same read on both).  Replies, the stage
    counters and the GRV and commit proxies' status equal; no degrade;
    reorder, repair and the predictor each acted."""
    from foundationdb_tpu_torch.server import ResolutionPlane
    cut = [b"k%014d" % (SCHED_SMALL_KEYS // 2)]
    knobs = {**SCHED_CONFIGS["all+ladder"],
             "CONFLICT_ATTRIBUTION_SAMPLE": 10 * SCHED_SMALL_TXNS,
             "MAX_WRITE_TRANSACTION_LIFE_VERSIONS": WINDOW}
    summary = {}
    for name, reads, other in (("two_reads", 2, {"device": "cpu"}),
                               ("one_read", 1, {"backend": "cpu"})):
        stream = sched_stream(SCHED_SEED + reads, SCHED_SMALL_BATCHES,
                              SCHED_SMALL_TXNS, SCHED_SMALL_KEYS, reads)
        got = []
        with port_knobs(**knobs):
            for kw in ({"device": device}, other):
                plane = ResolutionPlane(2, list(PROXIES), boundaries=cut,
                                        capacity=PLANE_SMALL_CAPACITY, **kw)
                run = drive_sched(plane, stream, PROXIES, SCHED_SMALL_WARMUP)
                out = sched_outcome(plane, run)
                got.append(([reply_of(r) for r in run["originals"]], out))
                if kw.get("device") == device:
                    check_plane_roles(plane, run["commits"], device=device)
        (a_replies, a), (b_replies, b) = got
        if a_replies != b_replies or a != b:
            diff = [k for k in a if a[k] != b[k]]
            raise AssertionError(f"sched small {name}: the plane on {device} "
                                 f"differs from {other} (fields {diff}, "
                                 f"replies equal: {a_replies == b_replies})")
        if min(a["reorder_moved"], a["repairs_ok"], a["deferrals"]) <= 0:
            raise AssertionError(f"sched small {name}: a stage never acted: "
                                 f"{a}")
        summary[name] = {k: v for k, v in a.items()
                         if k not in ("proxy_status", "grv_status")}
    print(f"sched_small: all+ladder at N = 2 on {device} equals the CPU "
          f"plane (two reads a txn) and the oracle plane (one read) "
          f"({summary}) -- {smi}", flush=True)
    return summary


def sched_reading(stream, config: str, n: int, proxies, sample) -> tuple:
    """One reading of phase 21: a plane of N roles over supervised sets on
    the card (CAPACITY, DELTA_CAPACITY, boundaries as phase 20's),
    `config`'s knobs (and CONFLICT_ATTRIBUTION_SAMPLE = `sample` unless
    None), the stream through drive_sched.  No degrade, every commit on
    the card.  Returns the outcome with the roles' calls, the exact and
    conservative attributions and ms a counted round (sched_ms), and the
    codes of every resolution."""
    import torch
    from foundationdb_tpu_torch.server import ResolutionPlane
    knobs = dict(SCHED_CONFIGS[config])
    if sample is not None:
        knobs["CONFLICT_ATTRIBUTION_SAMPLE"] = sample
    with port_knobs(**knobs):
        plane = ResolutionPlane(n, list(proxies),
                                boundaries=plane_boundaries(n),
                                device=DEVICE, capacity=CAPACITY,
                                delta_capacity=DELTA_CAPACITY)
        spans = instrument_sched(plane)
        run = drive_sched(plane, stream, proxies, SCHED_WARMUP, spans)
        torch.cuda.synchronize()
        out = sched_outcome(plane, run)
    check_plane_roles(plane, run["commits"], device=DEVICE)
    stats = [r.conflict_set.stats for r in plane.resolvers]
    out.update(
        exact_attributions=sum(s["exact_attribution"] for s in stats),
        conservative_attributions=sum(s["conservative_attribution"]
                                      for s in stats),
        role_calls=sum(r.resolved_batches for r in plane.resolvers),
        ms=sched_ms(spans), n=n, proxies=len(proxies),
        attribution_sample=sample)
    codes = spans["codes"]
    del plane, spans
    torch.cuda.empty_cache()
    return out, codes


def sched_path(smi: str) -> tuple:
    """Phase 21: the small exact case (the card against the CPU and the
    oracle), then SCHED_READINGS on phase 21's stream, and the plain plane
    (ResolutionPlane.resolve) on it: the off configuration's codes equal
    the plain plane's batch for batch; reorder moves and repairs non-zero
    where their knobs are on.  The launches returned are the readings'
    own: counted from 0 just before the first reading and read just after
    the last, so neither the small case (its launches are printed apart,
    in path_sched's small_launches) nor the plain plane's pass counts."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.server import ResolutionPlane
    K.reset_counts()
    small = sched_small(smi)
    torch.cuda.synchronize()
    small_launches = {k: v for k, v in K.LAUNCHES.items() if v}
    stream = sched_stream()
    readings = {}
    with port_knobs(MAX_WRITE_TRANSACTION_LIFE_VERSIONS=WINDOW):
        K.reset_counts()
        for label, config, n, proxies, sample in SCHED_READINGS:
            out, codes = sched_reading(stream, config, n, proxies, sample)
            readings[label] = out
            knobs = SCHED_CONFIGS[config]
            if label == "off":
                off_codes = codes
            ms = {k: round(v, 3) for k, v in out["ms"].items()}
            if (knobs.get("SCHED_REORDER_ENABLED") and
                    out["reorder_moved"] <= 0) or (
                    knobs.get("SCHED_REPAIR_ENABLED") and out["repairs"] <= 0):
                raise AssertionError(f"{label}: a stage that is on never "
                                     f"acted: {out}")
            print(f"path_sched {label}: commit rate "
                  f"{out['commit_rate']:.4f}, deferrals {out['deferrals']}, "
                  f"reorder moved {out['reorder_moved']}, repairs "
                  f"{out['repairs']} ({out['repairs_ok']} committed, "
                  f"{out['backed_off']} backed off), {out['role_calls']} role "
                  f"calls, {out['repair_batches']} repair batches of "
                  f"{out['repair_txns']} txns (largest "
                  f"{out['repair_batch_max']}), attributions "
                  f"{out['exact_attributions']} exact / "
                  f"{out['conservative_attributions']} conservative; ms a "
                  f"round {json.dumps(ms)} -- {smi}", flush=True)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        plain = ResolutionPlane(1, ["p0"], boundaries=plane_boundaries(1),
                                device=DEVICE, capacity=CAPACITY,
                                delta_capacity=DELTA_CAPACITY)
        prev = 0
        for i, (_, v, txns) in enumerate(stream):
            want = codes_of(plain.resolve("p0", txns, prev, v).committed)
            prev = v
            if i >= len(off_codes) or not np.array_equal(off_codes[i], want):
                raise AssertionError(f"sched off: batch {i}'s codes differ "
                                     f"from the plain plane's")
        del plain
    path = {"readings": readings, "small": small,
            "small_launches": small_launches,
            "stream_md5": stream_digest(stream), "numpy": np.__version__,
            "txns_per_batch": SCHED_TXNS, "batches": SCHED_BATCHES,
            "warmup": SCHED_WARMUP, "capacity": CAPACITY,
            "delta_capacity": DELTA_CAPACITY, "card": smi}
    print(f"path_sched: {json.dumps(path)}", flush=True)
    return launches, path



# --------------------------------------------------------- the write path
# Phase 22: the write path behind the resolvers (server/cluster.py
# StaticCluster): the master's versions, the commit proxies' tag routing
# with versionstamps, two TLogs over disk queues in a temporary directory
# and four MVCC storage servers, in FoundationDB's documented `double`
# redundancy mode (apple.github.io/foundationdb/configuration.html,
# "Choosing a redundancy mode": two replicas of the log and of the data):
# 2 TLogs with replication 2, 4 storage servers in teams of 2 cut at the
# quartiles of the ids, 2 Resolver roles on the card (supervised sets,
# capacity 2^21, delta 2^20) cut by plane_boundaries(2), 2 commit proxies
# taking batches in turn and 1 GRV proxy.  The 1M keys of config 2 are
# loaded at the recovery version with 100-byte values (YCSB's default
# fieldlength), on both replicas.  Traffic: config 2's draws (gen_batch),
# COMMIT_TXNS txns a batch (the reference batcher's cap, so one commit()
# a batch), 2 point reads and one 100-byte SetValue each, read at the
# GRV's version just before the batch (a quarter at the one before); 1%
# also add 1 to a counter (AddValue), 1% write a SetVersionstampedKey
# index entry, every COMMIT_CLEAR_EVERY-th batch
# carries COMMIT_CLEARS ClearRanges of 10 keys (those take the general
# step, the rest the compact step), and one txn splits a storage shard
# through a \xff/keyServers/ set, keeping its team.
COMMIT_BATCHES = (2, 6)            # warmup, timed
COMMIT_SEED = 2222
COMMIT_VALUE_BYTES = 100
COMMIT_CLEAR_EVERY, COMMIT_CLEARS, COMMIT_CLEAR_KEYS = 4, 100, 10
COMMIT_SPLIT_BATCH = 4
COMMIT_COUNTER = b"l/counter"
COMMIT_TXNS = 1 << 15              # COMMIT_TRANSACTION_BATCH_COUNT_MAX
COMMIT_PROXIES = ("p0", "p1")
COMMIT_SMALL = (4096, 2000)        # the replay's ids and txns a batch


def commit_key(i: int) -> bytes:
    return b"k%014d" % i


def commit_cluster(datadir: str, keyspace: int, device: str = DEVICE,
                   **set_kwargs):
    """The phase's StaticCluster, its data loaded."""
    from foundationdb_tpu_torch.server import StaticCluster
    cuts = [commit_key(keyspace * q // 4) for q in (1, 2, 3)]
    return StaticCluster(
        n_resolvers=2, proxy_ids=list(COMMIT_PROXIES), n_storage=4,
        n_tlogs=2, replication=2, datadir=datadir, storage_boundaries=cuts,
        resolver_boundaries=plane_boundaries(2), device=device, **set_kwargs)


def commit_values(rng, n: int) -> list:
    """n printable 100-byte values (no trailing NUL for numpy to drop)."""
    buf = rng.integers(33, 127, size=n * COMMIT_VALUE_BYTES,
                       dtype=np.uint8).tobytes()
    return [buf[i * COMMIT_VALUE_BYTES:(i + 1) * COMMIT_VALUE_BYTES]
            for i in range(n)]


class DurableReply:
    """A reply that records, when it is answered, whether every TLog's
    durable version and the master's live committed version had reached
    the commit version it carries."""

    cluster = None
    early = 0

    def __init__(self) -> None:
        from foundationdb_tpu_torch.server import Reply
        self._r = Reply()

    def send(self, value=None) -> None:
        c = DurableReply.cluster
        if min(t.durable_version for t in c.tlogs) < value.version or \
                c.master.live_committed_version < value.version:
            DurableReply.early += 1
        self._r.send(value)

    def send_error(self, error) -> None:
        self._r.send_error(error)

    @property
    def sent(self):
        return self._r.sent

    @property
    def value(self):
        return self._r.value

    @property
    def error(self):
        return self._r.error


def commit_batch(rng, b: int, keyspace: int, txns: int, rv: int,
                 rv_prev: int, split=None) -> list:
    """Batch b's CommitTransactionRequests (see the section's comment);
    `split`: (key, team) of the shard split this batch carries."""
    from foundationdb_tpu_torch.server import (CommitTransactionRequest,
                                               key_servers_key,
                                               key_servers_value)
    from foundationdb_tpu_torch.txn.types import (CommitTransactionRef,
                                                  KeyRange, Mutation,
                                                  MutationType)
    kids, _snaps = point_draws(rng, rv, keyspace, True, txns)
    lag = rng.random(txns) < 0.25
    add = set(rng.choice(txns, txns // 100, replace=False).tolist())
    stamp = set(rng.choice(txns, txns // 100, replace=False).tolist())
    clears = {}
    if b % COMMIT_CLEAR_EVERY == 0:
        for t, i in zip(rng.choice(txns, COMMIT_CLEARS, replace=False),
                        rng.integers(0, keyspace - COMMIT_CLEAR_KEYS,
                                     COMMIT_CLEARS)):
            clears[int(t)] = int(i)
    keys = [commit_key(int(k)) for k in kids]
    nr = txns * READS
    pad = b"." * (COMMIT_VALUE_BYTES - 16)
    one = (1).to_bytes(8, "little")
    out = []
    for t in range(txns):
        w = keys[nr + t]
        writes = [KeyRange(w, w + b"\x00")]
        muts = [Mutation(MutationType.SetValue, w,
                         b"b%05dt%09d" % (b, t) + pad)]
        if t in add:
            muts.append(Mutation(MutationType.AddValue, COMMIT_COUNTER, one))
            writes.append(KeyRange(COMMIT_COUNTER, COMMIT_COUNTER + b"\x00"))
        if t in stamp:
            muts.append(Mutation(
                MutationType.SetVersionstampedKey,
                b"vs/" + bytes(10) + b"/%d/%d" % (b, t) +
                (3).to_bytes(4, "little"), b"%d/%d" % (b, t)))
        if t in clears:
            lo, hi = commit_key(clears[t]), commit_key(
                clears[t] + COMMIT_CLEAR_KEYS)
            muts.append(Mutation(MutationType.ClearRange, lo, hi))
            writes.append(KeyRange(lo, hi))
        reads = keys[t * READS:(t + 1) * READS]
        if split is not None and t == 0:
            # A blind write (it reads nothing), so it commits.
            sk = key_servers_key(split[0])
            muts.append(Mutation(MutationType.SetValue, sk,
                                 key_servers_value(split[1])))
            writes.append(KeyRange(sk, sk + b"\x00"))
            reads = []
        out.append(CommitTransactionRequest(
            CommitTransactionRef(
                read_conflict_ranges=[KeyRange(k, k + b"\x00")
                                      for k in reads],
                write_conflict_ranges=writes, mutations=muts,
                read_snapshot=rv_prev if lag[t] else rv),
            reply=DurableReply()))
    return out


def apply_to_model(model: dict, reqs) -> tuple:
    """Fold a batch's committed requests into `model` in commit order
    (batch index); returns (committed, conflicts, too_old, adds,
    stamps): stamps maps each versionstamped key written to its
    CommitID."""
    from foundationdb_tpu_torch.txn.types import MutationType
    committed = conflicts = too_old = adds = 0
    stamps = {}
    for req in reqs:
        r = req.reply
        if not r.sent:
            raise AssertionError("a request got no reply")
        if r.error is not None:
            if r.error.name == "transaction_too_old":
                too_old += 1
            elif r.error.name == "not_committed":
                conflicts += 1
            else:
                raise AssertionError(f"reply error {r.error!r}")
            continue
        committed += 1
        cid = r.value
        for m in req.transaction.mutations:
            if m.type == MutationType.SetValue:
                model[m.param1] = m.param2
            elif m.type == MutationType.AddValue:
                adds += 1
                cur = model.get(m.param1)
                n = int.from_bytes(cur, "little") if cur else 0
                model[m.param1] = (n + 1).to_bytes(8, "little")
            elif m.type == MutationType.ClearRange:
                lo, hi = int(m.param1[1:]), int(m.param2[1:])
                for i in range(lo, hi):
                    model[commit_key(i)] = None
            elif m.type == MutationType.SetVersionstampedKey:
                stamp = cid.version.to_bytes(8, "big") + \
                    cid.txn_batch_index.to_bytes(2, "big")
                k = m.param1[:3] + stamp + m.param1[13:-4]
                model[k] = m.param2
                stamps[k] = (cid.version, cid.txn_batch_index)
            else:
                raise AssertionError(f"unexpected mutation {m.type!r}")
    return committed, conflicts, too_old, adds, stamps


def reply_codes(reqs) -> np.ndarray:
    """Each request's answer as a verdict code (codes_of's): 2 a
    CommitID, 1 transaction_too_old, 0 not_committed."""
    return np.array([2 if r.reply.error is None else
                     1 if r.reply.error.name == "transaction_too_old" else 0
                     for r in reqs], np.int8)


def commit_replay(records, **set_kwargs) -> dict:
    """Every batch of the main run, (proxy, previous version, version,
    transactions, the codes of the replies the cluster sent), through a
    ResolutionPlane on the CPU (the kernels' plain versions) built as the
    cluster's plane, proxy for proxy at the batch's own versions: its
    verdicts equal the replies."""
    from foundationdb_tpu_torch.server import ResolutionPlane
    plane = ResolutionPlane(2, list(COMMIT_PROXIES),
                            boundaries=plane_boundaries(2), device="cpu",
                            **set_kwargs)
    t0 = time.perf_counter()
    for b, (pid, prev, v, txns, got) in enumerate(records):
        want = codes_of(plane.resolve(pid, txns, prev, v).committed)
        if not np.array_equal(got, want):
            raise AssertionError(
                f"batch {b}: {int((got != want).sum())} of {len(got)} "
                "replies differ from the CPU plane's verdicts")
    return {"batches": len(records),
            "txns": sum(len(r[3]) for r in records),
            "s": time.perf_counter() - t0}


def loaded_key(k: bytes) -> bool:
    """One of the keys load() put in (commit_key(i) for an id)."""
    return len(k) == 15 and k[:1] == b"k"


def read_back(c, model: dict, base, keys, version: int, label: str) -> int:
    """Every key of `model` read with get() on both replicas, and every
    shard read whole with get_range() on both replicas, against the model
    over the loaded data (`keys`, sorted, and their values `base`);
    returns the rows read."""
    from bisect import bisect_left
    for k, want in model.items():
        got = c.get(k, version)
        if got != [want, want]:
            raise AssertionError(f"{label}: get({k!r}) at {version} = "
                                 f"{got}, the model has {want!r}")
    n_rows = 0
    proxy = c.plane.proxies[COMMIT_PROXIES[0]]
    for b, e, tags in proxy.key_servers.ranges():
        replicas = c.get_range(b, e, version)
        if len(replicas) != len(tags):
            raise AssertionError(f"{label}: {len(replicas)} replicas of "
                                 f"[{b!r}, {e!r})")
        for rows in replicas:
            for k, v in rows:
                want = model[k] if k in model else \
                    base[int(k[1:])] if loaded_key(k) else None
                if v != want:
                    raise AssertionError(f"{label}: row {k!r} = {v!r}, the "
                                         f"model has {want!r}")
            n_rows += len(rows)
        want_n = bisect_left(keys, e) - bisect_left(keys, b)
        for k, v in model.items():
            if b <= k < e and (v is None) == loaded_key(k):
                want_n += -1 if v is None else 1
        if any(len(rows) != want_n for rows in replicas):
            raise AssertionError(f"{label}: [{b!r}, {e!r}) holds "
                                 f"{[len(r) for r in replicas]} rows, the "
                                 f"model {want_n}")
    return n_rows


def check_queue_files(c, acked: list) -> dict:
    """Each TLog's queue file, recovered by a fresh DiskQueue, holds a
    contiguous run of the acknowledged versions up to the last, chained
    by their prev versions, and every record the TLog still keeps."""
    import shutil
    from foundationdb_tpu_torch.server.disk_queue import DiskQueue
    from foundationdb_tpu_torch.server.real_fs import RealFile
    from foundationdb_tpu_torch.server.tlog import _unpack_commit
    out = {}
    for t in c.tlogs:
        f = t.disk_queue.file
        copy = f._path + ".copy"
        shutil.copyfile(f._path, copy)
        q = DiskQueue(RealFile(copy, f.name + ".copy"))
        records = q.recover()
        q.file.close()
        vs, prevs = [], []
        for _seq, blob in records:
            v, prev, _k, _p, _m = _unpack_commit(blob)
            vs.append(v)
            prevs.append(prev)
        if not vs or vs[-1] != acked[-1] or vs != acked[len(acked) -
                                                        len(vs):]:
            raise AssertionError(f"{t.id}: the queue holds {vs}, the "
                                 f"acknowledged versions are {acked}")
        if prevs[1:] != vs[:-1]:
            raise AssertionError(f"{t.id}: a broken chain in the queue")
        kept = [v for v, _s, _t in t._record_seqs]
        if not set(kept) <= set(vs):
            raise AssertionError(f"{t.id}: kept records missing from disk")
        out[t.id] = {"records": len(vs), "bytes": f.size()}
    return out


def commit_run(device: str = DEVICE, keyspace: int = KEYSPACE,
               txns: int = COMMIT_TXNS, batches=COMMIT_BATCHES,
               smi: str = "", **set_kwargs) -> tuple:
    """The phase's main run: load, drive, read back, check, then replay
    every batch through a CPU plane (commit_replay); returns (launches
    over the driven batches, the figures)."""
    import shutil
    import tempfile
    from foundationdb_tpu_torch import kernels as K
    rng = np.random.default_rng(COMMIT_SEED)
    datadir = tempfile.mkdtemp(prefix="chip_smoke_tlogs_")
    try:
        c = commit_cluster(datadir, keyspace, device, **set_kwargs)
        DurableReply.cluster, DurableReply.early = c, 0
        t0 = time.perf_counter()
        base = commit_values(rng, keyspace)
        keys = [commit_key(i) for i in range(keyspace)]
        c.load(keys, base)
        load_s = time.perf_counter() - t0
        split = (commit_key(keyspace // 8),
                 c.plane.proxies[COMMIT_PROXIES[0]].tags_for_key(
                     commit_key(keyspace // 8)))
        model, stamps = {}, {}
        rvs, acked, per_batch, records = [], [], [], []
        adds = 0
        snapshots = {}
        n_warm, n_timed = batches
        if device == "cuda":
            import torch
            torch.cuda.synchronize()
        K.reset_counts()
        for b in range(n_warm + n_timed):
            rv = c.read_version()
            rvs.append(rv)
            reqs = commit_batch(rng, b, keyspace, txns, rv,
                                rvs[-2] if len(rvs) > 1 else rv,
                                split if b == COMMIT_SPLIT_BATCH else None)
            pid = COMMIT_PROXIES[b % 2]
            mut0 = sum(ss.stats["mutations"] for ss in c.storage)
            bytes0 = [t.bytes_input for t in c.tlogs]
            t1 = time.perf_counter()
            [(prev, v)] = c.commit(pid, reqs)
            t2 = time.perf_counter()
            c.pull()
            t3 = time.perf_counter()
            acked.append(v)
            records.append((pid, prev, v, [r.transaction for r in reqs],
                            reply_codes(reqs)))
            got = apply_to_model(model, reqs)
            adds += got[3]
            stamps.update(got[4])
            snapshots[v] = dict(model)
            if len(snapshots) > 2:
                del snapshots[min(snapshots)]
            phases = c.plane.proxies[pid].phase_seconds
            per_batch.append({
                "batch": b, "version": v, "read_version": rv,
                "general": b % COMMIT_CLEAR_EVERY == 0,
                "committed": got[0], "conflicts": got[1],
                "too_old": got[2], "commit_s": t2 - t1, "pull_s": t3 - t2,
                "phases_s": dict(phases),
                "fsync_s": [t.last_sync_s for t in c.tlogs],
                "mb_logged": [(t.bytes_input - b0) / 1e6
                              for t, b0 in zip(c.tlogs, bytes0)],
                "mutations_applied": sum(ss.stats["mutations"]
                                         for ss in c.storage) - mut0})
            del reqs
        if device == "cuda":
            import torch
            torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        if DurableReply.early:
            raise AssertionError(f"{DurableReply.early} replies went out "
                                 "before their version was durable on "
                                 "every TLog and known to the master")
        for role in c.plane.resolvers:
            check_supervised(role.conflict_set, n_warm + n_timed,
                             "TorchConflictSet", device)
        from foundationdb_tpu_torch.server import (TXS_TAG, key_servers_key,
                                                   key_servers_value)
        if model.get(key_servers_key(split[0])) != \
                key_servers_value(split[1]) or \
                not all(t.tag_data.get(TXS_TAG) for t in c.tlogs):
            raise AssertionError("the shard split did not commit to the "
                                 "shard map's stream (TXS_TAG)")
        top = acked[-1]
        if c.read_version() != top:
            raise AssertionError("the read version is not the last commit")
        t4 = time.perf_counter()
        rows = read_back(c, model, base, keys, top, "read-back")
        readback_s = time.perf_counter() - t4
        older = acked[-2]
        read_back(c, snapshots[older], base, keys, older, "older read")
        want_count = adds.to_bytes(8, "little")
        if c.get(COMMIT_COUNTER, top) != [want_count, want_count]:
            raise AssertionError(f"counter {c.get(COMMIT_COUNTER, top)}, "
                                 f"{adds} committed adds")
        vs_rows = c.get_range(b"vs/", b"vs0", top)
        for replica in vs_rows:
            keys = [k for k, _v in replica]
            if sorted(keys) != sorted(stamps) or any(
                    (int.from_bytes(k[3:11], "big"),
                     int.from_bytes(k[11:13], "big")) != stamps[k]
                    for k in keys):
                raise AssertionError("versionstamped keys differ from "
                                     "their CommitIDs")
        queues = check_queue_files(c, acked)
        c.close()
    finally:
        shutil.rmtree(datadir, ignore_errors=True)
    timed = per_batch[n_warm:]

    def p50(xs):
        return float(np.median(xs)) * 1e3

    committed = sum(x["committed"] for x in timed)
    commit_s = sum(x["commit_s"] for x in timed)
    pull_s = sum(x["pull_s"] for x in timed)
    figures = {
        "committed_txns_per_s": committed / commit_s,
        "p50_commit_ms": p50([x["commit_s"] for x in timed]),
        "p50_phase_ms": {k: p50([x["phases_s"][k] for x in timed])
                         for k in timed[0]["phases_s"]},
        "p50_pull_ms": p50([x["pull_s"] for x in timed]),
        "p50_fsync_ms": p50([max(x["fsync_s"]) for x in timed]),
        "mb_logged_per_batch": float(np.mean(
            [sum(x["mb_logged"]) for x in timed])),
        "mutations_applied_per_s": sum(
            x["mutations_applied"] for x in timed) / pull_s,
        "readback_ms": readback_s * 1e3, "readback_rows": rows,
        "too_old": sum(x["too_old"] for x in per_batch),
        "conflicts": sum(x["conflicts"] for x in per_batch),
        "committed": sum(x["committed"] for x in per_batch),
        "counter_adds": adds, "versionstamps": len(stamps),
        "load_s": load_s, "queues": queues, "batches": per_batch,
        "txns_per_batch": txns, "keyspace": keyspace, "card": smi}
    figures["cpu_replay"] = commit_replay(records, **set_kwargs)
    return launches, figures


def commit_small(smi: str = "", device: str = DEVICE) -> dict:
    """The verdict replay: two small batches (a point batch, then a
    general one with clears), COMMIT_SMALL's txns over its ids, through
    the cluster on `device`, then the same transactions at the same
    versions through a ResolutionPlane over the port's oracle, proxy for
    proxy: the verdicts equal.  (The oracle's intra-batch check is
    quadratic in a batch's surviving writes: hours at TXNS.)"""
    import shutil
    import tempfile
    from foundationdb_tpu_torch.server import ResolutionPlane
    keyspace, txns = COMMIT_SMALL
    rng = np.random.default_rng(COMMIT_SEED + 1)
    datadir = tempfile.mkdtemp(prefix="chip_smoke_small_")
    try:
        c = commit_cluster(datadir, keyspace, device,
                           capacity=PLANE_SMALL_CAPACITY)
        DurableReply.cluster = c
        c.load([commit_key(i) for i in range(keyspace)],
               commit_values(rng, keyspace))
        runs = []
        rv_prev = 0
        for b in (1, COMMIT_CLEAR_EVERY):   # a point batch, a clear batch
            rv = c.read_version()
            reqs = commit_batch(rng, b, keyspace, txns, rv, rv_prev)
            rv_prev = rv
            pid = COMMIT_PROXIES[len(runs) % 2]
            [(prev, v)] = c.commit(pid, reqs)
            runs.append((pid, prev, v, reqs))
        c.close()
    finally:
        shutil.rmtree(datadir, ignore_errors=True)
    oracle = ResolutionPlane(2, list(COMMIT_PROXIES),
                             boundaries=plane_boundaries(2), backend="cpu")
    verdicts = {}
    for i, (pid, prev, v, reqs) in enumerate(runs):
        got = reply_codes(reqs).tolist()
        want = codes_of(oracle.resolve(pid, [r.transaction for r in reqs],
                                       prev, v).committed).tolist()
        if got != want:
            raise AssertionError(f"replay batch {i}: the cluster's verdicts "
                                 f"differ from the oracle plane's")
        verdicts[f"batch{i}"] = {k: got.count(k) for k in (0, 1, 2)}
    print(f"commit_small: the cluster on {device} and the oracle plane "
          f"replayed at its versions give the same verdicts ({verdicts}) "
          f"-- {smi}", flush=True)
    return verdicts


def commit_path(smi: str) -> tuple:
    """Phase 22: the main run (its launches are the column's) with its
    CPU-plane replay, then the small oracle replay; the path_commit
    line."""
    launches, figures = commit_run(smi=smi, capacity=CAPACITY,
                                   delta_capacity=DELTA_CAPACITY)
    figures["replay"] = commit_small(smi)
    shown = {k: v for k, v in figures.items() if k != "batches"}
    print(f"path_commit: {json.dumps(shown)}", flush=True)
    return launches, figures


# ----------------------------------------------------- the restart
# Phase 23: durability across a restart (server/cluster.py StaticCluster
# over durable storage engines, StaticCluster.recover): phase 22's
# cluster in FoundationDB's `double` redundancy with the `memory` storage
# engine, `configure new double memory`
# (apple.github.io/foundationdb/configuration.html, "Choosing a
# redundancy mode" and "Storage engine"): 2 TLogs (replication 2), 4
# storage servers in teams of 2 each over a KVStoreMemory, 2 Resolver
# roles on the card, 2 commit proxies, 1 GRV proxy; config 2's 1M keys
# with 100-byte values imaged into every engine; RESTART_BATCHES of
# phase 22's batches (COMMIT_TXNS txns, 1% adds, 1% versionstamps, clears
# every COMMIT_CLEAR_EVERY-th batch), the engines made durable every
# RESTART_DURABLE_EVERY batches and at the last; TLOG_SPILL_THRESHOLD
# lowered to RESTART_SPILL and storage server 0 held back for the last
# RESTART_HELD batches, so its backlog spills and is read back from the
# queue files.  Then the kill (every file descriptor released, nothing
# synced), StaticCluster.recover, the read-back at the recovery version
# on both replicas, a too-old read below it, RESTART_AFTER batches in the
# new epoch (one with clears: the general step) equal to a CPU plane's
# verdicts at the same versions, and a second kill and recovery that
# reads everything back again.  The B-tree engine runs the same checks at
# RESTART_BTREE's cut (50,000 keys, 2 + 2 batches of 4,096 txns): a
# Python B-tree takes 1M single-key copy-on-write inserts in minutes.
RESTART_BATCHES = (2, 4)           # before the first restart
RESTART_AFTER = 2                  # in the new epoch
RESTART_HELD = 2
RESTART_DURABLE_EVERY = 2
RESTART_SPILL = 64 << 10
RESTART_SEED = 2323
RESTART_BTREE = {"keyspace": 50_000, "txns": 4096, "batches": (2, 2)}


def restart_cluster(datadir: str, keyspace: int, engine: str,
                    device: str = DEVICE, **set_kwargs):
    """Phase 22's cluster (commit_cluster) over `engine`."""
    from foundationdb_tpu_torch.server import StaticCluster
    cuts = [commit_key(keyspace * q // 4) for q in (1, 2, 3)]
    return StaticCluster(
        n_resolvers=2, proxy_ids=list(COMMIT_PROXIES), n_storage=4,
        n_tlogs=2, replication=2, datadir=datadir, storage_boundaries=cuts,
        resolver_boundaries=plane_boundaries(2), storage_engine=engine,
        device=device, **set_kwargs)


def kill_cluster(c, device: str) -> None:
    """The kill: every descriptor released with nothing synced, every
    role dropped, the old Resolver roles' device memory freed."""
    import gc
    c.kill()
    DurableReply.cluster = None
    gc.collect()
    if device == "cuda":
        import torch
        torch.cuda.empty_cache()


def recover_and_check(datadir: str, device: str, model, base, keys,
                      acked: list, label: str, set_kwargs: dict):
    """StaticCluster.recover, then: the recovery version at least the
    last acknowledged version, every acknowledged key on both replicas
    equal to the model there (read_back), a read below it too old."""
    from foundationdb_tpu_torch.core.error import FdbError
    from foundationdb_tpu_torch.server import StaticCluster
    t0 = time.perf_counter()
    c = StaticCluster.recover(datadir, list(COMMIT_PROXIES), device=device,
                              **set_kwargs)
    recover_s = time.perf_counter() - t0
    DurableReply.cluster = c
    rv = c.recovery["recovery_version"]
    if rv < acked[-1]:
        raise AssertionError(f"{label}: recovery version {rv} below the "
                             f"last acknowledged {acked[-1]}")
    t1 = time.perf_counter()
    rows = read_back(c, model, base, keys, rv, label)
    readback_s = time.perf_counter() - t1
    try:
        c.get(keys[0], rv - 1)
    except FdbError as e:
        if e.name != "transaction_too_old":
            raise
    else:
        raise AssertionError(f"{label}: a read below the recovery version "
                             "was answered")
    out = dict(c.recovery, recover_wall_s=recover_s,
               readback_s=readback_s, keys_read_back=rows,
               mb_replayed=(c.recovery["tlog_bytes"] +
                            c.recovery["engine_bytes"]) / 1e6,
               keys_recovered_per_s=c.recovery["keys"] /
               max(c.recovery["engines_s"], 1e-9))
    return c, out


def restart_run(engine: str = "memory", device: str = DEVICE,
                keyspace: int = KEYSPACE, txns: int = COMMIT_TXNS,
                batches=RESTART_BATCHES, after: int = RESTART_AFTER,
                spill_threshold: int = RESTART_SPILL, smi: str = "",
                **set_kwargs) -> tuple:
    """The phase's run over `engine` (see the section's comment); returns
    (launches over the batches of the new epoch, the figures)."""
    import shutil
    import tempfile
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.server import ResolutionPlane, ask
    from foundationdb_tpu_torch.server.interfaces import TLogPeekRequest
    rng = np.random.default_rng(RESTART_SEED)
    t_run = time.perf_counter()
    datadir = tempfile.mkdtemp(prefix="chip_smoke_restart_")
    n_warm, n_timed = batches
    n = n_warm + n_timed
    figures = {"engine": engine, "keyspace": keyspace,
               "txns_per_batch": txns, "batches": list(batches),
               "after": after, "spill_threshold": spill_threshold,
               "card": smi}
    try:
        with port_knobs(TLOG_SPILL_THRESHOLD=spill_threshold):
            c = restart_cluster(datadir, keyspace, engine, device,
                                **set_kwargs)
            DurableReply.cluster, DurableReply.early = c, 0
            base = commit_values(rng, keyspace)
            keys = [commit_key(i) for i in range(keyspace)]
            t0 = time.perf_counter()
            c.load(keys, base)
            figures["load_and_image_s"] = time.perf_counter() - t0
            # Storage server 0: its tag carries shard 0, the head of the
            # zipf draws, so its held backlog is the heaviest resident.
            held = c.storage[0]
            model, acked, rvs = {}, [], []
            engine_s, commit_s = [], []
            for b in range(n):
                rv = c.read_version()
                rvs.append(rv)
                reqs = commit_batch(rng, b, keyspace, txns, rv,
                                    rvs[-2] if len(rvs) > 1 else rv)
                t1 = time.perf_counter()
                [(_prev, v)] = c.commit(COMMIT_PROXIES[b % 2], reqs)
                commit_s.append(time.perf_counter() - t1)
                acked.append(v)
                apply_to_model(model, reqs)
                del reqs
                for ss in c.storage:
                    if ss is not held or b < n - RESTART_HELD:
                        ss.pull()
                if b % RESTART_DURABLE_EVERY == RESTART_DURABLE_EVERY - 1 \
                        or b == n - 1:
                    t2 = time.perf_counter()
                    c.update_storage()
                    engine_s.append(time.perf_counter() - t2)
            if DurableReply.early:
                raise AssertionError(f"{DurableReply.early} replies before "
                                     "their version was durable")
            spilled = [t.spilled.get(held.tag) for t in c.tlogs]
            if not all(spilled):
                raise AssertionError("the held server's backlog did not "
                                     "spill on every TLog")
            figures["mb_spilled"] = sum(t.bytes_spilled
                                        for t in c.tlogs) / 1e6
            t3 = time.perf_counter()
            reply = ask(c.tlogs[0].peek, TLogPeekRequest(
                held.tag, held._fetch_from))
            figures["spilled_peek_ms"] = (time.perf_counter() - t3) * 1e3
            figures["spilled_peek_versions"] = len(reply.messages)
            figures["engine_commit_ms_per_batch"] = \
                float(np.sum(engine_s)) * 1e3 / n
            figures["p50_commit_ms_before"] = \
                float(np.median(commit_s[n_warm:])) * 1e3
            figures["held_lag_versions"] = acked[-1] - held.durable_version
            del reply
            kill_cluster(c, device)
            del c

            recoveries = []
            c, rec = recover_and_check(datadir, device, model, base, keys,
                                       acked, "first restart", set_kwargs)
            recoveries.append(rec)
            rv = rec["recovery_version"]
            plane = ResolutionPlane(2, list(COMMIT_PROXIES),
                                    boundaries=plane_boundaries(2),
                                    device="cpu", recovery_version=rv,
                                    **set_kwargs)
            first = COMMIT_CLEAR_EVERY * (n // COMMIT_CLEAR_EVERY + 1)
            if device == "cuda":
                import torch
                torch.cuda.synchronize()
            K.reset_counts()
            rvs, commit_s, replay = [], [], []
            for j in range(after):
                b = first + j           # the first carries clears
                rv_b = c.read_version()
                rvs.append(rv_b)
                reqs = commit_batch(rng, b, keyspace, txns, rv_b,
                                    rvs[-2] if len(rvs) > 1 else rv_b)
                pid = COMMIT_PROXIES[j % 2]
                t1 = time.perf_counter()
                [(prev, v)] = c.commit(pid, reqs)
                commit_s.append(time.perf_counter() - t1)
                acked.append(v)
                replay.append((pid, prev, v, [r.transaction for r in reqs],
                               reply_codes(reqs)))
                apply_to_model(model, reqs)
                del reqs
            if device == "cuda":
                import torch
                torch.cuda.synchronize()
            launches = dict(K.LAUNCHES)
            for role in c.plane.resolvers:
                check_supervised(role.conflict_set, after,
                                 "TorchConflictSet", device)
            t4 = time.perf_counter()
            for i, (pid, prev, v, txns_i, got) in enumerate(replay):
                want = codes_of(plane.resolve(pid, txns_i, prev,
                                              v).committed)
                if not np.array_equal(got, want):
                    raise AssertionError(
                        f"after batch {i}: {int((got != want).sum())} "
                        "replies differ from the CPU plane's verdicts")
            figures["cpu_replay_s"] = time.perf_counter() - t4
            figures["after_committed"] = int(sum(
                (r[4] == 2).sum() for r in replay))
            del plane, replay
            figures["p50_commit_ms_after"] = \
                float(np.median(commit_s)) * 1e3
            c.pull()
            c.update_storage()
            kill_cluster(c, device)
            del c
            c, rec = recover_and_check(datadir, device, model, base, keys,
                                       acked, "second restart", set_kwargs)
            recoveries.append(rec)
            c.close()
            kill_cluster(c, device)
            del c
        figures["recoveries"] = recoveries
        figures["restarts"] = len(recoveries)
        figures["run_s"] = time.perf_counter() - t_run
    finally:
        shutil.rmtree(datadir, ignore_errors=True)
    return launches, figures


def restart_path(smi: str) -> tuple:
    """Phase 23: the memory engine at full width, then the B-tree at its
    cut; the new epochs' launches (both runs), the path_restart line."""
    launches, memory = restart_run(smi=smi, capacity=CAPACITY,
                                   delta_capacity=DELTA_CAPACITY)
    launches_b, btree = restart_run(engine="btree", smi=smi,
                                    capacity=CAPACITY,
                                    delta_capacity=DELTA_CAPACITY,
                                    **RESTART_BTREE)
    for k, v in launches_b.items():
        launches[k] = launches.get(k, 0) + v
    path = {"memory": memory, "btree": btree}
    print(f"path_restart: {json.dumps(path)}", flush=True)
    return launches, path


# ------------------------------------------------------------ the client
# Phase 24: the client (client/database.py Database and Transaction over
# server/cluster.py StaticCluster on the port's EventLoop: start,
# database, run_until) -- phase 22's cluster in FoundationDB's `double`
# redundancy (2 TLogs over disk queues, 4 storage servers in teams of 2,
# 2 Resolver roles on the card at CAPACITY and DELTA_CAPACITY, 2 commit
# proxies behind their batchers, 1 GRV proxy), config 2's 1M keys with
# 100-byte values on both replicas, the master's clock the loop's.  Two
# of the reference's workloads (testing/workloads.py), every transaction
# through Database and TestWorkload.run_transaction's retry loop:
# ReadWrite's transaction shape (ReadWrite.actor.cpp: 4 uniform point
# reads over the 1M keys, then 2 writes of fresh 100-byte values) from
# CLIENT_RW[0] concurrent actors, CLIENT_RW[1] transactions each (the
# first CLIENT_RW[2] rounds are warmup), every CLIENT_RANGE_EVERY-th
# round's transaction also reading CLIENT_RANGE_KEYS consecutive keys with
# get_range (those batches take the general step); then Cycle
# (Cycle.actor.cpp: a ring of nodes, each transaction reading three links
# and swapping them) over CLIENT_CYCLE[0] nodes from CLIENT_CYCLE[1]
# actors, CLIENT_CYCLE[2] swaps each: real contention, whose retries the
# card decides.  The master's clock is the loop's virtual time, so a
# read version never ages past the MVCC window while the host works, and
# the cyclic collector is off while the actors run: the aborts, retries
# and rates are those of that regime.  over_window_wall_share counts the
# transactions a wall-clock master could have refused as too old.
# Cut in the twenty-second slice from 8 transactions each (2 warmup) and
# 4 swaps: on the network the batches are smaller and more (a batch
# closes 1 ms after its first commit, and the commits now arrive spread
# by the network's latency), and the phase took 203.7 s of a run whose
# phases took 1,092.8 s of the 1,200 s limit.
CLIENT_RW = (8192, 4, 1)              # actors, transactions each, warmup
CLIENT_RANGE_EVERY, CLIENT_RANGE_KEYS = 4, 10
CLIENT_CYCLE = (10_000, 2_048, 3)     # nodes, actors, swaps each
CLIENT_SEED = 2424
CLIENT_PREFIX = b"cycle/"


def record_batches(c) -> list:
    """Wrap every commit proxy's commit_async() (the batcher's path) so
    each batch it commits is kept as (proxy, previous version, version,
    transactions, verdict codes), in the order the batches finish."""
    records = []
    for pid, proxy in c.plane.proxies.items():
        async def commit_async(batch, _orig=proxy.commit_async, _pid=pid,
                               _proxy=proxy):
            txns = [req.transaction for req in batch]
            out = await _orig(batch)
            prev, v = _proxy.last_versions
            records.append((_pid, prev, v, txns,
                            np.array([int(x) for x in _proxy.last_verdicts],
                                     np.int8)))
            return out
        proxy.commit_async = commit_async
    return records


def time_roles(c) -> list:
    """Time every Resolver role's resolve_batch and every TLog's commit
    (before start(), which hands them to the roles' actors); the seconds
    summed in the one-element list returned."""
    spent = [0.0]
    for role, name in ([(r, "resolve_batch") for r in c.plane.resolvers] +
                       [(t, "commit") for t in c.tlogs]):
        def timed(*args, _fn=getattr(role, name), **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                spent[0] += time.perf_counter() - t0
        setattr(role, name, timed)
    return spent


def ring_of(rows, nodes: int) -> bool:
    """Whether `rows` (key, next key) of the Cycle's prefix are one ring
    through all `nodes` nodes."""
    succ = dict(rows)
    if len(succ) != nodes:
        return False
    k, seen = CLIENT_PREFIX + b"%06d" % 0, 0
    for _ in range(nodes):
        k = succ.get(k)
        seen += 1
        if k is None:
            return False
        if k == CLIENT_PREFIX + b"%06d" % 0:
            break
    return seen == nodes and k == CLIENT_PREFIX + b"%06d" % 0


def client_run(device: str = DEVICE, keyspace: int = KEYSPACE,
               rw_actors: int = CLIENT_RW[0], rw_txns: int = CLIENT_RW[1],
               rw_warmup: int = CLIENT_RW[2],
               cycle_nodes: int = CLIENT_CYCLE[0],
               cycle_actors: int = CLIENT_CYCLE[1],
               cycle_swaps: int = CLIENT_CYCLE[2], smi: str = "",
               **set_kwargs) -> dict:
    """The phase's run (see the section's comment): load, ReadWrite's
    warmup and measured rounds, Cycle, then the checks: every
    acknowledged ReadWrite write read back on both replicas at the last
    version (model order: commit version, batch index, order within the
    transaction), the ring intact on both replicas and by the workload's
    own check, the Cycle batches replayed through a plane over the
    oracle at the same versions giving the same codes, every commit
    reply counted once (the proxies' TxnCommitted equal the clients'
    commits), no supervised set degraded.  Returns the figures."""
    import gc
    import random
    import shutil
    import tempfile
    from foundationdb_tpu_torch.core.futures import wait_all
    from foundationdb_tpu_torch.core.knobs import server_knobs
    from foundationdb_tpu_torch.core.scheduler import (EventLoop,
                                                       set_event_loop)
    from foundationdb_tpu_torch.server import ResolutionPlane
    from foundationdb_tpu_torch.testing.workload import TestWorkload
    from foundationdb_tpu_torch.testing.workloads import CycleWorkload
    rng = np.random.default_rng(CLIENT_SEED)
    datadir = tempfile.mkdtemp(prefix="chip_smoke_client_")
    loop = EventLoop()
    try:
        c = commit_cluster(datadir, keyspace, device, clock=loop.now,
                           **set_kwargs)
        t0 = time.perf_counter()
        base = commit_values(rng, keyspace)
        keys = [commit_key(i) for i in range(keyspace)]
        c.load(keys, base)
        load_s = time.perf_counter() - t0
        role_s = time_roles(c)
        c.start(loop)
        db = c.database()
        records = record_batches(c)
        rw = TestWorkload(c, db, {})
        # As the reference's simulator does for a run: no cyclic
        # collection while actors run (a full one walks the 1M keys'
        # chains, several a second at this allocation rate); the actors'
        # cycles are collected after.
        gc.collect()
        gc.freeze()
        gc.disable()
        acked = []          # (version, batch index, order, key, value)
        # (round, attempts, grv_s, read_s, total_s, last_s): GRV and read
        # seconds summed over the attempts; total_s from the first
        # attempt's GRV request to the commit reply (every attempt and
        # on_error's backoff); last_s the committed attempt's alone.
        txn_stats = []
        pad = b"." * (COMMIT_VALUE_BYTES - 24)

        async def rw_actor(a: int, rounds) -> None:
            r = random.Random(CLIENT_SEED * 100_003 + a)
            for rnd in rounds:
                st = {"attempts": 0, "grv_s": 0.0, "read_s": 0.0}

                async def fn(t, rnd=rnd, st=st):
                    st["attempts"] += 1
                    st["txn"] = t
                    st["ta"] = time.perf_counter()
                    await t.get_read_version()
                    t1 = time.perf_counter()
                    st["grv_s"] += t1 - st["ta"]
                    for _ in range(4):
                        await t.get(commit_key(r.randrange(keyspace)))
                    if rnd % CLIENT_RANGE_EVERY == CLIENT_RANGE_EVERY - 1:
                        lo = r.randrange(keyspace - CLIENT_RANGE_KEYS)
                        await t.get_range(
                            commit_key(lo),
                            commit_key(lo + CLIENT_RANGE_KEYS))
                    st["read_s"] += time.perf_counter() - t1
                    st["writes"] = []
                    for j in range(2):
                        k = commit_key(r.randrange(keyspace))
                        v = b"a%06dr%02dw%d" % (a, rnd, j) + pad
                        st["writes"].append((k, v))
                        t.set(k, v)
                t0 = time.perf_counter()
                await rw.run_transaction(fn)
                t3 = time.perf_counter()
                stamp = st["txn"]._committed_stamp
                ver = int.from_bytes(stamp[:8], "big")
                idx = int.from_bytes(stamp[8:], "big")
                for j, (k, v) in enumerate(st["writes"]):
                    acked.append((ver, idx, j, k, v))
                txn_stats.append((rnd, st["attempts"], st["grv_s"],
                                  st["read_s"], t3 - t0, t3 - st["ta"]))

        def timings():
            # The commit pipeline's own host time: the proxies' batches
            # less their waits on the other roles, the resolvers' and the
            # TLogs' calls.
            return (sum(p.batch_seconds - p.wait_seconds
                        for p in c.plane.proxies.values()) + role_s[0],
                    sum(ss.read_seconds for ss in c.storage),
                    len(records))

        def drive(rounds):
            c.run_until(wait_all([loop.spawn(rw_actor(a, rounds))
                                  for a in range(rw_actors)]))

        if device == "cuda":
            import torch
            torch.cuda.synchronize()
        drive(range(rw_warmup))
        commit_s0, read_s0, batch0 = timings()
        t1 = time.perf_counter()
        drive(range(rw_warmup, rw_txns))
        if device == "cuda":
            torch.cuda.synchronize()
        rw_s = time.perf_counter() - t1
        commit_s1, read_s1, batch1 = timings()
        measured = [x for x in txn_stats if x[0] >= rw_warmup]
        rw_batches = records[batch0:batch1]
        range_txns = sum(1 for x in measured if x[0] %
                             CLIENT_RANGE_EVERY == CLIENT_RANGE_EVERY - 1)

        # Cycle: the reference's setup, rings of swaps, and check.
        cyc = CycleWorkload(c, db, {"nodeCount": cycle_nodes,
                                    "prefix": CLIENT_PREFIX.decode()})
        c.run_until(loop.spawn(cyc.setup()))
        first_cycle = len(records) - 1      # the setup's batch
        swaps = [0, 0]                      # swaps, attempts

        async def swapper(a: int) -> None:
            r = random.Random(CLIENT_SEED * 7 + a)
            for _ in range(cycle_swaps):
                async def swap(t):
                    swaps[1] += 1
                    x = CLIENT_PREFIX + b"%06d" % r.randrange(cycle_nodes)
                    b = await t.get(x)
                    cv = await t.get(b)
                    d = await t.get(cv)
                    t.set(x, cv)
                    t.set(b, d)
                    t.set(cv, b)
                await cyc.run_transaction(swap)
                swaps[0] += 1
        t2 = time.perf_counter()
        c.run_until(wait_all([loop.spawn(swapper(a))
                              for a in range(cycle_actors)]))
        if device == "cuda":
            torch.cuda.synchronize()
        cycle_s = time.perf_counter() - t2
        intact = c.run_until(loop.spawn(cyc.check()))
        # In version-chain order: the proxies' batches cross on the
        # network, so they are recorded as they finish.
        cycle_records = sorted(records[first_cycle:], key=lambda r: r[2])

        # Checks.
        if not intact:
            raise AssertionError("the Cycle ring is broken (its check)")
        committed = sum(p.metrics.counter("TxnCommitted").value
                        for p in c.plane.proxies.values())
        client_commits = len(txn_stats) + swaps[0] + 1   # + the setup
        if committed != client_commits or any(
                p.broken for p in c.plane.proxies.values()):
            raise AssertionError(f"the proxies committed {committed} "
                                 f"transactions, the clients saw "
                                 f"{client_commits}")
        for role in c.plane.resolvers:
            check_supervised(role.conflict_set, len(records),
                             "TorchConflictSet", device)
        top = c.read_version()
        c.pull()
        t4 = time.perf_counter()
        model = {}
        for _v, _i, _j, k, v in sorted(acked):
            model[k] = v
        ring_rows = c.get_range(CLIENT_PREFIX, CLIENT_PREFIX[:-1] + b"0",
                                top)
        if len(ring_rows) != 2 or not all(ring_of(rows, cycle_nodes)
                                          for rows in ring_rows):
            raise AssertionError("the Cycle ring is broken on a replica")
        model.update(dict(ring_rows[0]))
        rows = read_back(c, model, base, keys, top, "client read-back")
        readback_s = time.perf_counter() - t4
        oracle = ResolutionPlane(2, list(COMMIT_PROXIES),
                                 boundaries=plane_boundaries(2),
                                 backend="cpu",
                                 recovery_version=cycle_records[0][1])
        t5 = time.perf_counter()
        for b, (pid, prev, v, txns, got) in enumerate(cycle_records):
            want = codes_of(oracle.resolve(pid, txns, prev, v).committed)
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"Cycle batch {b}: {int((got != want).sum())} of "
                    f"{len(got)} replies differ from the oracle plane's")
        replay_s = time.perf_counter() - t5
        c.close()
    finally:
        gc.enable()
        gc.unfreeze()
        set_event_loop(None)
        shutil.rmtree(datadir, ignore_errors=True)
    gc.collect()

    def pct(xs, q):
        return float(np.percentile(xs, q)) * 1e3 if len(xs) else 0.0

    rw_commits = len(measured)
    rw_attempts = sum(x[1] for x in measured)
    sizes = [len(rec[3]) for rec in rw_batches]
    conflicted = sum(int((rec[4] == 0).sum()) for rec in rw_batches)
    cyc_sizes = [len(rec[3]) for rec in cycle_records]
    cyc_conflicts = sum(int((rec[4] == 0).sum()) for rec in cycle_records)
    commit_s = commit_s1 - commit_s0
    read_s = read_s1 - read_s0
    # The master runs on the loop's clock, so no read version ages past
    # the MVCC window however long the host takes; this is the share of
    # measured transactions whose committed attempt took longer than the
    # window in wall time, from its GRV request to its commit reply.
    window_s = (server_knobs().MAX_READ_TRANSACTION_LIFE_VERSIONS /
                server_knobs().VERSIONS_PER_SECOND)
    return {
        "rw": {"committed": len(txn_stats),
               "measured_committed": rw_commits,
               "committed_txns_per_s": rw_commits / rw_s,
               "wall_s": rw_s,
               "p50_txn_ms": pct([x[4] for x in measured], 50),
               "p99_txn_ms": pct([x[4] for x in measured], 99),
               "grv_ms_per_txn": float(np.mean([x[2] for x in measured]))
               * 1e3,
               "read_ms_per_txn": float(np.mean([x[3] for x in measured]))
               * 1e3,
               "retries_per_commit": (rw_attempts - rw_commits) /
               max(rw_commits, 1),
               "abort_rate": conflicted / max(sum(sizes), 1),
               "batches": len(sizes),
               "mean_batch": float(np.mean(sizes)) if sizes else 0.0,
               "range_read_txns": range_txns,
               "window_s": window_s,
               "over_window_wall_share": sum(
                   1 for x in measured if x[5] > window_s) /
               max(rw_commits, 1),
               "split_s": {"commit": commit_s, "storage_reads": read_s,
                           "client_python": rw_s - commit_s - read_s}},
        "cycle": {"swaps": swaps[0], "attempts": swaps[1],
                  "retries_per_commit": (swaps[1] - swaps[0]) /
                  max(swaps[0], 1),
                  "abort_rate": cyc_conflicts / max(sum(cyc_sizes), 1),
                  "committed_txns_per_s": swaps[0] / cycle_s,
                  "wall_s": cycle_s, "batches": len(cyc_sizes),
                  "mean_batch": float(np.mean(cyc_sizes)),
                  "replayed_batches": len(cycle_records),
                  "oracle_replay_s": replay_s},
        "load_s": load_s, "readback_s": readback_s, "readback_rows": rows,
        "keyspace": keyspace, "card": smi}


def client_path(smi: str) -> tuple:
    """Phase 24: client_run on the card, the launches counted over the
    whole drive (load and read-back launch nothing); the path_client
    line."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    K.reset_counts()
    figures = client_run(smi=smi, capacity=CAPACITY,
                         delta_capacity=DELTA_CAPACITY)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print(f"path_client: {json.dumps(figures)}", flush=True)
    return launches, figures


# ------------------------------------------- faults on the simulated network
# Phase 25: phase 24's cluster (FoundationDB's `double` redundancy, 2
# Resolver roles on the card at CAPACITY and DELTA_CAPACITY, the 1M keys
# with 100-byte values on both replicas), every role in a simulated
# process of its own on the port's SimNetwork (StaticCluster.start), and
# ReadWrite's transaction shape as in phase 24 (CLIENT_RW's, every
# CLIENT_RANGE_EVERY-th round with a get_range) from SIM_RW[0] actors,
# SIM_RW[1] transactions each (the first SIM_RW[2] rounds warmup).  While
# the measured rounds run, the storage process SIM_KILLED is killed once
# SIM_FAULTS_AT[0] of the measured transactions have committed, and the
# process of the Resolver role SIM_CLOGGED is clogged for SIM_CLOG_S
# virtual seconds once SIM_FAULTS_AT[1] have.  Reads of the dead replica
# fail over to the other replica of its team; every commit waits for
# the clogged resolver.  The checks: every acknowledged write read back
# from every surviving replica of its team, reads failed over, every
# commit answered once (one stamp a commit, the proxies' count equal to
# the clients'), commits sent during the clog completed after it.
SIM_RW = (2048, 8, 2)                 # actors, transactions each, warmup
SIM_SEED = 2525
SIM_KILLED = "ss1"
SIM_CLOGGED = "resolver0"
SIM_CLOG_S = 2.0
SIM_FAULTS_AT = (0.25, 0.5)           # shares of the measured commits


def live_read_back(c, model: dict, version: int, dead) -> int:
    """Every key of `model` read from each replica of its team whose
    process was not killed (`dead`: storage ids), against the model;
    returns the reads.  Every key must keep a live replica."""
    from foundationdb_tpu_torch.server.interfaces import (GetValueRequest,
                                                          ask)
    n = 0
    for k, want in model.items():
        live = [ss for ss in c.team(k) if ss.id not in dead]
        if not live:
            raise AssertionError(f"{k!r} has no live replica")
        for ss in live:
            got = ask(ss.get_value, GetValueRequest(k, version)).value
            if got != want:
                raise AssertionError(f"fault read-back: {ss.id} has {k!r} "
                                     f"= {got!r} at {version}, the model "
                                     f"{want!r}")
            n += 1
    return n


def count_broken(net) -> dict:
    """Wrap `net`'s send_request so every reply that is broken_promise is
    counted, and those of storage reads (each one a read the client
    moves to the next replica of the team) apart."""
    counts = {"broken_promise": 0, "read_failovers": 0}
    orig = net.send_request

    def send_request(ep, request, *args, **kwargs):
        f = orig(ep, request, *args, **kwargs)

        def seen(f, stream=ep.token.split(":", 1)[0]):
            if f.is_error() and getattr(f.error, "name", "") == \
                    "broken_promise":
                counts["broken_promise"] += 1
                if stream.startswith("storage.get"):
                    counts["read_failovers"] += 1
        f.on_ready(seen)
        return f
    net.send_request = send_request
    return counts


def sim_run(device: str = DEVICE, keyspace: int = KEYSPACE,
            rw_actors: int = SIM_RW[0], rw_txns: int = SIM_RW[1],
            rw_warmup: int = SIM_RW[2], clog_s: float = SIM_CLOG_S,
            smi: str = "", **set_kwargs) -> dict:
    """The phase's run (see the section's comment); returns the figures."""
    import gc
    import random
    import shutil
    import tempfile
    from foundationdb_tpu_torch.core.futures import wait_all
    from foundationdb_tpu_torch.core.scheduler import (EventLoop, delay,
                                                       set_event_loop)
    from foundationdb_tpu_torch.testing.workload import TestWorkload
    rng = np.random.default_rng(SIM_SEED)
    datadir = tempfile.mkdtemp(prefix="chip_smoke_sim_")
    loop = EventLoop()
    try:
        c = commit_cluster(datadir, keyspace, device, clock=loop.now,
                           **set_kwargs)
        base = commit_values(rng, keyspace)
        c.load([commit_key(i) for i in range(keyspace)], base)
        c.start(loop)
        net = c.sim.network
        broken = count_broken(net)
        db = c.database()
        records = record_batches(c)
        rw = TestWorkload(c, db, {})
        gc.collect()
        gc.freeze()
        gc.disable()
        acked = []          # (version, batch index, order, key, value)
        # (round, attempts, wall s, virtual time the committed attempt's
        # commit was sent, virtual time its reply came)
        stats = []
        events = {}
        pad = b"." * (COMMIT_VALUE_BYTES - 24)
        n_measured = rw_actors * (rw_txns - rw_warmup)

        async def rw_actor(a: int, rounds) -> None:
            r = random.Random(SIM_SEED * 100_003 + a)
            for rnd in rounds:
                st = {"attempts": 0}

                async def fn(t, rnd=rnd, st=st):
                    st["attempts"] += 1
                    st["txn"] = t
                    await t.get_read_version()
                    for _ in range(4):
                        await t.get(commit_key(r.randrange(keyspace)))
                    if rnd % CLIENT_RANGE_EVERY == CLIENT_RANGE_EVERY - 1:
                        lo = r.randrange(keyspace - CLIENT_RANGE_KEYS)
                        await t.get_range(
                            commit_key(lo),
                            commit_key(lo + CLIENT_RANGE_KEYS))
                    st["writes"] = []
                    for j in range(2):
                        k = commit_key(r.randrange(keyspace))
                        v = b"s%06dr%02dw%d" % (a, rnd, j) + pad
                        st["writes"].append((k, v))
                        t.set(k, v)
                    st["sent"] = loop.now()
                t0 = time.perf_counter()
                await rw.run_transaction(fn)
                wall = time.perf_counter() - t0
                stamp = st["txn"]._committed_stamp
                ver = int.from_bytes(stamp[:8], "big")
                idx = int.from_bytes(stamp[8:], "big")
                for j, (k, v) in enumerate(st["writes"]):
                    acked.append((ver, idx, j, k, v))
                stats.append((rnd, st["attempts"], wall, st["sent"],
                              loop.now()))

        def measured_done() -> int:
            return sum(1 for x in stats if x[0] >= rw_warmup)

        async def nemesis() -> None:
            while measured_done() < SIM_FAULTS_AT[0] * n_measured:
                await delay(0.001)
            events["kill"] = loop.now()
            c.kill_process(SIM_KILLED)
            while measured_done() < SIM_FAULTS_AT[1] * n_measured:
                await delay(0.001)
            events["clog"] = loop.now()
            c.clog_process(SIM_CLOGGED, clog_s)

        if device == "cuda":
            import torch
            torch.cuda.synchronize()
        c.run_until(wait_all([loop.spawn(rw_actor(a, range(rw_warmup)))
                              for a in range(rw_actors)]))
        sent0, batch0, v0 = net.messages_sent, len(records), loop.now()
        t1 = time.perf_counter()
        c.run_until(wait_all(
            [loop.spawn(rw_actor(a, range(rw_warmup, rw_txns)))
             for a in range(rw_actors)] + [loop.spawn(nemesis())]))
        if device == "cuda":
            torch.cuda.synchronize()
        rw_s = time.perf_counter() - t1
        virtual_s = loop.now() - v0
        sent = net.messages_sent - sent0

        # Checks.
        committed = sum(p.metrics.counter("TxnCommitted").value
                        for p in c.plane.proxies.values())
        stamps = {(ver, idx) for ver, idx, _j, _k, _v in acked}
        if committed != len(stats) or len(stamps) != len(stats) or any(
                p.broken for p in c.plane.proxies.values()):
            raise AssertionError(f"the proxies committed {committed} "
                                 f"transactions under {len(stamps)} stamps, "
                                 f"the clients saw {len(stats)}")
        if broken["read_failovers"] <= 0:
            raise AssertionError("no read failed over to a live replica")
        clog_end = events["clog"] + clog_s
        waited = [x for x in stats
                  if events["clog"] <= x[3] < clog_end]
        if not waited or any(x[4] < clog_end for x in waited):
            raise AssertionError(f"{len(waited)} commits sent during the "
                                 "clog, some answered before it ended")
        for role in c.plane.resolvers:
            check_supervised(role.conflict_set, len(records),
                             "TorchConflictSet", device)
        top = c.read_version()
        c.pull()
        model = {}
        for _v, _i, _j, k, v in sorted(acked):
            model[k] = v
        t2 = time.perf_counter()
        reads = live_read_back(c, model, top, {SIM_KILLED})
        readback_s = time.perf_counter() - t2
        c.close()
    finally:
        gc.enable()
        gc.unfreeze()
        set_event_loop(None)
        shutil.rmtree(datadir, ignore_errors=True)
    gc.collect()
    measured = [x for x in stats if x[0] >= rw_warmup]
    sizes = [len(rec[3]) for rec in records[batch0:]]
    return {
        "committed": len(stats), "measured_committed": len(measured),
        "committed_txns_per_s": len(measured) / rw_s, "wall_s": rw_s,
        "virtual_s": virtual_s,
        "p50_txn_ms": float(np.percentile([x[2] for x in measured], 50))
        * 1e3,
        "p99_txn_ms": float(np.percentile([x[2] for x in measured], 99))
        * 1e3,
        "retries_per_commit": sum(x[1] - 1 for x in measured) /
        max(len(measured), 1),
        "read_failovers": broken["read_failovers"],
        "broken_promise_replies": broken["broken_promise"],
        "messages_sent": sent, "killed": SIM_KILLED,
        "kill_at_virtual_s": events["kill"] - v0, "clogged": SIM_CLOGGED,
        "clog_at_virtual_s": events["clog"] - v0, "clog_s": clog_s,
        "commits_waiting_on_clog": len(waited),
        "batches": len(sizes), "mean_batch": float(np.mean(sizes)),
        "readback_reads": reads, "readback_s": readback_s, "card": smi}


def sim_path(smi: str) -> tuple:
    """Phase 25: sim_run on the card, the launches counted over the whole
    drive; the path_sim line."""
    import torch
    from foundationdb_tpu_torch import kernels as K
    K.reset_counts()
    figures = sim_run(smi=smi, capacity=CAPACITY,
                      delta_capacity=DELTA_CAPACITY)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print(f"path_sim: {json.dumps(figures)}", flush=True)
    return launches, figures


# ------------------------------------------------- the Resolver over TCP
# Phase 26: the port's Resolver role (backend "torch" on the card,
# MAX_WRITE_TRANSACTION_LIFE_VERSIONS = WINDOW, as in phase 19) on a
# RealProcess of a RealNetwork at 127.0.0.1 in another OS process (this
# file behind RESOLVER_CHILD_ARG: harness code, not an entry point of
# the port), its interface written serde-encoded to a file the parent
# names.  The parent, on a real-mode EventLoop and a RealNetwork of its
# own, sends phase 19's requests (role_requests, N_ROLE batches of
# 100,000 txns) down the version chain, one at a time, as columnar wire
# frames (RPC_COLUMNAR_ENABLED in both processes), and holds every reply
# (codes, state broadcast, conflicting ranges, exactness) to phase 19's
# in-process role's on the same requests, bit for bit.  The far side's
# launch counts come back over the network.  Then the child is killed:
# the next request must fail with a transport error within WIRE_FAIL_S
# of wall time, and the failure monitor (a waitFailure request held on
# the role) must mark its endpoint failed.
RESOLVER_CHILD_ARG = "--resolver-child"
WIRE_START_S = 300.0
WIRE_FAIL_S = 10.0


@dataclass
class LaunchCountsRequest:
    """The harness's request for the far side's kernel launch counts."""

    reply: Any = None


def wire_register() -> None:
    from foundationdb_tpu_torch.rpc import serde
    serde.bootstrap_registry()
    if serde._REGISTRY.get("LaunchCountsRequest") is None:
        serde.register(LaunchCountsRequest)


def resolver_child(iface_file: str, device: str = DEVICE,
                   capacity: int = CAPACITY,
                   delta_capacity: int = DELTA_CAPACITY) -> int:
    """Phase 26's far side: serve a Resolver role over TCP until killed
    (or until the parent goes away).  Prints nothing."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.core.scheduler import (EventLoop, delay,
                                                       set_event_loop)
    from foundationdb_tpu_torch.rpc import serde
    from foundationdb_tpu_torch.rpc.endpoint import RequestStream
    from foundationdb_tpu_torch.rpc.network import set_network
    from foundationdb_tpu_torch.rpc.real_network import (RealNetwork,
                                                         RealProcess)
    from foundationdb_tpu_torch.server import Resolver
    parent = os.getppid()
    loop = EventLoop(sim=False)
    set_event_loop(loop)
    net = RealNetwork(loop, "127.0.0.1", 0)
    set_network(net)
    wire_register()
    proc = RealProcess(loop, net, name="resolver0")
    port_knobs(MAX_WRITE_TRANSACTION_LIFE_VERSIONS=WINDOW,
               RPC_COLUMNAR_ENABLED=True).__enter__()
    role = Resolver("r0", 0, backend="torch", proxy_ids=list(PROXIES),
                    capacity=capacity, delta_capacity=delta_capacity,
                    device=device)
    role.run(proc)
    counts = RequestStream("harness.launchCounts")
    proc.register(counts)

    async def serve_counts() -> None:
        async for req in counts.queue:
            if device == "cuda":
                import torch
                torch.cuda.synchronize()
            req.reply.send(dict(K.LAUNCHES))

    async def watch_parent() -> None:
        while os.getppid() == parent:
            await delay(1.0)
        os._exit(0)

    proc.spawn(serve_counts())
    proc.spawn(watch_parent())
    with open(iface_file + ".part", "wb") as f:
        f.write(serde.encode_message((role.interface, counts)))
    os.replace(iface_file + ".part", iface_file)
    K.reset_counts()
    loop.run_forever()
    return 0


def wire_path(smi: str, reqs, in_process, phase19_p50_ms: float = 0.0,
              device: str = DEVICE, capacity: int = CAPACITY,
              delta_capacity: int = DELTA_CAPACITY) -> tuple:
    """Phase 26 (see the section's comment): the launches counted on the
    far side, and the figures; prints the path_wire line."""
    import shutil
    import tempfile
    from foundationdb_tpu_torch.core.scheduler import (EventLoop,
                                                       set_event_loop)
    from foundationdb_tpu_torch.core.error import FdbError
    from foundationdb_tpu_torch.rpc import serde
    from foundationdb_tpu_torch.rpc.endpoint import (TRANSPORT_ERRORS,
                                                     RequestStream)
    from foundationdb_tpu_torch.rpc.failure_monitor import FailureMonitor
    from foundationdb_tpu_torch.rpc.network import set_network
    from foundationdb_tpu_torch.rpc.real_network import RealNetwork
    from foundationdb_tpu_torch.server import ResolveTransactionBatchRequest
    from foundationdb_tpu_torch.server.failure import wait_failure_of
    tmp = tempfile.mkdtemp(prefix="chip_smoke_wire_")
    iface_file = os.path.join(tmp, "resolver.iface")
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), RESOLVER_CHILD_ARG,
         iface_file, device, str(capacity), str(delta_capacity)],
        cwd=os.path.dirname(os.path.abspath(__file__)))
    loop = EventLoop(sim=False)
    net = None
    try:
        set_event_loop(loop)
        net = RealNetwork(loop, "127.0.0.1", 0)
        set_network(net)
        wire_register()
        with port_knobs(RPC_COLUMNAR_ENABLED=True):
            t0 = time.perf_counter()
            while not os.path.exists(iface_file):
                if child.poll() is not None:
                    raise AssertionError(f"the resolver process exited "
                                         f"with {child.returncode}")
                if time.perf_counter() - t0 > WIRE_START_S:
                    raise AssertionError("the resolver process did not "
                                         "start")
                time.sleep(0.1)
            start_s = time.perf_counter() - t0
            with open(iface_file, "rb") as f:
                iface, counts_stream = serde.decode_message(f.read())
            ep = iface.resolve.endpoint
            peer = net.peer_metrics.peer(str(ep.address))
            fm = FailureMonitor()

            async def watch() -> None:
                # A waitFailure request held open on the role breaks when
                # its process dies (server/failure.py).
                await wait_failure_of(iface)
                fm.set_status(ep, True)
            watcher = loop.spawn(watch())

            def request(r):
                return ResolveTransactionBatchRequest(
                    r["prev"], r["version"], r["lrv"], r["txns"],
                    txn_state_transactions=r["state"], proxy_id=r["proxy"])

            send_s, rtt_s, req_mb, rep_mb, got = [], [], [], [], []
            rep_enc, rep_dec = [], []
            for i, r in enumerate(reqs):
                b0, r0 = peer.bytes_sent, peer.bytes_received
                t1 = time.perf_counter()
                f = RequestStream.at(ep).get_reply(request(r))
                t2 = time.perf_counter()
                reply = loop.run_until(f, timeout=600.0)
                t3 = time.perf_counter()
                send_s.append(t2 - t1)
                rtt_s.append(t3 - t1)
                req_mb.append((peer.bytes_sent - b0) / 1e6)
                rep_mb.append((peer.bytes_received - r0) / 1e6)
                t4 = time.perf_counter()
                frame = serde.encode_message(reply)
                t5 = time.perf_counter()
                serde.decode_message(frame)
                rep_enc.append(t5 - t4)
                rep_dec.append(time.perf_counter() - t5)
                got.append(reply_of_role(reply))
            for i, (a, b) in enumerate(zip(got, in_process)):
                if not np.array_equal(a[0], b[0]) or a[1:] != b[1:]:
                    raise AssertionError(f"request {i}: the reply over TCP "
                                         f"differs from the in-process "
                                         f"role's")
            # One request's frame encoded and decoded alone, in this
            # process (the send above encodes inside get_reply).
            one = request(reqs[min(N_WARMUP, len(reqs) - 1)])
            t4 = time.perf_counter()
            frame = serde.encode_message(one)
            t5 = time.perf_counter()
            serde.decode_message(frame)
            req_dec = time.perf_counter() - t5
            req_enc = t5 - t4
            launches = loop.run_until(
                RequestStream.at(counts_stream.endpoint).get_reply(
                    LaunchCountsRequest()), timeout=60.0)
            # The kill: the next request fails with a transport error,
            # and the failure monitor marks the role failed.
            child.kill()
            child.wait()
            t6 = time.perf_counter()
            last = reqs[-1]["version"]
            f = RequestStream.at(ep).get_reply(
                ResolveTransactionBatchRequest(last, last + 1, last, [],
                                               proxy_id=PROXIES[0]))
            try:
                loop.run_until(f, timeout=WIRE_FAIL_S)
                raise AssertionError("a request to the killed resolver "
                                     "was answered")
            except FdbError as e:
                if e.name not in TRANSPORT_ERRORS:
                    raise
                fail_name, fail_s = e.name, time.perf_counter() - t6
            loop.run_until(watcher, timeout=WIRE_FAIL_S)
            marked_s = time.perf_counter() - t6
            if not fm.is_failed(ep) or fail_s > WIRE_FAIL_S:
                raise AssertionError("the failure monitor did not mark "
                                     "the killed resolver failed")
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()
        if net is not None:
            net.close()
        set_network(None)
        set_event_loop(None)
        loop.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    measured = slice(N_WARMUP, None) if len(reqs) > N_WARMUP else slice(0, None)

    def p(xs, q):
        return float(np.percentile(xs[measured], q)) * 1e3

    figures = {
        "requests": len(reqs), "txns_per_request": len(reqs[0]["txns"]),
        "format": "columnar", "child_start_s": start_s,
        "request_frame_mb": float(np.median(req_mb)),
        "reply_frame_mb": float(np.median(rep_mb)),
        "request_encode_ms": req_enc * 1e3,
        "request_decode_ms": req_dec * 1e3,
        "send_call_p50_ms": p(send_s, 50),
        "reply_encode_p50_ms": p(rep_enc, 50),
        "reply_decode_p50_ms": p(rep_dec, 50),
        "p50_round_trip_ms": p(rtt_s, 50), "p99_round_trip_ms": p(rtt_s, 99),
        "phase19_p50_request_ms": phase19_p50_ms,
        "killed_request_error": fail_name, "killed_request_fail_s": fail_s,
        "failure_monitor_marked_s": marked_s, "card": smi}
    print(f"path_wire: {json.dumps(figures)}", flush=True)
    return launches, figures

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
    phase_done("toolchain and build")

    log("phase 2: kernels against their plain versions (config 2)")
    cs, packed, buf = warmed_state()
    rows, programs = compare_kernels(cs, packed, buf)
    del cs, buf
    torch.cuda.empty_cache()
    phase_done("config-2 kernels")

    log("phase 3: the point path (config 2)")
    launches = {}
    launches["point"], path, batches2 = main_path(smi)
    phase_done("point path")

    log("phase 4: the new kernels against their plain versions (config 3)")
    cs, packed, win, stream = warmed_general_state()
    rows3, programs3 = compare_general(cs, packed, win, stream)
    next(r for r in rows if r["name"] == "history_probe")[
        "at_shapes"].append(programs3.pop("history_probe_general"))
    rows += rows3
    programs.update(programs3)
    del cs, packed, win, stream
    torch.cuda.empty_cache()
    phase_done("config-3 kernels")

    log("phase 5: the general interval path (config 3)")
    launches["general"], path_general, batches3 = general_path(smi)
    phase_done("general path")
    log("phase 6: oracle parity on small config-3 batches")
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
    oracle_parity3(lambda: TorchConflictSet(
        0, capacity=CAPACITY, delta_capacity=DELTA_CAPACITY, device=DEVICE),
        small_stream3(2028))
    phase_done("config-3 oracle parity")
    log("phase 7: kernel against plain state at full config-3 size")
    state_equality3(batches3)
    torch.cuda.empty_cache()
    phase_done("config-3 state equality")
    log("phase 8: the window path (config 3)")
    launches["window"], path_window = window_path(smi, batches3)
    phase_done("window path")

    log("phase 9: the shard kernels and the sharded programs against their "
        "plain versions")
    rng5 = np.random.default_rng(5055)
    splits5 = config5_splits(rng5)
    log("generating the config-5 stream")
    batches5 = make_stream5(rng5, CONFIG5_BATCHES)
    rows9, programs9 = compare_sharded(splits5, batches5, batches3)
    next(r for r in rows if r["name"] == "merge")["at_shapes"].append(
        programs9["sharded_merge"].pop("one_shard"))
    next(r for r in rows if r["name"] == "point_insert")["at_shapes"].append(
        programs9.pop("point_insert_shard"))
    next(r for r in rows if r["name"] == "history_probe")[
        "at_shapes"].append(programs9.pop("history_probe_shard"))
    next(r for r in rows if r["name"] == "window_query")[
        "at_shapes"].extend(programs9.pop(f"window_query_shard{d}")
                            for d in (0, 1))
    rows += rows9
    programs.update(programs9)
    torch.cuda.empty_cache()
    phase_done("sharded kernels")
    log("phase 10: config 5, four shards on one card")
    launches["sharded"], path_sharded = sharded_path(smi, splits5, batches5)
    torch.cuda.empty_cache()
    phase_done("sharded path")
    log("phase 11: sharded parity and kernel-vs-plain state at config 5")
    sharded_parity(splits5)
    sharded_state_equality(splits5, batches5)
    torch.cuda.empty_cache()
    phase_done("sharded parity and state")
    log("phase 12: the config-3 stream through four shards")
    path_sharded_general = sharded_general(smi, batches3)
    torch.cuda.empty_cache()
    phase_done("sharded general path")
    log("phase 13: the sharded window")
    launches["sharded_window"], path_sharded_window = sharded_window_path(
        smi, batches3)
    del batches3
    phase_done("sharded window path")

    log("phase 14: the supervised point path (config 2)")
    launches["supervised"], path_supervised, txns2, codes2 = \
        supervised_point_path(smi, batches2)
    del txns2[N_ROLE:], codes2[N_ROLE:]
    torch.cuda.empty_cache()
    phase_done("supervised point path")
    log("phase 15: long keys, supervised and bare")
    launches["long_keys"], long_keys = supervised_long_keys(smi)
    phase_done("long keys")
    log("phase 16: degrade and promotion on the card")
    launches["promotion"], degrade = supervised_degrade(smi)
    torch.cuda.empty_cache()
    phase_done("degrade and promotion")
    log("phase 17: the supervised sharded set (config 5)")
    launches["supervised_sharded"], path_supervised_sharded = \
        supervised_sharded(smi, splits5, batches5)
    del batches5
    torch.cuda.empty_cache()
    phase_done("supervised sharded path")
    log('phase 18: new_conflict_set("auto")')
    launches["auto"] = auto_backend(smi)
    phase_done("auto")
    log("phase 19: the Resolver role (config 2) and the entry points")
    launches["resolver"], path_resolver, role_run = resolver_path(
        smi, batches2, txns2, codes2)
    del batches2, txns2, codes2
    launches["entry"] = entry_points(smi)
    phase_done("resolver role and entry points")
    log("phase 20: the resolution plane (config 2, N = 1, 2, 4)")
    launches["plane"], path_plane = plane_path(smi)
    phase_done("resolution plane")
    log("phase 21: the scheduling plane (bench.py sched's regime)")
    launches["sched"], path_sched = sched_path(smi)
    phase_done("scheduling plane")
    log("phase 22: the write path (config 2, double redundancy)")
    launches["commit"], path_commit = commit_path(smi)
    phase_done("write path")
    log("phase 23: a restart (double memory, and the B-tree at a cut)")
    launches["restart"], path_restart = restart_path(smi)
    phase_done("restart")
    log("phase 24: the client (ReadWrite and Cycle through Database)")
    launches["client"], path_client = client_path(smi)
    phase_done("client")
    log("phase 25: faults on the simulated network (ReadWrite, a storage "
        "process killed, a resolver's process clogged)")
    launches["sim"], path_sim = sim_path(smi)
    phase_done("simulated network faults")
    log("phase 26: the Resolver over TCP in another OS process")
    launches["wire"], path_wire = wire_path(
        smi, *role_run, phase19_p50_ms=path_resolver["p50_request_ms"])
    del role_run
    phase_done("resolver over TCP")

    for row in rows:
        by_path = {p: launches[p][row["name"]] for p in PATH_KERNELS}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        for at in row.get("at_shapes", []):
            if "path" in at:  # the probes' shapes: that path's calls
                at["launches_on_path"] = by_path[at["path"]]
    missing = [f"{r['name']} ({p})" for r in rows for p, names in
               PATH_KERNELS.items()
               if r["name"] in names and r["launches_by_path"][p] <= 0]
    missing += [r["name"] for r in rows
                if r["launches"] <= 0 and r["name"] not in OFF_PATH]
    if missing:
        raise AssertionError(f"kernels not launched on their paths: "
                             f"{missing}")
    general = launches["general"]
    if general["searchsorted"] != general["interval_fixpoint"]:
        raise AssertionError(f"searchsorted: {general['searchsorted']} "
                             f"launches over {general['interval_fixpoint']} "
                             "general steps, not one a step")
    print(json.dumps({"programs": programs, "path": path,
                      "path_general": path_general,
                      "path_window": path_window,
                      "path_sharded": path_sharded,
                      "path_sharded_general": path_sharded_general,
                      "path_sharded_window": path_sharded_window,
                      "path_supervised": path_supervised,
                      "long_keys": long_keys, "degrade": degrade,
                      "path_supervised_sharded": path_supervised_sharded,
                      "path_resolver": path_resolver,
                      "path_plane": path_plane,
                      "path_sched": path_sched,
                      "path_commit": path_commit,
                      "path_restart": path_restart,
                      "path_client": path_client,
                      "path_sim": path_sim, "path_wire": path_wire,
                      "phase_seconds": PHASE_SECONDS}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == RESOLVER_CHILD_ARG:
        sys.exit(resolver_child(sys.argv[2], sys.argv[3], int(sys.argv[4]),
                                int(sys.argv[5])))
    sys.exit(main())
