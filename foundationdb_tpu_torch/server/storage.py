"""StorageServer: versioned storage replica over an optional durable
engine (trimmed copy of foundationdb_tpu/server/storage.py).

Reference: fdbserver/storageserver.actor.cpp -- serves reads at versions
inside the MVCC window from a versioned map (:331-362), pulls mutations
for its tag from the TLogs (update :3626), answers getValueQ (:1228) /
getKeyValuesQ (:1929) after waiting for the requested version, and trims
old versions as the window advances.  The versioned map mirrors
fdbclient/VersionedMap.h:624 semantics (per-key version chains with
tombstones) in a bisect-sorted dict.  A durable IKeyValueStore engine
(kvstore.py, kvstore_btree.py) attaches below the MVCC window: the
updateStorage actor (:4002) batches applied mutations into it, commits,
advances durable_version and only then lets the TLogs trim.

Kept: VersionedMap whole, with one range-scan form (the reference's
STORAGE_VECTORIZED_SCAN loop, whose rows equal its plain loop's); the
role's mutation apply (sets, clears, atomics resolved at apply time, and
with an engine each queued for it, atomics as their result); the body of
the pull loop as pull_step() (peek this server's tag, apply, advance,
forget history below the window; with no engine applied is durable and
the pull pops the log at once); one pass of _update_storage_loop as
update_storage() (the pending batch and the meta key into the engine,
its commit, durable_version, then the pop), its target capped at the
version durable on every TLog; from_engine(), which rebuilds
a killed server from its engine at its durable version; set_log_system(),
which re-targets the pull at a new log generation and, crossing into a
newer epoch, rolls back what was applied past the recovery version and
re-images the engine there; _wait_for_version, which pulls until it
reaches the version, else raises future_version, and raises
transaction_too_old below the window; the point and range reads; and
load(), which fills the map at the recovery version and images the
engine there.

On a simulated or real process (run(process)), one actor a stream
serves the interface's get_value and get_key_values with the handlers
above (the reference's serve loops), beside the waitFailure holder, each
read after a pull to the version durable on every log (the reference's
update loop keeps pulling as the logs move); a read at a version past
what the logs hold is tried again once after
STORAGE_FUTURE_VERSION_TIMEOUT of the loop's time, then answers
future_version (the reference waits on its version for at most that
long).  The pull reads the TLog roles within the call (their peek,
not their interface): a storage server's traffic with its logs does
not cross the network.

Data distribution (the reference's :36-107, :287-300, :420-479,
:644-653, :711-828): the shard map of `owned`, `fetching` and `absent`
spans, each owned span with the least version it answers reads at
(_check_owned: a read outside an owned span, or below it, answers
wrong_shard_server and the client locates the key again); _apply buffers
what lands in a span being fetched and consumes the disownment fence
in-stream (system_data.DISOWN_SHARD_PREFIX: the span closes at the
move's version, or, while a fetch loads it, is judged when the fetch
completes); _fetch_keys takes a snapshot from the first source that
answers, at or above the move's phase-1 version and this server's own
version, pulls this server's tag up to the snapshot, lays the snapshot
and the buffered tail above it into the map, queues the span's image
at its version for the engine, and opens the span there; _fetch_shard
serves a snapshot floored at min_version, pulling the source forward
first, and answers future_version when the logs cannot take it that far
within STORAGE_FUTURE_VERSION_TIMEOUT; _shard_metrics answers a span's
bytes from the incremental _ShardMetricsCache (exact deltas from every
write) or a scan, and a key that halves it past the split threshold;
_remove_shard drops a vacated span.  A StaticCluster gives each server
the spans of its teams as owned and the rest as absent; a server built
alone owns everything, as the reference's cold boot does.

Engine migration (:1001-1075): the migrate_engine stream queues a
MigrateEngineRequest (_migrate_engine), and the next update_storage(),
after its commit, images the state at durable_version into a fresh
engine of the asked kind from the worker's factory, swaps it in and
deletes the old files (_do_migrate_engine, over _image_engine);
engine_name names the kind, on the interface too.  With an engine, a
fetch is answered once the fetched span is durable (the reference's
fetchKeys waits for its transferred version to be durable), so a move
never names a destination whose engine lacks the span.

Left out: the update-storage loop's delay and buggify, watches, read
heat and tag sampling, TSS, and the commit-debug trace points.
"""

from __future__ import annotations

import bisect
import heapq
import inspect
from time import perf_counter
from typing import Dict, List, Optional, Tuple

from ..core.error import FdbError, err
from ..core.coverage import test_coverage
from ..core.knobs import server_knobs
from ..core.scheduler import delay
from ..core.trace import Severity, TraceEvent
from ..core.wire import Reader, Writer
from ..rpc.endpoint import RequestStream
from ..txn.atomic import apply_atomic
from ..txn.types import ATOMIC_OPS, Mutation, MutationType, Version
from .failure import hold_wait_failure
from .interfaces import (FetchShardReply, FetchShardRequest,
                         GetKeyValuesReply, GetKeyValuesRequest,
                         GetValueReply, GetValueRequest,
                         StorageServerInterface, Tag)
from .shardmap import RangeMap
from .system_data import DISOWN_SHARD_PREFIX


class _ShardMetricsCache:
    """Exact byte and key counts of the spans data distribution polls,
    kept by write-time deltas, so a quiet shard's poll answers in O(1)
    and only a shard that needs a split key, or whose entry expired,
    scans its keys.

    Entries are keyed by the polled span's begin and remember its end; a
    poll whose end differs (the shard split or merged) misses and scans,
    and put() evicts the entries strictly inside the new span, so a
    merged-away boundary cannot keep taking deltas that belong to the
    survivor.  An entry expires after REFRESH_POLLS answers."""

    MAX_ENTRIES = 4096        # hard bound; overflow clears the cache
    REFRESH_POLLS = 64        # answers between full scans, a shard

    def __init__(self) -> None:
        self._begins: List[bytes] = []
        # begin -> [end, total_bytes, live_keys, polls_left]
        self._entries: Dict[bytes, list] = {}

    def note_delta(self, key: bytes, dbytes: int, dn: int) -> None:
        begins = self._begins
        if not begins:
            return
        i = bisect.bisect_right(begins, key) - 1
        if i < 0:
            return
        e = self._entries[begins[i]]
        if key < e[0]:
            e[1] += dbytes
            e[2] += dn

    def get(self, begin: bytes, end: bytes):
        """(total_bytes, live_keys) when an unexpired entry covers this
        exact span; None: the caller scans."""
        e = self._entries.get(begin)
        if e is None or e[0] != end:
            return None
        e[3] -= 1
        if e[3] <= 0:
            i = bisect.bisect_left(self._begins, begin)
            del self._begins[i]
            del self._entries[begin]
            return None
        return max(e[1], 0), max(e[2], 0)

    def put(self, begin: bytes, end: bytes, total: int, n: int) -> None:
        begins = self._begins
        lo = bisect.bisect_right(begins, begin)
        hi = bisect.bisect_left(begins, end)
        for b in begins[lo:hi]:
            del self._entries[b]
        del begins[lo:hi]
        if begin not in self._entries:
            if len(begins) >= self.MAX_ENTRIES:
                self.clear_all()
            bisect.insort(self._begins, begin)
        self._entries[begin] = [end, total, n, self.REFRESH_POLLS]

    def clear_all(self) -> None:
        self._begins = []
        self._entries = {}


class VersionedMap:
    """Per-key version chains with tombstones (None = cleared)."""

    def __init__(self) -> None:
        self._keys: List[bytes] = []
        self._chains: Dict[bytes, List[Tuple[Version, Optional[bytes]]]] = {}
        # GC work queue: (version, key) pushed when a chain grows history or
        # a tombstone lands; forget_before only revisits these chains, so GC
        # is amortized O(1) per mutation instead of O(total keys) per call.
        self._gc_heap: List[Tuple[Version, bytes]] = []
        # The _ShardMetricsCache fed exact (key, dbytes, dn) deltas: every
        # change of live state passes through set() (clear_range sets a
        # tombstone a live key); rollback() and load() are the bulk
        # exceptions and clear it.
        self._metrics_cache: Optional[_ShardMetricsCache] = None

    def _chain(self, key: bytes) -> List[Tuple[Version, Optional[bytes]]]:
        c = self._chains.get(key)
        if c is None:
            c = self._chains[key] = []
            bisect.insort(self._keys, key)
        return c

    def set(self, key: bytes, value: Optional[bytes],
            version: Version) -> None:
        c = self._chain(key)
        cache = self._metrics_cache
        if cache is not None:
            prev = c[-1][1] if c else None
            if prev is not value:
                klen = len(key)
                cache.note_delta(
                    key,
                    (klen + len(value) if value is not None else 0) -
                    (klen + len(prev) if prev is not None else 0),
                    (value is not None) - (prev is not None))
        if c and c[-1][0] == version:
            c[-1] = (version, value)
        else:
            assert not c or c[-1][0] < version
            c.append((version, value))
        if len(c) > 1 or value is None:
            heapq.heappush(self._gc_heap, (version, key))

    def load(self, keys, values, version: Version) -> None:
        """Fill an empty map with `keys` (ascending, distinct) and their
        values at `version`: what set() would build key by key, without
        one insort each."""
        if self._keys:
            raise ValueError("load() fills an empty map")
        keys = list(keys)
        if any(a >= b for a, b in zip(keys, keys[1:])):
            raise ValueError("load() takes ascending, distinct keys")
        self._keys = keys
        self._chains = {k: [(version, v)] for k, v in zip(keys, values)}
        if self._metrics_cache is not None:
            self._metrics_cache.clear_all()

    def set_rows(self, rows, version: Version) -> None:
        """set() of each (key, value) of `rows` (ascending, distinct
        keys), the new keys merged into the key list at once rather than
        one insort each (a fetched shard)."""
        new = []
        chains = self._chains
        cache = self._metrics_cache
        for k, v in rows:
            if k not in chains and v is not None:
                # What set() does for a key new to the map: one entry, no
                # history for the GC, the whole row a delta of the cache.
                chains[k] = [(version, v)]
                new.append(k)
                if cache is not None:
                    cache.note_delta(k, len(k) + len(v), 1)
                continue
            if k not in chains:
                chains[k] = []
                new.append(k)
            self.set(k, v, version)
        if new:
            lo = bisect.bisect_left(self._keys, new[0])
            hi = bisect.bisect_right(self._keys, new[-1])
            self._keys[lo:hi] = sorted(self._keys[lo:hi] + new)

    def clear_range(self, begin: bytes, end: bytes, version: Version) -> None:
        """set(key, None, version) of every live key in [begin, end),
        inline: a vacated shard clears hundreds of thousands."""
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        chains = self._chains
        cache = self._metrics_cache
        heap = self._gc_heap
        for key in self._keys[lo:hi]:
            c = chains[key]
            if not c:
                continue
            prev = c[-1][1]
            if prev is None:
                continue
            if cache is not None:
                cache.note_delta(key, -(len(key) + len(prev)), -1)
            if c[-1][0] == version:
                c[-1] = (version, None)
            else:
                assert c[-1][0] < version
                c.append((version, None))
            heapq.heappush(heap, (version, key))

    def get(self, key: bytes, version: Version) -> Optional[bytes]:
        c = self._chains.get(key)
        if not c:
            return None
        # Chains are short (one MVCC window); scan from newest.
        for v, val in reversed(c):
            if v <= version:
                return val
        return None

    def latest(self, key: bytes) -> Optional[bytes]:
        c = self._chains.get(key)
        return c[-1][1] if c else None

    def range_read(self, begin: bytes, end: bytes, version: Version,
                   limit: int, limit_bytes: int, reverse: bool = False
                   ) -> Tuple[List[Tuple[bytes, bytes]], bool]:
        """The live rows of [begin, end) at `version`, in key order (or
        reversed), at most `limit` rows and about `limit_bytes`; `more`
        when a limit cut the scan.  Each chain's newest entry is probed
        first: chains are length 1 except inside the MVCC window of a key
        written there."""
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        keys = self._keys[lo:hi]
        if reverse:
            keys = keys[::-1]
        out: List[Tuple[bytes, bytes]] = []
        nbytes = 0
        chains = self._chains
        append = out.append
        for key in keys:
            c = chains[key]
            v, val = c[-1]
            if v > version:
                val = None
                for v, x in reversed(c):
                    if v <= version:
                        val = x
                        break
            if val is None:
                continue
            append((key, val))
            nbytes += len(key) + len(val)
            if len(out) >= limit or nbytes >= limit_bytes:
                return out, True
        return out, False

    def range_bytes(self, begin: bytes, end: bytes, version: Version
                    ) -> Tuple[int, int]:
        """(bytes, live key count) over [begin, end) at `version` without
        materializing the values list."""
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        total = 0
        n = 0
        for key in self._keys[lo:hi]:
            val = self.get(key, version)
            if val is None:
                continue
            total += len(key) + len(val)
            n += 1
        return total, n

    def rollback(self, version: Version) -> None:
        """Drop all entries newer than `version` (reference storageserver
        rollback at recovery)."""
        dead: List[bytes] = []
        for key, c in self._chains.items():
            while c and c[-1][0] > version:
                c.pop()
            if not c:
                dead.append(key)
        for key in dead:
            del self._chains[key]
            j = bisect.bisect_left(self._keys, key)
            del self._keys[j]
        if self._metrics_cache is not None:
            self._metrics_cache.clear_all()

    def forget_before(self, version: Version) -> None:
        """Drop history below `version`; keys whose only state is an old
        tombstone disappear entirely (reference forgetVersionsBefore).
        Only chains with queued GC work are visited (amortized; mirrors the
        reference SkipList's lazy removeBefore)."""
        dead = []
        while self._gc_heap and self._gc_heap[0][0] <= version:
            _, key = heapq.heappop(self._gc_heap)
            c = self._chains.get(key)
            if c is None:
                continue
            i = 0
            # Keep the newest entry at/below `version` as the base state.
            while i + 1 < len(c) and c[i + 1][0] <= version:
                i += 1
            if i > 0:
                del c[:i]
            if len(c) == 1 and c[0][1] is None and c[0][0] <= version:
                del self._chains[key]
                dead.append(key)
        if len(dead) > 64:
            # A vacated shard: one pass over the key list, not a
            # memmove of it a key.
            gone = set(dead)
            self._keys = [k for k in self._keys if k not in gone]
        else:
            for key in dead:
                del self._keys[bisect.bisect_left(self._keys, key)]

    def __len__(self) -> int:
        return len(self._keys)


# The engine's identity record: above every shard-map range end.
_META_KEY = b"\xff\xff/storageMeta"


class _Fetch:
    """One fetch in flight (an identity: two adjacent fetches are two
    spans of the shard map, never one)."""

    __slots__ = ("buffer", "disowns")

    def __init__(self) -> None:
        self.buffer = []   # [(version, Mutation)] pulled during the fetch
        # Disownment fences pulled during the fetch, [(begin, end,
        # version)], judged when it completes: one newer than the
        # acquiring move (the fetch's min_version) means the span moved
        # away again while the snapshot loaded, and closes it.
        self.disowns = []


class StorageServer:
    def __init__(self, ss_id: str, tag: Tag, log_system,
                 recovery_version: Version = 0, engine=None) -> None:
        self.id = ss_id
        self.tag = tag
        self.log_system = log_system    # LogSystemClient
        self.data = VersionedMap()
        self.version: Version = recovery_version
        self.durable_version: Version = recovery_version
        self.oldest_version: Version = recovery_version
        # The peek cursor: the next version to ask the log for.
        self._fetch_from: Version = recovery_version + 1
        self.stats = {"mutations": 0}
        # Durable engine (IKeyValueStore); None = memory-only role.
        # Applied mutations queue here, (version, op, a, b) with op 0 a
        # set (b None: the key cleared) and 1 a clear of [a, b), until
        # update_storage() commits them into the engine.
        self.engine = engine
        self._durable_pending: List[Tuple[Version, int, bytes,
                                          Optional[bytes]]] = []
        # Epoch of the log system that fed this server's data; rollback
        # on set_log_system applies only when crossing to a NEWER epoch.
        self.log_epoch = 0
        # Seconds of the last update_storage()'s engine commit.
        self.last_engine_commit_s = 0.0
        # The engine's kind, the worker's `name -> (new engine, cleanup of
        # the old one's files)` factory, and a MigrateEngineRequest that
        # the next update_storage() carries out.
        self.engine_name = ""
        self._engine_factory = None
        self._pending_engine = None
        # The event-loop half (run()), and the seconds its reads took.
        self.interface = StorageServerInterface(ss_id, tag)
        self.interface.role = self   # in-process backref (not on the wire)
        self._parked: set = set()     # reads waiting for their version
        self.read_seconds = 0.0
        # Data distribution: exact shard sizes for its polls, and the
        # shard map, (state, x) by span: ("owned", least read version),
        # ("fetching", _Fetch) or ("absent", 0).
        self._shard_cache = _ShardMetricsCache()
        self.data._metrics_cache = self._shard_cache
        self.shards: RangeMap = RangeMap(default=("owned", 0))
        # What this server fetched: rows, bytes and the fetches' seconds.
        self.fetch_stats = {"rows": 0, "bytes": 0, "seconds": 0.0}

    @classmethod
    def from_engine(cls, engine) -> Optional["StorageServer"]:
        """Rebuild a killed storage server from its durable engine at its
        durable version (reference: storage restore from IKeyValueStore at
        worker boot).  None for an engine with no identity record (killed
        before the role's first commit).  The caller sets its log system
        (set_log_system)."""
        engine.recover()
        raw = engine.read_value(_META_KEY)
        if raw is None:
            return None
        r = Reader(raw)
        ss_id, tag, durable = r.str_(), r.u32(), r.i64()
        log_epoch = r.u32() if not r.at_end() else 0
        ss = cls(ss_id, tag, None, recovery_version=durable, engine=engine)
        ss.log_epoch = log_epoch
        rows = engine.read_range(b"", b"\xff\xff")
        ss.data.load([k for k, _v in rows], [v for _k, v in rows], durable)
        TraceEvent("StorageRecoveredFromDisk").detail("Id", ss_id).detail(
            "Tag", tag).detail("Version", durable).detail(
            "Keys", len(ss.data)).log()
        return ss

    def _meta_blob(self, version: Version) -> bytes:
        return (Writer().str_(self.id).u32(self.tag).i64(version)
                .u32(self.log_epoch).done())

    def load(self, keys, values) -> None:
        """Fill this replica with sorted `keys` and their `values` at its
        version, as from_engine fills it from its engine
        (storage.py:407-408), and image the engine there.  A replica that
        already holds other keys (the system keys a cluster committed
        before the load) keeps them."""
        if len(self.data):
            self.data.set_rows(list(zip(keys, values)), self.version)
        else:
            self.data.load(keys, values, self.version)
        if self.engine is not None:
            self._image_engine(self.engine, self.version)

    # -- mutation ingestion (reference update :3626) -------------------------
    def _apply(self, m: Mutation, version: Version) -> None:
        """Apply one pulled mutation: the disownment fence closes its
        span in-stream; what lands in a span being fetched waits in the
        fetch's buffer (applied above the snapshot when it lands); a
        clear over fetching and other spans is cut along them."""
        if m.type == MutationType.SetValue and \
                m.param1.startswith(DISOWN_SHARD_PREFIX):
            # The committing proxy moved [begin, end) off this server at
            # `version`: consumed, never stored; the rows stay until a
            # RemoveShardRequest or a fetch that takes the span again.
            self._disown_shard(m.param1[len(DISOWN_SHARD_PREFIX):],
                               m.param2, version)
            return
        if m.type == MutationType.ClearRange:
            pieces = list(self.shards.intersecting(m.param1, m.param2))
            if any(st[0] == "fetching" for _b, _e, st in pieces):
                for b, e, st in pieces:
                    cm = Mutation(MutationType.ClearRange, b, e)
                    if st[0] == "fetching":
                        st[1].buffer.append((version, cm))
                    else:
                        self._apply_direct(cm, version)
                return
        else:
            st = self.shards.lookup(m.param1)
            if st[0] == "fetching":
                st[1].buffer.append((version, m))
                return
        self._apply_direct(m, version)

    def _disown_shard(self, begin: bytes, end: bytes,
                      version: Version) -> None:
        if not begin < end:
            return
        closed = 0
        for b, e, st in list(self.shards.intersecting(begin, end)):
            if st[0] == "fetching":
                # Whether this fence postdates the fetch's acquiring move
                # (close at completion) or comes from an earlier tenure
                # (the fetch wins) is decided when the fetch completes.
                st[1].disowns.append((b, e, version))
                continue
            if st[0] == "owned":
                self.shards.set_range(b, e, ("absent", 0))
                closed += 1
        if closed:
            test_coverage("SSDisownShardFence")
            TraceEvent("SSShardDisowned").detail("Id", self.id).detail(
                "Begin", begin).detail("End", end).detail(
                "Version", version).log()

    def _apply_direct(self, m: Mutation, version: Version,
                      queue: bool = True) -> None:
        """Apply one mutation to the map, and with an engine (and
        `queue`) queue it for the engine."""
        self.stats["mutations"] += 1
        engine = queue and self.engine is not None
        if m.type == MutationType.SetValue:
            self.data.set(m.param1, m.param2, version)
            if engine:
                self._queue_durable(version, 0, m.param1, m.param2)
        elif m.type == MutationType.ClearRange:
            self.data.clear_range(m.param1, m.param2, version)
            if engine:
                self._queue_durable(version, 1, m.param1, m.param2)
        elif m.type in ATOMIC_OPS:
            existing = self.data.latest(m.param1)
            result = apply_atomic(m.type, existing, m.param2)
            self.data.set(m.param1, result, version)
            if engine:
                # The engine logs the atomic's result (reference: the
                # update path expands atomics before updateStorage).
                self._queue_durable(version, 0, m.param1, result)
        else:
            TraceEvent("SSUnknownMutation", Severity.Warn).detail(
                "Type", int(m.type)).log()

    def _queue_durable(self, version: Version, op: int, a: bytes,
                       b: Optional[bytes]) -> None:
        self._durable_pending.append((version, op, a, b))

    def pull_step(self) -> bool:
        """One pass of the update actor's loop (_pull_loop :514-562): peek
        this server's tag from the cursor, apply what came back, advance
        past empty versions too and forget history below the MVCC window;
        with no engine, applied is durable and the log is popped at once
        (with one, update_storage() pops).  True if the version moved."""
        if self.log_system is None:
            return False
        reply = self.log_system.peek_tag(self.tag, self._fetch_from)
        new_version = self.version
        for version, msgs in reply.messages:
            assert version > self.version
            for m in msgs:
                self._apply(m, version)
            new_version = version
        # Advance past empty versions too: the TLog's version frontier
        # covers commits that had no mutations for our tag.
        new_version = max(new_version, reply.max_known_version)
        moved = new_version > self.version
        if moved:
            self.version = new_version
            self.oldest_version = max(
                self.oldest_version,
                new_version -
                int(server_knobs().MAX_READ_TRANSACTION_LIFE_VERSIONS))
            self.data.forget_before(self.oldest_version)
            if self.engine is None:
                self.durable_version = new_version
                self.log_system.pop(self.tag, new_version)
        self._fetch_from = reply.end
        return moved

    # -- durability (reference updateStorage :4002) ---------------------------
    def update_storage(self) -> bool:
        """One pass of _update_storage_loop (:564-629), with no delay and
        no buggify: the pending mutations up to the target version and
        the meta key into the engine, its commit, then durable_version
        moves to the target and the log is popped to it; then a queued
        engine migration.  The target is the applied version, capped at
        the version durable on every TLog of the log system (the
        reference takes the applied version: a version one log appended
        and another lost can reach its engine, and a later recovery ends
        below it, where the rebuilt server has no history to roll back
        to).  The migration comes after the commit (the reference's
        before it), so a drained server's clears are in the image it
        takes and its rows are not copied through the swap.  True if the
        durable version moved."""
        if self.engine is None:
            return False
        moved = self._commit_durable()
        if self._pending_engine is not None:
            req, self._pending_engine = self._pending_engine, None
            self._do_migrate_engine(req)
        return moved

    def _commit_durable(self) -> bool:
        target = self.version
        if self.log_system is not None:
            target = min(target, self.log_system.durable_version())
        if target <= self.durable_version:
            return False
        pending = self._durable_pending
        n = len(pending)
        while n and pending[n - 1][0] > target:
            n -= 1
        batch, self._durable_pending = pending[:n], pending[n:]
        t0 = perf_counter()
        for _v, op, a, b in batch:
            if op == 0:
                if b is None:
                    self.engine.clear(a, a + b"\x00")
                else:
                    self.engine.set(a, b)
            else:
                self.engine.clear(a, b)
        self.engine.set(_META_KEY, self._meta_blob(target))
        self.engine.commit()
        self.last_engine_commit_s = perf_counter() - t0
        self.durable_version = target
        if self.log_system is not None:
            self.log_system.pop(self.tag, target)
        return True

    # -- epoch change (reference: the server rejoins the new log system) -----
    def set_log_system(self, log_system, recovery_version: Version,
                       epoch: int = 0) -> None:
        """Re-target the pull cursor at a new TLog generation.  Crossing
        into a NEWER epoch, what was applied past the recovery version is
        rolled back (it may never have been acknowledged) and the engine
        is re-imaged at it; rejoining the SAME generation keeps the
        image."""
        self.log_system = log_system
        crossing = epoch > self.log_epoch
        self.log_epoch = max(self.log_epoch, epoch)
        if crossing and self.version > recovery_version:
            self.data.rollback(recovery_version)
            self.version = recovery_version
            self.durable_version = recovery_version
            self._durable_pending = [
                e for e in self._durable_pending if e[0] <= recovery_version]
            if self.engine is not None:
                # The durable image may run ahead of the new recovery
                # version: rewrite it from the rolled-back map.
                self._rebuild_engine(recovery_version)
            TraceEvent("StorageRolledBack").detail("Id", self.id).detail(
                "Version", recovery_version).detail("Epoch", epoch).log()
        self._fetch_from = self.version + 1

    def _image_engine(self, engine, version: Version) -> None:
        """Replace `engine`'s contents with this server's MVCC state at
        `version` and the identity record, durably."""
        engine.clear(b"", b"\xff\xff\xff")
        for k, v in self.data.range_read(b"", b"\xff\xff", version,
                                         1 << 30, 1 << 40)[0]:
            engine.set(k, v)
        engine.set(_META_KEY, self._meta_blob(version))
        engine.commit()

    def _rebuild_engine(self, version: Version) -> None:
        self._image_engine(self.engine, version)

    # -- engine migration (reference storage.py:1001-1075) --------------------
    def _migrate_engine(self, req) -> None:
        """Queue an engine rewrite for the next update_storage(), so the
        swap falls between two durability batches; False if the engine is
        already `req.engine`."""
        if self.engine is None or self._engine_factory is None:
            req.reply.send_error(err(
                "client_invalid_operation",
                "role has no durable engine or no factory"))
            return
        if req.engine == self.engine_name:
            req.reply.send(False)
            return
        if self._pending_engine is not None:
            req.reply.send_error(err("operation_failed",
                                     "migration already in flight"))
            return
        self._pending_engine = req

    def _do_migrate_engine(self, req) -> None:
        """Image the state at durable_version into a fresh engine of the
        requested kind, swap, and delete the old engine's files.  What is
        queued past durable_version stays queued and lands on the new
        engine in later batches: no mutation is lost or applied twice.
        On a failure the old engine, untouched until the swap, stays."""
        try:
            new_engine, cleanup_old = self._engine_factory(req.engine)
            dv = self.durable_version
            self._image_engine(new_engine, dv)
            old_name = self.engine_name
            self.engine = new_engine
            self.engine_name = req.engine
            self.interface.engine_name = req.engine
            cleanup_old()
            TraceEvent("SSEngineMigrated").detail("Id", self.id).detail(
                "From", old_name).detail("To", req.engine).detail(
                "Version", dv).log()
            req.reply.send(True)
        except Exception as e:  # noqa: BLE001 -- answered with the error
            TraceEvent("SSEngineMigrateFailed", Severity.Error).detail(
                "Id", self.id).detail("Error", repr(e)).log()
            req.reply.send_error(e if isinstance(e, FdbError) else
                                 err("operation_failed", repr(e)))

    def pull(self) -> int:
        """Pull until the log has nothing newer for this tag; returns the
        steps that moved the version (a peek cut by its byte budget takes
        one step a version)."""
        steps = 0
        while self.pull_step():
            steps += 1
        return steps

    # -- read path (reference getValueQ :1228, waitForVersion) ---------------
    def _wait_for_version(self, version: Version) -> None:
        """Pull until this server's version reaches `version` (the
        reference waits for it, with STORAGE_FUTURE_VERSION_TIMEOUT);
        future_version if the log has nothing that far, and
        transaction_too_old below the window."""
        if version < self.oldest_version:
            raise err("transaction_too_old")
        if version > self.version:
            while version > self.version and self.pull_step():
                pass
            if version > self.version:
                raise err("future_version")
        if version < self.oldest_version:
            raise err("transaction_too_old")

    def _check_owned(self, begin: bytes, end: bytes,
                     version: Version) -> None:
        """A read must fall in owned spans whose snapshot is complete at
        its version; else wrong_shard_server, and the client locates the
        key again (the reference's shard availability check)."""
        for _b, _e, st in self.shards.intersecting(begin, end):
            if st[0] != "owned" or version < st[1]:
                raise err("wrong_shard_server")

    def get_value(self, req: GetValueRequest) -> None:
        try:
            self._wait_for_version(req.version)
            self._check_owned(req.key, req.key + b"\x00", req.version)
        except FdbError as e:   # errors travel in the reply
            req.reply.send_error(e)
            return
        value = self.data.get(req.key, req.version)
        req.reply.send(GetValueReply(value=value, version=req.version))

    def get_key_values(self, req: GetKeyValuesRequest) -> None:
        try:
            self._wait_for_version(req.version)
            self._check_owned(req.begin, req.end, req.version)
        except FdbError as e:
            req.reply.send_error(e)
            return
        data, more = self.data.range_read(
            req.begin, req.end, req.version, req.limit, req.limit_bytes,
            req.reverse)
        req.reply.send(GetKeyValuesReply(data=data, more=more,
                                         version=req.version))

    # -- the serve loops (a process) -----------------------------------------
    async def _serve(self, stream, handler) -> None:
        async for req in stream.queue:
            t0 = perf_counter()
            # The reference's update loop pulls as the logs move; here a
            # read first pulls to what every log holds, so the MVCC
            # window (and its too-old floor) follows the log as there.  A
            # server its worker rebuilt from disk has no log system until
            # the next epoch's broadcast re-targets it.
            if self.log_system is not None:
                self._reaches(self.log_system.durable_version())
            if req.version > self.version and not self._reaches(
                    req.version):
                self._park(req, handler)
            else:
                handler(req)
            self.read_seconds += perf_counter() - t0

    def _reaches(self, version: Version) -> bool:
        """Pull until `version` is applied or the logs have nothing
        newer; whether it was reached."""
        while version > self.version and self.pull_step():
            pass
        return version <= self.version

    # -- data distribution (reference fetchKeys :107-123, :711-828) ----------
    async def _fetch_keys(self, req) -> None:
        """Become a replica of [begin, end): buffer the mutations that
        land in it, take a snapshot from the first source that answers,
        pull up to the snapshot, lay it and the buffered tail above it
        into the map, and open the span for reads from there."""
        fetch = _Fetch()
        t0 = perf_counter()
        # The snapshot also covers what this server applied to the span
        # before the fetch began (it may run ahead of the phase-1 commit),
        # so every row of the span below the snapshot's version is in it.
        floor = max(req.min_version, self.version)
        self.shards.set_range(req.begin, req.end, ("fetching", fetch))
        try:
            reply = None
            last: Optional[BaseException] = None
            for src in req.sources:
                try:
                    reply = await RequestStream.at(
                        src.fetch_shard.endpoint).get_reply(
                        FetchShardRequest(begin=req.begin, end=req.end,
                                          min_version=floor))
                    break
                except FdbError as e:
                    last = e
            if reply is None:
                raise last or err("operation_failed", "no fetch source")
            vf = reply.version
            # Pulled to the snapshot, the buffer holds every mutation of
            # the span above it, in version order.
            if not self._reaches(vf):
                raise err("future_version")
            # A previous tenure's rows must not survive under the
            # snapshot (the reference clears the span before loading).
            self.data.clear_range(req.begin, req.end, vf)
            self.data.set_rows(reply.data, vf)
            for version, m in fetch.buffer:
                if version > vf:      # the snapshot holds the rest
                    self._apply_direct(m, version, queue=False)
            min_read = max(vf, self.version)
            if self.engine is not None:
                # The span's image at min_read (this server's version),
                # so the engine's queue stays in version order: the
                # snapshot itself when nothing landed in the span above it.
                self._queue_durable(min_read, 1, req.begin, req.end)
                rows = reply.data if all(
                    version <= vf for version, _m in fetch.buffer) else \
                    self.data.range_read(req.begin, req.end, min_read,
                                         1 << 62, 1 << 62)[0]
                for k, v in rows:
                    self._queue_durable(min_read, 0, k, v)
            self.shards.set_range(req.begin, req.end, ("owned", min_read))
            for db_, de_, dv in fetch.disowns:
                # Moved away again while the snapshot was in flight: a
                # fence newer than the acquiring move closes its span.
                if dv > req.min_version:
                    self._disown_shard(db_, de_, dv)
            if self.engine is not None:
                # Answered once the span's image is durable (the
                # reference's fetchKeys waits for its transferred version
                # to be durable): the move's phase 2 then names a server
                # whose engine holds the span.  The snapshot is in no
                # log, so a power failure before this point would lose
                # it from a destination the recovered shard map names.
                while self.durable_version < min_read:
                    if not self.update_storage():
                        await delay(0.01)
            self.fetch_stats["rows"] += len(reply.data)
            self.fetch_stats["bytes"] += sum(len(k) + len(v)
                                             for k, v in reply.data)
            self.fetch_stats["seconds"] += perf_counter() - t0
            TraceEvent("SSFetchKeysDone").detail("Id", self.id).detail(
                "Begin", req.begin).detail("End", req.end).detail(
                "Keys", len(reply.data)).detail("MinRead", min_read).log()
            req.reply.send(None)
        except BaseException as e:  # noqa: BLE001
            # A failed fetch leaves the span absent (data distribution
            # rolls the move back and tries again).
            self.shards.set_range(req.begin, req.end, ("absent", 0))
            req.reply.send_error(e)
            if not isinstance(e, Exception):
                raise   # cancellation keeps unwinding

    async def _fetch_shard(self, req) -> None:
        """A snapshot of [begin, end) at this server's version, floored
        at req.min_version (the MoveKeys phase-1 commit): the logs are
        pulled that far first, tried again once after
        STORAGE_FUTURE_VERSION_TIMEOUT, else future_version, so the
        destination moves on to its next source."""
        if not self._reaches(req.min_version):
            await delay(float(server_knobs().STORAGE_FUTURE_VERSION_TIMEOUT))
            if not self._reaches(req.min_version):
                req.reply.send_error(err("future_version"))
                return
        v = self.version
        data, _more = self.data.range_read(req.begin, req.end, v,
                                           1 << 62, 1 << 62)
        req.reply.send(FetchShardReply(data=data, version=v))

    def _shard_metrics(self, req) -> None:
        """(bytes, split key) of [begin, end) at this server's version:
        the split key halves the bytes and is sent only past
        req.split_threshold."""
        v = self.version
        if server_knobs().STORAGE_INCREMENTAL_SHARD_METRICS:
            hit = self._shard_cache.get(req.begin, req.end)
            if hit is not None and hit[0] <= req.split_threshold:
                req.reply.send((hit[0], None))
                return
            total, n = self.data.range_bytes(req.begin, req.end, v)
            self._shard_cache.put(req.begin, req.end, total, n)
        else:
            total, n = self.data.range_bytes(req.begin, req.end, v)
        split_key = None
        if total > req.split_threshold and n >= 2:
            acc = 0
            lo = bisect.bisect_left(self.data._keys, req.begin)
            hi = bisect.bisect_left(self.data._keys, req.end)
            for k in self.data._keys[lo:hi]:
                val = self.data.get(k, v)
                if val is None:
                    continue
                acc += len(k) + len(val)
                if acc * 2 >= total:
                    if k > req.begin:
                        split_key = k
                    break
        req.reply.send((total, split_key))

    def _remove_shard(self, req) -> None:
        self.shards.set_range(req.begin, req.end, ("absent", 0))
        self.data.clear_range(req.begin, req.end, self.version)
        if self.engine is not None:
            self._queue_durable(self.version, 1, req.begin, req.end)
        if req.reply is not None:      # None: sent one way
            req.reply.send(None)

    async def _serve_shards(self, stream, handler) -> None:
        """A data-distribution stream: each request after a pull to what
        every log holds (the reference's pull loop keeps the version that
        current), an async handler as an actor of its own."""
        is_async = inspect.iscoroutinefunction(handler)
        async for req in stream.queue:
            self._reaches(self.log_system.durable_version()
                          if self.log_system is not None else 0)
            if is_async:
                self._process.spawn(handler(req), f"{self.id}.shards")
            else:
                handler(req)

    def _park(self, req, handler) -> None:
        async def later():
            await delay(float(server_knobs().STORAGE_FUTURE_VERSION_TIMEOUT))
            handler(req)
        task = self._process.spawn(later(), f"{self.id}.parked")
        self._parked.add(task)
        task.on_ready(lambda _f: self._parked.discard(task))

    def run(self, process) -> list:
        """Register the interface's streams on `process` and spawn the
        get_value and get_key_values servers and the waitFailure holder
        there; their futures."""
        self._process = process
        for stream in self.interface.streams():
            process.register(stream)
        i = self.interface
        return [
            process.spawn(self._serve(i.get_value, self.get_value),
                          f"{self.id}.getValue"),
            process.spawn(self._serve(i.get_key_values,
                                      self.get_key_values),
                          f"{self.id}.getKeyValues"),
            process.spawn(self._serve_shards(i.fetch_keys, self._fetch_keys),
                          f"{self.id}.fetchKeys"),
            process.spawn(self._serve_shards(i.fetch_shard,
                                             self._fetch_shard),
                          f"{self.id}.fetchShard"),
            process.spawn(self._serve_shards(i.shard_metrics,
                                             self._shard_metrics),
                          f"{self.id}.shardMetrics"),
            process.spawn(self._serve_shards(i.remove_shard,
                                             self._remove_shard),
                          f"{self.id}.removeShard"),
            process.spawn(self._serve_shards(i.migrate_engine,
                                             self._migrate_engine),
                          f"{self.id}.migrateEngine"),
            process.spawn(hold_wait_failure(i.wait_failure),
                          f"{self.id}.waitFailure")]
