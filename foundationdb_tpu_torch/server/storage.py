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

Left out: the update-storage loop's delay, buggify and engine
migration, watches, fetch and disown of shards and the shard
availability map, read heat and tag sampling, the shard metrics cache,
TSS, and the commit-debug trace points.
"""

from __future__ import annotations

import bisect
import heapq
from time import perf_counter
from typing import Dict, List, Optional, Tuple

from ..core.error import FdbError, err
from ..core.knobs import server_knobs
from ..core.trace import Severity, TraceEvent
from ..core.wire import Reader, Writer
from ..txn.atomic import apply_atomic
from ..txn.types import ATOMIC_OPS, Mutation, MutationType, Version
from .interfaces import (GetKeyValuesReply, GetKeyValuesRequest,
                         GetValueReply, GetValueRequest, Tag)


class VersionedMap:
    """Per-key version chains with tombstones (None = cleared)."""

    def __init__(self) -> None:
        self._keys: List[bytes] = []
        self._chains: Dict[bytes, List[Tuple[Version, Optional[bytes]]]] = {}
        # GC work queue: (version, key) pushed when a chain grows history or
        # a tombstone lands; forget_before only revisits these chains, so GC
        # is amortized O(1) per mutation instead of O(total keys) per call.
        self._gc_heap: List[Tuple[Version, bytes]] = []

    def _chain(self, key: bytes) -> List[Tuple[Version, Optional[bytes]]]:
        c = self._chains.get(key)
        if c is None:
            c = self._chains[key] = []
            bisect.insort(self._keys, key)
        return c

    def set(self, key: bytes, value: Optional[bytes],
            version: Version) -> None:
        c = self._chain(key)
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

    def clear_range(self, begin: bytes, end: bytes, version: Version) -> None:
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        for key in self._keys[lo:hi]:
            c = self._chains[key]
            if c and c[-1][1] is not None:
                self.set(key, None, version)

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

    def forget_before(self, version: Version) -> None:
        """Drop history below `version`; keys whose only state is an old
        tombstone disappear entirely (reference forgetVersionsBefore).
        Only chains with queued GC work are visited (amortized; mirrors the
        reference SkipList's lazy removeBefore)."""
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
                j = bisect.bisect_left(self._keys, key)
                del self._keys[j]

    def __len__(self) -> int:
        return len(self._keys)


# The engine's identity record: above every shard-map range end.
_META_KEY = b"\xff\xff/storageMeta"


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
        """Fill this (empty) replica with sorted `keys` and their `values`
        at its recovery version, as from_engine fills it from its engine
        (storage.py:407-408), and image the engine there."""
        self.data.load(keys, values, self.version)
        if self.engine is not None:
            self._image_engine(self.engine, self.version)

    # -- mutation ingestion (reference update :3626) -------------------------
    def _apply(self, m: Mutation, version: Version) -> None:
        """Apply one pulled mutation (the reference's _apply_direct; its
        _apply's buffering of fetching ranges and disownment fences have
        no counterpart here)."""
        self.stats["mutations"] += 1
        if m.type == MutationType.SetValue:
            self.data.set(m.param1, m.param2, version)
            if self.engine is not None:
                self._queue_durable(version, 0, m.param1, m.param2)
        elif m.type == MutationType.ClearRange:
            self.data.clear_range(m.param1, m.param2, version)
            if self.engine is not None:
                self._queue_durable(version, 1, m.param1, m.param2)
        elif m.type in ATOMIC_OPS:
            existing = self.data.latest(m.param1)
            result = apply_atomic(m.type, existing, m.param2)
            self.data.set(m.param1, result, version)
            if self.engine is not None:
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
        """One pass of _update_storage_loop (:564-629), with no delay, no
        buggify and no engine migration: the pending mutations up to the
        target version and the meta key into the engine, its commit, then
        durable_version moves to the target and the log is popped to it.
        The target is the applied version, capped at the version durable
        on every TLog of the log system (the reference takes the applied
        version: a version one log appended and another lost can reach
        its engine, and a later recovery ends below it, where the rebuilt
        server has no history to roll back to).  True if the durable
        version moved."""
        if self.engine is None:
            return False
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

    def get_value(self, req: GetValueRequest) -> None:
        try:
            self._wait_for_version(req.version)
        except FdbError as e:   # errors travel in the reply
            req.reply.send_error(e)
            return
        value = self.data.get(req.key, req.version)
        req.reply.send(GetValueReply(value=value, version=req.version))

    def get_key_values(self, req: GetKeyValuesRequest) -> None:
        try:
            self._wait_for_version(req.version)
        except FdbError as e:
            req.reply.send_error(e)
            return
        data, more = self.data.range_read(
            req.begin, req.end, req.version, req.limit, req.limit_bytes,
            req.reverse)
        req.reply.send(GetKeyValuesReply(data=data, more=more,
                                         version=req.version))

