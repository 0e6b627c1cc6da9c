"""StorageServer: versioned in-memory storage replica (trimmed copy of
foundationdb_tpu/server/storage.py).

Reference: fdbserver/storageserver.actor.cpp -- serves reads at versions
inside the MVCC window from a versioned map (:331-362), pulls mutations
for its tag from the TLogs (update :3626), answers getValueQ (:1228) /
getKeyValuesQ (:1929) after waiting for the requested version, and trims
old versions as the window advances.  The versioned map mirrors
fdbclient/VersionedMap.h:624 semantics (per-key version chains with
tombstones) in a bisect-sorted dict.

Kept: VersionedMap whole, with one range-scan form (the reference's
STORAGE_VECTORIZED_SCAN loop, whose rows equal its plain loop's); the
role's mutation apply (sets, clears, atomics resolved at apply time); the
body of the pull loop as pull_step() (peek this server's tag, apply,
advance, forget history below the window, pop: the role is memory-only,
so applied is durable); _wait_for_version, which pulls until it reaches
the version, else raises future_version, and raises transaction_too_old
below the window; the point and range reads; and load(), which fills the
map at the recovery version as from_engine fills it from its engine.

Left out: the durable engine (_update_storage_loop, from_engine,
kvstore.py), watches, fetch and disown of shards and the shard
availability map, read heat and tag sampling, the shard metrics cache,
TSS, and the commit-debug trace points.
"""

from __future__ import annotations

import bisect
import heapq
from typing import Dict, List, Optional, Tuple

from ..core.error import FdbError, err
from ..core.knobs import server_knobs
from ..core.trace import Severity, TraceEvent
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


class StorageServer:
    def __init__(self, ss_id: str, tag: Tag, log_system,
                 recovery_version: Version = 0) -> None:
        self.id = ss_id
        self.tag = tag
        self.log_system = log_system    # LogSystemClient
        self.data = VersionedMap()
        self.version: Version = recovery_version
        self.oldest_version: Version = recovery_version
        # The peek cursor: the next version to ask the log for.
        self._fetch_from: Version = recovery_version + 1
        self.stats = {"mutations": 0}

    def load(self, keys, values) -> None:
        """Fill this (empty) replica with sorted `keys` and their `values`
        at its recovery version, as from_engine fills it from its engine
        (storage.py:407-408)."""
        self.data.load(keys, values, self.version)

    # -- mutation ingestion (reference update :3626) -------------------------
    def _apply(self, m: Mutation, version: Version) -> None:
        """Apply one pulled mutation (the reference's _apply_direct; its
        _apply's buffering of fetching ranges and disownment fences have
        no counterpart here)."""
        self.stats["mutations"] += 1
        if m.type == MutationType.SetValue:
            self.data.set(m.param1, m.param2, version)
        elif m.type == MutationType.ClearRange:
            self.data.clear_range(m.param1, m.param2, version)
        elif m.type in ATOMIC_OPS:
            existing = self.data.latest(m.param1)
            result = apply_atomic(m.type, existing, m.param2)
            self.data.set(m.param1, result, version)
        else:
            TraceEvent("SSUnknownMutation", Severity.Warn).detail(
                "Type", int(m.type)).log()

    def pull_step(self) -> bool:
        """One pass of the update actor's loop (_pull_loop :514-562): peek
        this server's tag from the cursor, apply what came back, advance
        past empty versions too, forget history below the MVCC window and
        pop the log (memory-only: applied is durable).  True if the
        version moved."""
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
            self.log_system.pop(self.tag, new_version)
        self._fetch_from = reply.end
        return moved

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

