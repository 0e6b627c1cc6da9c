"""WriteMap: a transaction's uncommitted writes, merged into its reads
(a copy of foundationdb_tpu/client/writemap.py).

Reference: fdbclient/WriteMap.h + RYWIterator.cpp — the read-your-writes
cache.  Every mutation the transaction issues is kept in issue order; reads
replay the per-key suffix of operations on top of the snapshot value.  A
ClearRange acts as a barrier: operations after it apply on top of None.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from ..txn.atomic import apply_atomic
from ..txn.types import ATOMIC_OPS, Mutation, MutationType


class WriteMap:
    def __init__(self) -> None:
        # The ordered mutation log (what commit sends).
        self.mutations: List[Mutation] = []
        # key -> [(seq, type, param2)] point ops in issue order.
        self._key_ops: Dict[bytes, List[Tuple[int, MutationType, bytes]]] = {}
        # [(seq, begin, end)] clear ranges in issue order.
        self._clears: List[Tuple[int, bytes, bytes]] = []

    def __len__(self) -> int:
        return len(self.mutations)

    # -- recording -----------------------------------------------------------
    def set(self, key: bytes, value: bytes) -> None:
        self._add(Mutation(MutationType.SetValue, key, value))

    def clear(self, begin: bytes, end: bytes) -> None:
        self._add(Mutation(MutationType.ClearRange, begin, end))

    def atomic_op(self, op: MutationType, key: bytes, operand: bytes) -> None:
        assert op in ATOMIC_OPS, op
        self._add(Mutation(op, key, operand))

    def _add(self, m: Mutation) -> None:
        seq = len(self.mutations)
        self.mutations.append(m)
        if m.type == MutationType.ClearRange:
            self._clears.append((seq, m.param1, m.param2))
        else:
            self._key_ops.setdefault(m.param1, []).append(
                (seq, m.type, m.param2))

    # -- read merging --------------------------------------------------------
    def _last_clear_seq(self, key: bytes) -> int:
        last = -1
        for seq, b, e in self._clears:
            if b <= key < e:
                last = seq
        return last

    def has_writes(self, key: bytes) -> bool:
        return key in self._key_ops or self._last_clear_seq(key) >= 0

    def needs_base(self, key: bytes) -> bool:
        """True if merging this key's ops requires the snapshot value (an
        atomic-op chain with no Set/Clear barrier below it)."""
        clear_seq = self._last_clear_seq(key)
        ops = [o for o in self._key_ops.get(key, []) if o[0] > clear_seq]
        if clear_seq >= 0 and not ops:
            return False
        if not ops:
            return True       # no writes at all: value IS the base
        return ops[0][1] != MutationType.SetValue and clear_seq < 0

    def merge(self, key: bytes, base: Optional[bytes]) -> Optional[bytes]:
        """Value as seen by this transaction, given snapshot value `base`."""
        from ..core.error import err
        clear_seq = self._last_clear_seq(key)
        val = None if clear_seq >= 0 else base
        for seq, typ, param2 in self._key_ops.get(key, []):
            if seq <= clear_seq:
                continue
            if typ == MutationType.SetValue:
                val = param2
            elif typ in (MutationType.SetVersionstampedKey,
                         MutationType.SetVersionstampedValue):
                # The final key/value is unknown until commit (reference
                # RYW raises accessed_unreadable for these).
                raise err("accessed_unreadable")
            else:
                val = apply_atomic(typ, val, param2)
        return val

    def touched_keys_in(self, begin: bytes, end: bytes) -> List[bytes]:
        """All point-written keys within [begin, end)."""
        return sorted(k for k in self._key_ops if begin <= k < end)

    def clears_in(self, begin: bytes, end: bytes
                  ) -> List[Tuple[int, bytes, bytes]]:
        return [(s, max(b, begin), min(e, end))
                for s, b, e in self._clears if b < end and begin < e]

    def is_unreadable(self, key: bytes) -> bool:
        """True when this txn's ops make `key` unreadable (a versionstamped
        op whose result is unknown until commit) — checked before any
        storage round-trip."""
        clear_seq = self._last_clear_seq(key)
        return any(typ in (MutationType.SetVersionstampedKey,
                           MutationType.SetVersionstampedValue)
                   for seq, typ, _p in self._key_ops.get(key, [])
                   if seq > clear_seq)

    def write_conflict_ranges(self) -> List[Tuple[bytes, bytes]]:
        """Minimal covering ranges of all mutations (point -> [k, k+\\0)).

        A SetVersionstampedKey's final key is unknown until commit; its
        conflict range covers EVERY possible stamp in the 10-byte slot
        (reference getVersionstampKeyRange) — guarding the placeholder
        template instead would let a concurrent reader of the formed key
        commit without conflicting."""
        from ..txn.types import key_after
        out = []
        for m in self.mutations:
            if m.type == MutationType.ClearRange:
                if m.param1 < m.param2:
                    out.append((m.param1, m.param2))
            elif m.type == MutationType.SetVersionstampedKey:
                body = m.param1[:-4]
                off = int.from_bytes(m.param1[-4:], "little")
                lo = body[:off] + b"\x00" * 10 + body[off + 10:]
                hi = body[:off] + b"\xff" * 10 + body[off + 10:]
                out.append((lo, key_after(hi)))
            else:
                out.append((m.param1, key_after(m.param1)))
        return out
