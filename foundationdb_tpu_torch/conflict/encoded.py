"""Columnar pre-encoded commit batches for the conflict backends.

The reference resolver receives serialized CommitTransactionRef arrays and
iterates them in C++ (fdbserver/Resolver.actor.cpp:160 addTransaction); a
Python per-transaction loop at 100K-txn batch sizes costs more than the
device resolve itself.  EncodedBatch is the zero-loop alternative: the batch
is held as flat numpy columns (txn index per range + digest arrays), built
either vectorially by bulk producers (bench.py, a batched proxy path) or by
the compatibility loop from_transactions() for small role-driven batches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..ops.digest import KEY_LANES, encode_keys
from ..txn.types import CommitTransactionRef


@dataclass
class EncodedBatch:
    """One commit batch in columnar form.

    r_/w_ arrays are parallel: range i of the batch belongs to transaction
    ``*_txn[i]`` and spans digest interval [``*_begin[i]``, ``*_end[i]``).
    Empty ranges (begin >= end) must already be dropped.

    Digest lanes 0..SALT_LANES-1 are the TENANT-SALT COLUMN (the first 8
    key bytes — for tenant-prefixed keys, exactly the tenant's fixed-width
    id from tenant/map.py); the remaining lanes digest the tenant-relative
    tail.  See ops/digest.py."""

    n_txns: int
    t_snap: np.ndarray        # int64[n_txns]  absolute read snapshots
    t_has_reads: np.ndarray   # bool[n_txns]
    r_txn: np.ndarray         # int32[NR]
    r_begin: np.ndarray       # uint32[8, NR]  (planar, ops/digest.py)
    r_end: np.ndarray         # uint32[8, NR]
    w_txn: np.ndarray         # int32[NW]
    w_begin: np.ndarray       # uint32[8, NW]
    w_end: np.ndarray         # uint32[8, NW]
    # True iff EVERY conflict range is a single key [k, k+\x00) with
    # len(k) <= PREFIX_BYTES (untruncated digest; tenant prefix + up to 23
    # relative bytes fits).  Lets the device use the point fast path
    # (fused.py make_resolve_step all_point) — same verdicts, ~10x cheaper
    # intra-batch rounds.  False is always safe.
    all_point: bool = False

    @property
    def n_ranges(self) -> int:
        return int(self.r_txn.shape[0] + self.w_txn.shape[0])

    @property
    def r_salt(self) -> np.ndarray:
        """Tenant-salt column of the read-range begins: uint32[2, NR]."""
        from ..ops.digest import SALT_LANES
        return self.r_begin[:SALT_LANES]

    @property
    def w_salt(self) -> np.ndarray:
        """Tenant-salt column of the write-range begins: uint32[2, NW]."""
        from ..ops.digest import SALT_LANES
        return self.w_begin[:SALT_LANES]

    @classmethod
    def from_transactions(cls, transactions: Sequence[CommitTransactionRef]
                          ) -> "EncodedBatch":
        n = len(transactions)
        r_bk, r_ek, r_txn = [], [], []
        w_bk, w_ek, w_txn = [], [], []
        t_snap = np.empty((n,), dtype=np.int64)
        t_has = np.empty((n,), dtype=bool)
        all_point = True
        from ..ops.digest import PREFIX_BYTES
        for t, tr in enumerate(transactions):
            t_snap[t] = tr.read_snapshot
            t_has[t] = bool(tr.read_conflict_ranges)
            for r in tr.read_conflict_ranges:
                if r.begin < r.end:
                    r_bk.append(r.begin)
                    r_ek.append(r.end)
                    r_txn.append(t)
                    if (r.end != r.begin + b"\x00"
                            or len(r.begin) > PREFIX_BYTES):
                        all_point = False
            for w in tr.write_conflict_ranges:
                if w.begin < w.end:
                    w_bk.append(w.begin)
                    w_ek.append(w.end)
                    w_txn.append(t)
                    if (w.end != w.begin + b"\x00"
                            or len(w.begin) > PREFIX_BYTES):
                        all_point = False
        empty_d = np.empty((KEY_LANES, 0), dtype=np.uint32)
        return cls(
            n_txns=n, t_snap=t_snap, t_has_reads=t_has,
            r_txn=np.asarray(r_txn, dtype=np.int32),
            r_begin=encode_keys(r_bk) if r_bk else empty_d,
            r_end=encode_keys(r_ek, round_up=True) if r_ek else empty_d,
            w_txn=np.asarray(w_txn, dtype=np.int32),
            w_begin=encode_keys(w_bk) if w_bk else empty_d,
            w_end=encode_keys(w_ek, round_up=True) if w_ek else empty_d,
            all_point=all_point,
        )
