"""Entry points on the port (the counterparts of __graft_entry__.py).

entry()            -- the conflict window's batched query, window_query
                      (conflict/window.py), with its arguments at the
                      reference's shapes: a 2^12 window, 256 point queries
                      of 16-byte keys, seed 0.
dryrun_multichip() -- the sharded resolver (ShardedTorchConflictSet) over
                      an n-device mesh on tiny shapes, four batches across
                      a shard-local merge, each held against the oracle.

Both run on `cuda` unless the caller names another device; with none
named and no card present they raise.  On one card the mesh names `cuda`
n times: the shards share it, as the reference's dry run lays its shards
on virtual devices of one host.
"""

from __future__ import annotations

import numpy as np

CAPACITY = 1 << 12
N_QUERIES = 256
KEY_BYTES = 16


def entry(device=None):
    """(window_query, args): call window_query(*args) for the conflict
    bits (int32 0/1 [256]) of 256 point reads at snapshot 0 against a
    fresh window."""
    import torch

    from .conflict.window import (make_window_state, resolve_device,
                                  window_query)
    from .ops.digest import encode_keys, planar_to_rows

    device = resolve_device(device)
    state = make_window_state(CAPACITY, 0, device)
    rng = np.random.default_rng(0)
    keys = [bytes(rng.integers(0, 256, size=KEY_BYTES, dtype=np.uint8))
            for _ in range(N_QUERIES)]
    qb = torch.from_numpy(planar_to_rows(encode_keys(keys))).to(device)
    qe = torch.from_numpy(planar_to_rows(encode_keys(
        [k + b"\x00" for k in keys], round_up=True))).to(device)
    snap = torch.zeros((N_QUERIES,), dtype=torch.int32, device=device)
    valid = torch.ones((N_QUERIES,), dtype=torch.int32, device=device)
    return window_query, (state.bk, state.bv, qb, qe, snap, valid)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """ShardedTorchConflictSet over a mesh of n_devices entries of
    `device`: 4 batches of 12 random point txns and one range txn that
    straddles the shards' splits, each batch's verdicts equal to the
    oracle's (AssertionError otherwise)."""
    from .conflict.oracle import OracleConflictSet
    from .conflict.window import resolve_device
    from .parallel import ShardedTorchConflictSet, make_conflict_mesh
    from .txn.types import CommitTransactionRef, KeyRange

    device = resolve_device(device)
    mesh = make_conflict_mesh([device] * n_devices)
    cs = ShardedTorchConflictSet(mesh, 0, capacity=1 << 9,
                                 delta_capacity=1 << 8,
                                 gc_interval_batches=2)
    oracle = OracleConflictSet(0)
    rng = np.random.default_rng(42)

    now = 0
    for _ in range(4):    # 4 batches: crosses a shard-local merge
        now += 1_000_000
        batch = []
        for _ in range(12):
            # Random leading byte: keys land on every shard.
            k = bytes(rng.integers(0, 256, size=6, dtype=np.uint8))
            tr = CommitTransactionRef(
                read_snapshot=max(now - int(rng.integers(0, 3_000_000)), 0))
            tr.read_conflict_ranges.append(KeyRange(k, k + b"\x00"))
            tr.write_conflict_ranges.append(KeyRange(k, k + b"\x00"))
            batch.append(tr)
        batch.append(CommitTransactionRef(
            read_snapshot=max(now - 1_500_000, 0),
            read_conflict_ranges=[KeyRange(b"\x10", b"\xf0")],
            write_conflict_ranges=[KeyRange(b"\x20", b"\xe0")]))
        got = cs.resolve(batch, now, now - 5_000_000)
        want = oracle.resolve(batch, now, now - 5_000_000)
        assert got == want, "sharded resolve diverged from the oracle"
    cs.synchronize()
