"""Key-range-sharded conflict window over a grid of devices.

The port of foundationdb_tpu/parallel/sharded_window.py.  The reference
scales conflict resolution by partitioning the keyspace across resolvers
and min-combining their verdicts at the proxy
(CommitProxyServer.actor.cpp:152-181 fan-out, :800-806 min-combine); the
accelerator formulation shards the same axis inside ONE resolver:

  * the digest space is split into D contiguous sub-ranges, one per row of
    the device grid (mesh axis "kr");
  * each shard holds a full window (conflict/window.py) restricted to its
    sub-range: inserts are CLIPPED to the owned range, so V_d(k) == V(k)
    exactly for k in shard d;
  * a batch query is clipped per shard, answered locally, and the partial
    conflict bits are OR-combined over "kr";
  * the query batch itself is split over the grid's columns (axis "q").

How the mesh maps onto PyTorch.  The reference is single-controller: one
process drives every device of a jax Mesh through shard_map.  The port is
too.  A ConflictMesh is a (kr, q) grid of torch.devices; shard d's state
lives on its grid device as its own tensors, and each collective becomes a
combine on the grid's first device: one kernel reads every shard's
partial where it lies and reduces them (ops/shard.py shard_combine; a
partial on another card is copied there first, non-blocking), and the
result goes back to the shards that need it.  A grid may name one
device several times: that is how four shards share one card, as the
reference's tests lay eight virtual devices on one host CPU.  No process
group is used: the reference has one controller, and NCCL refuses two
ranks on one GPU.

The reference's shard_map_compat and jit_sharded are JAX glue (shard_map
across jax versions, jit with donation) and have no counterpart here:
PyTorch runs eagerly and the port updates its state in place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..conflict.window import (WindowState, make_window_state,
                               window_gc, window_insert, window_query,
                               window_state_to_numpy)
from ..ops.digest import KEY_LANES, MAX_DIGEST, planar_to_rows, planar_to_s24
from ..ops.shard import clip_rows, shard_combine, shard_commit


def default_mesh_axes(n_devices: int) -> Tuple[int, int]:
    """Factor n into (kr, q): prefer up to 4 key-range shards, rest data."""
    kr = 1
    while kr < 4 and (n_devices % (kr * 2)) == 0:
        kr *= 2
    return kr, n_devices // kr


def _indexed(device) -> torch.device:
    """torch.device(device), with a CUDA device's index made explicit (the
    device a tensor reports), so that equal devices compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class ConflictMesh:
    """A (kr, q) grid of torch.devices: row d holds key-range shard d, its
    columns split the query batch.  `shape` is {"kr": ..., "q": ...}, as
    jax.sharding.Mesh's.  A device may appear more than once."""

    axis_names = ("kr", "q")

    def __init__(self, grid: Sequence[Sequence]) -> None:
        self.devices: List[List[torch.device]] = [
            [_indexed(d) for d in row] for row in grid]
        self.shape = {"kr": len(self.devices), "q": len(self.devices[0])}

    @property
    def lead(self) -> torch.device:
        """The grid's first device, where the combines run."""
        return self.devices[0][0]


def make_conflict_mesh(devices: Optional[Sequence] = None,
                       n_devices: Optional[int] = None) -> ConflictMesh:
    """A ConflictMesh over `devices` (every visible CUDA card when None;
    raises when there is none, never falls back to the CPU), the first
    n_devices of them when given, shaped by default_mesh_axes."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("make_conflict_mesh: no CUDA device is "
                               "available; pass devices=[...] to name them")
        devices = [f"cuda:{i}" for i in range(count)]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    kr, q = default_mesh_axes(len(devices))
    return ConflictMesh([devices[r * q:(r + 1) * q] for r in range(kr)])


def digest_splits(n_shards: int) -> np.ndarray:
    """uint32[n+1, 8] split points: shard d owns digest range [s[d], s[d+1]).

    Even splits of the first lane; the last split is the MAX_DIGEST sentinel
    (strictly above every real key digest)."""
    splits = np.zeros((n_shards + 1, KEY_LANES), dtype=np.uint32)
    for d in range(1, n_shards):
        splits[d, 0] = np.uint32((d * (1 << 32)) // n_shards)
    splits[n_shards] = MAX_DIGEST
    return splits


def splits_from_sample(sample_digests: np.ndarray,
                       n_shards: int) -> np.ndarray:
    """Equi-depth split points from a planar digest sample (uint32[8, N])
    -> uint32[n+1, 8], the `splits=` input of ShardedTorchConflictSet.

    Even lane-0 cuts balance only keyspaces spread across the first four
    key bytes; keys that share a long prefix (every bench key starts
    b"k0000...") land on one shard.  Cut at the sample's d/n quantiles over
    full-width digests instead (the resolver key-range analog of the
    reference's load-driven resolutionBalancing)."""
    s = np.sort(planar_to_s24(sample_digests))
    splits = np.zeros((n_shards + 1, KEY_LANES), dtype=np.uint32)
    for d in range(1, n_shards):
        q = s[min(s.size - 1, (d * s.size) // n_shards)]
        splits[d] = np.frombuffer(q, dtype=">u4").astype(np.uint32)
    splits[n_shards] = MAX_DIGEST
    return splits


def split_rows(splits: np.ndarray) -> torch.Tensor:
    """uint32[n+1, 8] split points as rows int32[n+1, 8] (same bits)."""
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(splits, dtype=np.uint32)).view(
            np.int32))


def on_device(x, device: torch.device, rows: bool = False) -> torch.Tensor:
    """A batch input on `device`: a tensor as it is (rows int32[N, 8] for
    digests; booleans become int32), or host numpy in the reference's
    layout (digests planar uint32[8, N])."""
    if not isinstance(x, torch.Tensor):
        x = planar_to_rows(x) if rows else np.asarray(x).astype(np.int32)
        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.dtype != torch.int32:
        x = x.to(torch.int32)
    return x.to(device, non_blocking=True)


class ShardedWindow:
    """A conflict window sharded over mesh axis "kr" (reference
    parallel/sharded_window.py:120).

    Shard d holds a window of `capacity` boundaries (bk int32[CAP, 8] rows,
    bv int32[CAP], size int32[1]) over its digest range [splits[d],
    splits[d+1]), starting with one segment at its lower split at version
    0.  As the reference's P("kr") replicates a shard over "q", each
    distinct device of row d holds a copy; where the row repeats one
    device, one copy serves.  impl="plain" runs every wrapper's plain-torch
    version (to compare with the kernels on the card)."""

    def __init__(self, mesh: ConflictMesh, capacity: int = 1 << 14,
                 impl: Optional[str] = None) -> None:
        assert "kr" in mesh.axis_names and "q" in mesh.axis_names
        self.mesh = mesh
        self.capacity = capacity
        self.impl = impl
        self.n_shards = mesh.shape["kr"]
        self.splits = digest_splits(self.n_shards)
        rows = split_rows(self.splits)
        # replicas[d][device] = (WindowState, (lo, hi) rows on device)
        self.replicas: List[Dict[torch.device, tuple]] = []
        for d, row in enumerate(mesh.devices):
            reps = {}
            for dev in row:
                if dev not in reps:
                    lo, hi = rows[d].to(dev), rows[d + 1].to(dev)
                    reps[dev] = (make_window_state(capacity, 0, dev, lo),
                                 (lo, hi))
            self.replicas.append(reps)

    def _spans(self, d: int, chunk: int):
        """(device, begin, end) of each run of consecutive query chunks that
        row d's grid assigns to one device."""
        spans: List[list] = []
        for j, dev in enumerate(self.mesh.devices[d]):
            if spans and spans[-1][0] == dev:
                spans[-1][2] = (j + 1) * chunk
            else:
                spans.append([dev, j * chunk, (j + 1) * chunk])
        return spans

    def resolve_step(self, qb, qe, qsnap, qvalid, wb, we, wvalid, now_rel):
        """One step: the batched history check, then the insert of the
        writes (reference sharded_window.py:209).

        Queries and writes are host numpy in the reference's layout
        (digests planar uint32[8, N]) or tensors (digests rows int32[N,
        8]); the query count must divide by the mesh's "q".  Returns (bits
        int32[R], overflow int32[1]) on the mesh's first device.  The
        insert is all-or-nothing across the mesh: on overflow every shard
        keeps its pre-insert state, and the caller may gc() and re-issue
        the identical step."""
        lead, impl = self.mesh.lead, self.impl
        inputs: Dict[torch.device, tuple] = {}

        def batch(dev):
            if dev not in inputs:
                inputs[dev] = (on_device(qb, dev, True),
                               on_device(qe, dev, True),
                               on_device(qsnap, dev), on_device(qvalid, dev),
                               on_device(wb, dev, True),
                               on_device(we, dev, True),
                               on_device(wvalid, dev))
            return inputs[dev]

        n_q = batch(lead)[0].shape[0]
        assert n_q % self.mesh.shape["q"] == 0, \
            "the query count must divide by the mesh's q axis"
        chunk = n_q // self.mesh.shape["q"]
        # Query: clip to each shard, answer locally, OR-combine over kr.
        # A shard's partial is its spans' bits in query order: as they are
        # when its queries run on one device, else joined on the lead.
        parts = []
        for d in range(self.n_shards):
            spans = []
            for dev, a, b in self._spans(d, chunk):
                st, (lo, hi) = self.replicas[d][dev]
                q_b, q_e, q_snap, q_valid = batch(dev)[:4]
                cqb, cqe, qv, _ = clip_rows(q_b[a:b], q_e[a:b], lo, hi,
                                            valid=q_valid[a:b], impl=impl)
                spans.append(window_query(st.bk, st.bv, cqb, cqe,
                                          q_snap[a:b], qv, impl=impl))
            parts.append(spans[0] if len(spans) == 1 else torch.cat(
                [s.to(lead, non_blocking=True) for s in spans]))
        bits = shard_combine(parts, out=torch.empty(
            (n_q,), dtype=torch.int32, device=lead), impl=impl)
        # Insert: clip the writes to each shard, merge locally, keeping a
        # copy of the pre-insert state for the all-or-nothing commit.
        inserted = []
        for d in range(self.n_shards):
            for dev, (st, (lo, hi)) in self.replicas[d].items():
                w_b, w_e, w_valid = batch(dev)[4:]
                saved = WindowState(st.bk.clone(), st.bv.clone(),
                                    st.size.clone())
                cwb, cwe, wv, _ = clip_rows(w_b, w_e, lo, hi, valid=w_valid,
                                            impl=impl)
                _, ovf = window_insert(st, cwb, cwe, wv, now_rel, impl=impl)
                inserted.append((st, saved, ovf))
        # If ANY shard overflowed, every shard keeps its pre-insert state:
        # otherwise a skewed batch would commit its writes on the shards
        # that had room only, leaving V(k) wrong on part of the keyspace.
        ovf_any = shard_combine([ovf for _, _, ovf in inserted],
                                out=torch.empty((1,), dtype=torch.int32,
                                                device=lead), impl=impl)
        for st, saved, _ in inserted:
            shard_commit(ovf_any.to(st.bk.device, non_blocking=True), saved,
                         st, impl=impl)
        return bits, ovf_any

    def gc(self, oldest_rel: int, rebase_delta: int = 0) -> None:
        """removeBefore(oldest) and the version rebase on every shard
        (reference sharded_window.py:226)."""
        for reps in self.replicas:
            for st, _ in reps.values():
                window_gc(st, oldest_rel, rebase_delta, impl=self.impl)

    def shard_states(self) -> List[WindowState]:
        """Each shard's window (its first copy)."""
        return [next(iter(reps.values()))[0] for reps in self.replicas]

    def shard_sizes(self) -> List[int]:
        """Live boundary count per shard (syncs the device)."""
        return [int(st.size[0]) for st in self.shard_states()]

    def state_to_numpy(self):
        """(bk uint32[D, 8, CAP] planar, bv int32[D, CAP], size int32[D]):
        the reference's stacked layout of its sharded state."""
        parts = [window_state_to_numpy(st) for st in self.shard_states()]
        return (np.stack([p[0] for p in parts]),
                np.stack([p[1] for p in parts]),
                np.asarray([p[2] for p in parts], dtype=np.int32))
