"""The resolve step sharded over a device grid (BASELINE config 5).

The port of foundationdb_tpu/parallel/sharded_resolver.py: the backend's
per-batch programs -- too-old, the two-tier history probe, the intra-batch
fixpoint, the clipped insert, the codes, the sticky overflow flag -- with
the conflict window key-range-sharded over the "kr" rows of a ConflictMesh
(parallel/sharded_window.py).  The reference shards the same program with
shard_map and combines the per-txn history bits by one pmax over "kr",
the device-side analog of the proxy's min-combine across resolvers
(CommitProxyServer.actor.cpp:800-806).

Per shard d, as separate tensors on its grid device (the reference's
leading shard axis):

    bk/bv/table/size     base boundaries, all inside [splits[d], splits[d+1])
    dk/dv/dtable/dsize   delta tier, its covering boundary at splits[d]
    flag                 the shard's sticky overflow flag
    lo, hi               the shard's digest bounds (rows int32[8])

A batch runs as the three halves of conflict/fused.py's steps:

  1. history, per shard: the batch is replicated (on the compact path it
     is unpacked once per device, and the device's shards share it); each
     shard clips the reads (the unique keys on the compact path) to its
     bounds and probes its own window, so V_d(k) == V(k) for every owned k;
  2. one combine (ops/shard.py shard_combine) of the history bits by max
     on the grid's first device, then the fixpoint and the codes ONCE
     there (the reference runs this replicated and batch-local part on
     every shard with identical results; the port counts its Jacobi
     rounds once);
  3. insert, per shard: the surviving writes clipped to the shard, then
     one combine of the reply tails: flag and delta size by max, base
     size by sum.

Merges are shard-local (no combine at all): each shard overlays, GCs and
rebases its own tiers, and resets its delta to start at its lower split.
CAP and DCAP are PER SHARD: D shards hold D * CAP boundaries.  The host's
scheduling (merge cadence, delta bound, rebase) is TorchConflictSet's: a
batch's writes may all land on one shard, so the per-shard delta budget
is the global bound, as in the reference.

`ShardedTorchConflictSet.supervised` puts the set under the supervision
layer of conflict/supervisor.py, as the reference's does.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from ..conflict import fused
from ..conflict.torch_backend import TorchConflictSet
from ..conflict.window import make_window_state
from ..ops.digest import KEY_LANES, planar_to_rows, rows_to_planar
from ..ops.rangemax import NEG_INF, build_sparse_table
from ..ops.shard import shard_combine
from .sharded_window import ConflictMesh, digest_splits, split_rows


class Shard:
    """One key-range shard's device state (see the module docstring)."""

    def __init__(self, device: torch.device, lo: torch.Tensor,
                 hi: torch.Tensor) -> None:
        self.device = device
        self.lo, self.hi = lo, hi
        self.bk = self.bv = self.table = self.size = None
        self.dk = self.dv = self.dtable = self.dsize = self.flag = None

    @property
    def bounds(self):
        return self.lo, self.hi


def _on(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return x if x.device == device else x.to(device, non_blocking=True)


class ShardedTorchConflictSet(TorchConflictSet):
    """TorchConflictSet whose window state is key-range-sharded over the
    mesh's "kr" rows (reference ShardedTpuConflictSet).

    Same public API and host-side scheduling as the one-device backend;
    `capacity` and `delta_capacity` are PER SHARD.  splits: uint32[D+1, 8]
    ascending digest cuts (row 0 all zero, the last MAX_DIGEST); default
    even lane-0 cuts (digest_splits).  Keys that share a long prefix need
    equi-depth cuts (splits_from_sample) or one shard takes the whole
    window.  impl as TorchConflictSet's."""

    def __init__(self, mesh: ConflictMesh, oldest_version=0,
                 capacity: Optional[int] = None,
                 delta_capacity: Optional[int] = None,
                 gc_interval_batches: int = 8,
                 splits: Optional[np.ndarray] = None,
                 impl: Optional[str] = None) -> None:
        assert "kr" in mesh.axis_names, "mesh must carry a 'kr' axis"
        self.mesh = mesh
        self.n_shards = int(mesh.shape["kr"])
        if splits is not None:
            splits = np.asarray(splits, dtype=np.uint32)
            assert splits.shape == (self.n_shards + 1, KEY_LANES), \
                f"splits shape {splits.shape}"
        else:
            splits = digest_splits(self.n_shards)
        self.splits = splits
        rows = split_rows(splits)
        self.shards = [Shard(row[0], rows[d].to(row[0]),
                             rows[d + 1].to(row[0]))
                       for d, row in enumerate(mesh.devices)]
        devices = []
        for sh in self.shards:
            if sh.device not in devices:
                devices.append(sh.device)
        self._devices: List[torch.device] = devices
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        super().__init__(oldest_version, capacity=capacity,
                         delta_capacity=delta_capacity,
                         gc_interval_batches=gc_interval_batches,
                         device=mesh.lead, impl=impl)

    # -- streams: one per distinct CUDA device of the shards ----------------
    def _on_stream(self):
        """Every launch and allocation goes to the backend's stream on each
        device; cross-device copies order themselves against those."""
        stack = contextlib.ExitStack()
        for dev in self._devices:
            if dev.type != "cuda":
                continue
            if dev == self.device:
                self._streams[dev] = self._stream
            elif dev not in self._streams:
                self._streams[dev] = torch.cuda.Stream(dev)
            stack.enter_context(torch.cuda.stream(self._streams[dev]))
        return stack

    def synchronize(self) -> None:
        for stream in self._streams.values():
            stream.synchronize()
        super().synchronize()

    # -- sharded state ------------------------------------------------------
    def _shard_window(self, sh: Shard, cap: int, value: int):
        """One segment over the shard's whole digest range at `value`."""
        return make_window_state(cap, value, sh.device, sh.lo)

    def _reset_state(self, version) -> None:
        self.version_base = version
        with self._on_stream():
            for sh in self.shards:
                sh.bk, sh.bv, sh.size = self._shard_window(sh, self.capacity,
                                                           0)
                sh.table = build_sparse_table(sh.bv, impl=self.impl)
                sh.flag = torch.zeros((1,), dtype=torch.int32,
                                      device=sh.device)
            self._new_delta()
        self._reset_bookkeeping(live_boundaries=self.n_shards)

    def _new_delta(self) -> None:
        for sh in self.shards:
            sh.dk, sh.dv, sh.dsize = self._shard_window(sh, self.d_cap,
                                                        NEG_INF)
            sh.dtable = fused.delta_table_step(sh.dv, impl=self.impl)

    def _refresh_dtable(self) -> None:
        for sh in self.shards:
            fused.delta_table_step(sh.dv, out=sh.dtable, impl=self.impl)

    def _merge_state(self, mstep, scalars) -> None:
        """Shard-local merges; each reset delta starts at its lower split
        (reference sharded_resolver.py:210-232)."""
        for sh in self.shards:
            mstep(sh.bk, sh.bv, sh.table, sh.size, sh.dk, sh.dv, sh.dsize,
                  sh.flag, scalars, sh.lo)

    def _combine(self, parts: List[torch.Tensor],
                 n_max: Optional[int] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The shards' partials reduced by one shard_combine on the grid's
        first device, each read where it lies (one on another device is
        copied there first)."""
        if out is None:
            out = torch.empty((parts[0].shape[0],), dtype=torch.int32,
                              device=self.device)
        return shard_combine(parts, n_max, out=out, impl=self.impl)

    def _run_step(self, enc, host_buf):
        """history per shard (the compact step's unpacking once per device)
        -> combine -> fixpoint and codes once -> insert per shard ->
        combine of the tails -> the delta tables."""
        bufs = {dev: self._device_buf(host_buf, dev) for dev in self._devices}
        t_cap = enc["caps"][0]
        out = torch.empty((t_cap + fused.OUT_EXTRA,), dtype=torch.int8,
                          device=self.device)
        if enc["compact"]:
            step = fused.make_resolve_step_compact(
                self.capacity, self.d_cap, *enc["shapes"], impl=self.impl)
            # The unique keys, too-old and the rank counts are the batch's,
            # not a shard's, so the shards of a device share one unpack;
            # each takes its own zeroed hist.  Nothing after it writes them
            # in place: clip_rows, history_probe, read_write_prep, the
            # fixpoint's codes (resolve) and the point insert only read
            # them.
            units = {dev: step.unpack(bufs[dev], sum(
                sh.device == dev for sh in self.shards))
                for dev in self._devices}
            hists = {dev: iter(u["hists"]) for dev, u in units.items()}
            hs = [step.probe(units[sh.device], sh.bk, sh.table, sh.dk,
                             sh.dtable, sh.bounds, next(hists[sh.device]))
                  for sh in self.shards]
            hist = self._combine([h["rw"]["hist"] for h in hs])
            w_ins = step.resolve(hs[0], hist, out)
        else:
            step = fused.make_resolve_step(self.capacity, self.d_cap,
                                           *enc["caps"], impl=self.impl)
            hs = [step.history(sh.bk, sh.table, sh.dk, sh.dtable,
                               *self._general_views(bufs[sh.device],
                                                    enc["caps"]),
                               sh.bounds)
                  for sh in self.shards]
            hist = self._combine([h["g"]["hist"] for h in hs])
            w_ins = step.resolve(hs[0], hist, out, self.jacobi_rounds)
        tails = []
        for sh, h in zip(self.shards, hs):
            tail = torch.empty((3,), dtype=torch.int32, device=sh.device)
            step.insert(h, sh.dk, sh.dv, sh.dsize, sh.flag, sh.size,
                        _on(w_ins, sh.device), tail)
            tails.append(tail)
        # The reply tail: sticky flag and worst-shard delta size by max
        # (both drive the host's merge scheduling), base size by sum.
        self._combine(tails, n_max=2,
                      out=out[t_cap:].view(torch.int32))
        self._refresh_dtable()
        return out, (bufs, hs)

    # -- introspection ------------------------------------------------------
    def shard_sizes(self) -> List[int]:
        """Live base-boundary count per shard (syncs the device)."""
        self.synchronize()
        return [int(sh.size[0]) for sh in self.shards]

    @classmethod
    def supervised(cls, mesh: ConflictMesh, oldest_version=0, monitor=None,
                   **kwargs):
        """The mesh-sharded backend under the supervision layer
        (conflict/supervisor.py): deadline-budgeted dispatch, health
        monitoring, degrade-to-CPU against the exact mirror, re-probe /
        promotion (the promotion replay rebuilds the whole sharded window
        from the mirror history), and the exact long-key recheck.  The
        first sharded set is built here: one that cannot be built raises
        instead of the supervisor beginning degraded."""
        from ..conflict.supervisor import SupervisedConflictSet

        def make_device(oldest_version=oldest_version):
            return cls(mesh, oldest_version, **kwargs)

        return SupervisedConflictSet(make_device, oldest_version,
                                     monitor=monitor, device=make_device())


# ---------------------------------------------------------------------------
# State carried across backends (numpy, the reference's stacked layout)
# ---------------------------------------------------------------------------

SHARDED_STATE_KEYS = ("bk", "bv", "table", "size", "dk", "dv", "dtable",
                      "dsize", "flag")


def sharded_state_to_numpy(cs: ShardedTorchConflictSet) -> Dict[str, object]:
    """The backend's per-shard state stacked as the reference holds it:
    bk/dk planar uint32[D, 8, N], bv/dv int32[D, N], tables int32[D,
    LOG+1, N], size/dsize/flag int32[D], plus version_base,
    oldest_version and d_cap."""
    cs.synchronize()
    out: Dict[str, object] = {}
    for k in SHARDED_STATE_KEYS:
        arrs = [getattr(sh, k) for sh in cs.shards]
        if k in ("bk", "dk"):
            out[k] = np.stack([rows_to_planar(a) for a in arrs])
        elif k in ("size", "dsize", "flag"):
            out[k] = np.asarray([int(a.cpu()[0]) for a in arrs],
                                dtype=np.int32)
        else:
            out[k] = np.stack([a.cpu().numpy() for a in arrs])
    out.update(version_base=cs.version_base,
               oldest_version=cs.oldest_version, d_cap=cs.d_cap)
    return out


def sharded_state_from_numpy(cs: ShardedTorchConflictSet,
                             state: Dict[str, object]) -> None:
    """Load a stacked state (the keys of sharded_state_to_numpy) into `cs`,
    e.g. a ShardedTpuConflictSet's mid-stream.  Merge bookkeeping restarts
    as in torch_backend.state_from_numpy ("delta_bound" defaults to the
    largest loaded delta size, "batches_since_merge" to 0)."""
    cs.synchronize()
    with cs._on_stream():
        cs.d_cap = int(state["d_cap"])
        for d, sh in enumerate(cs.shards):
            for k in SHARDED_STATE_KEYS:
                a = np.asarray(state[k])[d]
                if k in ("bk", "dk"):
                    a = planar_to_rows(a)
                else:
                    a = np.array(a, dtype=np.int32).reshape(
                        (1,) if k in ("size", "dsize", "flag") else a.shape)
                setattr(sh, k, torch.from_numpy(np.ascontiguousarray(a)).to(
                    sh.device))
    cs.synchronize()
    cs.version_base = int(state["version_base"])
    cs.oldest_version = int(state["oldest_version"])
    size, dsize = np.asarray(state["size"]), np.asarray(state["dsize"])
    cs._reset_bookkeeping(live_boundaries=int(size.sum() + dsize.max()))
    with cs._lock:
        cs._delta_bound = int(state.get("delta_bound", dsize.max()))
        cs._batches_since_merge = int(state.get("batches_since_merge", 0))
