"""PyTorch + CUDA ConflictSet: the port of conflict/tpu_backend.py.

Drives the two-tier device programs of conflict/fused.py: a per-batch step
whose cost scales with the batch, and a merge/GC the host schedules every
few batches or when the small delta tier approaches capacity.  The delta
state lives on the device, so consecutive batches pipeline: every launch
goes to ONE CUDA stream the backend owns, each batch's verdicts are copied
into pinned host memory with a non-blocking copy, and an event recorded
after that copy is the only thing ResolveHandle.wait_codes synchronises.
Merge scheduling stays on the host's sound bound of delta occupancy, so
the host never waits on the device to decide.

Two paths: point batches take the compact single-buffer layout
(_pack_compact, make_resolve_step_compact); every other batch -- range
reads, range writes, keys over 31 bytes, and point batches _pack_compact
rejects -- takes the general interval path (_pack, make_resolve_step),
whose digests and metadata travel as one buffer too.

Versions are int32 offsets from self.version_base (rebased during merges).
Capacity overflow sets a sticky device flag surfaced as an error at the
next wait().
"""

from __future__ import annotations

import threading
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.error import err
from ..ops.digest import planar_to_rows, rows_to_planar
from ..ops.rangemax import build_sparse_table
from ..txn.types import CommitResult, CommitTransactionRef, Version
from . import fused
from .api import ConflictSet
from .encoded import EncodedBatch
from .window import make_window_state, resolve_device

DEFAULT_CAPACITY = 1 << 17  # max resident history segments

_MIN_BUCKET = 256


def _bucket(n: int) -> int:
    b = _MIN_BUCKET
    while b < n:
        b <<= 1
    return b


_FINE_GRAN = 1 << 14


def _fine_bucket(n: int) -> int:
    """Pad count for the compact layout's id arrays and unique-key table:
    power-of-two below 16K, then 16K-granular."""
    if n <= _FINE_GRAN:
        return _bucket(n)
    return (n + _FINE_GRAN - 1) // _FINE_GRAN * _FINE_GRAN


class ResolveHandle:
    """In-flight resolution of one batch; wait() returns the verdicts."""

    def __init__(self, cs: "TorchConflictSet", out: torch.Tensor,
                 event, keepalive, n_txns: int, t_cap: int) -> None:
        self._cs = cs
        self._out = out          # host int8[t_cap + 12] (pinned on CUDA)
        self._event = event      # recorded after the d2h copy, or None
        self._keepalive = keepalive
        self._n = n_txns
        self._t_cap = t_cap
        self._depoch = cs._delta_epoch
        self._seq = cs._seq
        self._codes: Optional[np.ndarray] = None
        self._results: Optional[List[CommitResult]] = None

    def wait_codes(self) -> np.ndarray:
        """int8[n_txns] verdict codes (CommitResult values)."""
        if self._codes is None:
            if self._event is not None:
                self._event.synchronize()
            arr = self._out.numpy()
            self._keepalive = None
            extras = arr[self._t_cap:self._t_cap + 12].copy().view(np.int32)
            # Bookkeeping under the backend's lock: a pipeline may wait
            # handles on one thread while another runs _dispatch.
            with self._cs._lock:
                if self in self._cs._inflight:
                    self._cs._inflight.remove(self)
                    self._cs._live_boundaries = int(
                        extras[fused.OUT_DSIZE] + extras[fused.OUT_BSIZE])
                    # Tighten the sound delta-occupancy bound with the
                    # actual device size: actual at this batch + the
                    # worst-case growth of batches dispatched since.
                    # Skipped if a merge re-provisioned the delta after
                    # this batch was dispatched.
                    cs = self._cs
                    if (self._depoch == cs._delta_epoch
                            and self._seq > cs._corrected_seq):
                        cs._corrected_seq = self._seq
                        for s in [s for s in cs._needs if s <= self._seq]:
                            del cs._needs[s]
                        cs._delta_bound = (int(extras[fused.OUT_DSIZE]) +
                                           sum(cs._needs.values()))
            if int(extras[fused.OUT_FLAG]):
                raise err("internal_error",
                          "conflict window capacity exceeded; raise the "
                          "capacity or advance new_oldest_version")
            self._codes = arr[:self._n]
        return self._codes

    def wait(self) -> List[CommitResult]:
        if self._results is None:
            self._results = [CommitResult(c) for c in self.wait_codes()]
        return self._results


class TorchConflictSet(ConflictSet):
    """Conflict resolution on one device.

    device: "cuda" (the default; construction raises when no CUDA device
    is present) or "cpu" (the plain-torch versions, for tests).  impl:
    None to run the CUDA kernels on a CUDA device, or "plain" to run the
    plain-torch versions there too (to compare the two)."""

    # An int32 offset span live versions never approach; beyond this
    # resolve() forces a merge/rebase, and if the window floor lags so far
    # behind that rebasing cannot help, we fail loudly rather than clamp.
    _REL_LIMIT = (1 << 31) - (1 << 24)

    def __init__(self, oldest_version: Version = 0,
                 capacity: Optional[int] = None,
                 delta_capacity: Optional[int] = None,
                 gc_interval_batches: int = 8, device=None,
                 impl: Optional[str] = None) -> None:
        super().__init__(oldest_version)
        self.device = resolve_device(device)
        self.impl = impl
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.capacity = capacity or DEFAULT_CAPACITY
        self._d_cap0 = min(delta_capacity or max(4096, self.capacity // 8),
                           self.capacity)
        self.d_cap = self._d_cap0
        self._lock = threading.Lock()
        self._inflight: List[ResolveHandle] = []
        self._gc_interval = gc_interval_batches
        self.profile = {"batches": 0, "txns": 0, "txn_slots": 0,
                        "merges": 0, "compact_batches": 0,
                        "general_batches": 0}
        with self._on_stream():
            # Jacobi rounds of the general steps, summed on the device.
            self.jacobi_rounds = torch.zeros((1,), dtype=torch.int32,
                                             device=self.device)
        self._reset_state(oldest_version)

    def _on_stream(self):
        """Every launch and allocation goes to the backend's own stream."""
        if self._stream is None:
            return nullcontext()
        return torch.cuda.stream(self._stream)

    def _rel(self, v: Version) -> int:
        off = v - self.version_base
        if off >= self._REL_LIMIT:
            raise err("internal_error",
                      f"version offset {off} exceeds int32 window; "
                      "advance new_oldest_version to allow rebasing")
        return int(max(off, -(1 << 31) + 2))

    def _new_delta(self) -> None:
        dst = fused.make_delta_state(self.d_cap, self.device)
        self.dk, self.dv, self.dsize = dst.bk, dst.bv, dst.size
        self.dtable = fused.delta_table_step(self.dv, impl=self.impl)

    def _reset_state(self, version: Version) -> None:
        """(Re)build the full device state: base at V(k)=version, its table,
        a transparent delta, a cleared sticky flag, reset scheduling."""
        self.version_base = version
        with self._on_stream():
            st = make_window_state(self.capacity, 0, self.device)
            self.bk, self.bv, self.size = st.bk, st.bv, st.size
            self.table = build_sparse_table(self.bv, impl=self.impl)
            self._new_delta()
            self.flag = torch.zeros((1,), dtype=torch.int32,
                                    device=self.device)
        self._reset_bookkeeping(live_boundaries=1)

    def _reset_bookkeeping(self, live_boundaries: int) -> None:
        with self._lock:
            self._live_boundaries = live_boundaries
            self._batches_since_merge = 0
            # Sound upper bound on delta occupancy (an insert adds <= 2W
            # net new boundaries per batch); tightened with device-reported
            # sizes as handles are waited.
            self._delta_bound = 1
            self._delta_epoch = getattr(self, "_delta_epoch", 0) + 1
            self._seq = getattr(self, "_seq", 0)
            self._corrected_seq = getattr(self, "_corrected_seq", 0)
            self._needs: dict = {}

    def clear(self, version: Version) -> None:
        # Like the reference clearConflictSet (SkipList.cpp:797): V(k) :=
        # version everywhere; oldest_version is deliberately NOT changed.
        with self._lock:
            in_flight = bool(self._inflight)
        if in_flight:
            raise err("internal_error",
                      "clear() with batches in flight; wait() them first")
        self._reset_state(version)

    # -- merge scheduling ---------------------------------------------------
    def merge(self) -> None:
        """Overlay delta onto base, GC vs the window floor, rebase, rebuild
        the base table, reset delta.  Asynchronous (no host sync)."""
        self.profile["merges"] += 1
        delta_reb = max(self.oldest_version - self.version_base, 0)
        scalars = (self._rel(self.oldest_version), delta_reb)
        with self._on_stream():
            self._merge_state(fused.make_merge_step(
                self.capacity, self.d_cap, self.impl), scalars)
            if self.d_cap != self._d_cap0:
                # The delta is empty post-merge: shrink an outlier-batch
                # growth back so later batches don't keep paying for it.
                self.d_cap = self._d_cap0
                self._new_delta()
            else:
                self._refresh_dtable()
        self.version_base += delta_reb
        with self._lock:
            self._batches_since_merge = 0
            self._delta_bound = 1
            self._delta_epoch += 1
            self._needs.clear()

    def _merge_state(self, mstep, scalars) -> None:
        mstep(self.bk, self.bv, self.table, self.size, self.dk, self.dv,
              self.dsize, self.flag, scalars)

    def _refresh_dtable(self) -> None:
        """The delta table for the next batch, after an insert or a merge."""
        fused.delta_table_step(self.dv, out=self.dtable, impl=self.impl)

    def _grow_delta(self, needed: int) -> None:
        """Re-provision the (empty, just-merged) delta tier at a larger
        bucket when a batch's write count outgrows it."""
        self.d_cap = min(_bucket(needed), self.capacity)
        with self._on_stream():
            self._new_delta()

    # -- batch packing ------------------------------------------------------
    @staticmethod
    def _pack_compact(enc: EncodedBatch):
        """Host half of the compact point wire format (fused.compact_layout):
        dedupe the batch's begin keys once (reads and writes both index the
        unique table), compact the unique digests to raw prefix+marker
        bytes, and assemble everything into a single uint8 buffer.

        Returns None when the batch violates a compact-path precondition —
        ends not derivable as begin-marker+1, reads/writes not grouped by
        txn, or two unique WRITE keys digest-adjacent."""
        from ..ops.digest import (DIGEST_BYTES, KEY_LANES, PREFIX_BYTES,
                                  planar_to_s24)
        n = enc.n_txns
        nr = enc.r_txn.shape[0]
        nw = enc.w_txn.shape[0]
        # End digests must be begin-with-marker+1 (what the device derives).
        last = KEY_LANES - 1
        for b_, e_ in ((enc.r_begin, enc.r_end), (enc.w_begin, enc.w_end)):
            if b_.shape[1] and not (
                    np.array_equal(b_[:last], e_[:last])
                    and np.array_equal(b_[last] + 1, e_[last])):
                return None
        # Ranges must be grouped by txn so r_txn/w_txn reduce to per-txn
        # start offsets (re-derived on device via rank_count).
        if (nr and (np.diff(enc.r_txn) < 0).any()) or \
                (nw and (np.diff(enc.w_txn) < 0).any()):
            return None
        rb_s = planar_to_s24(enc.r_begin)
        wb_s = planar_to_s24(enc.w_begin)
        uw_s = np.unique(wb_s)
        if uw_s.size > 1:
            uwb = uw_s.view(np.uint8).reshape(-1, DIGEST_BYTES).copy()
            uwb[:, DIGEST_BYTES - 1] += 1      # marker+1 never carries
            uw_end = np.ascontiguousarray(uwb).view(
                "S%d" % DIGEST_BYTES).ravel()
            if bool((uw_end[:-1] >= uw_s[1:]).any()):
                return None
        u_s = np.unique(np.concatenate([rb_s, wb_s]))
        u = int(u_s.size)
        u8 = u_s.view(np.uint8).reshape(-1, DIGEST_BYTES)
        markers = u8[:, DIGEST_BYTES - 1]
        if markers.size and int(markers.max()) > PREFIX_BYTES:
            return None                        # truncated key slipped in
        lkey = int(markers.max()) if markers.size else 1
        # Shipped prefix width quantized to multiples of 4.
        lw = min((lkey + 1 + 3) & ~3, PREFIX_BYTES + 1)

        t_cap = _bucket(n)
        r_pad = _fine_bucket(nr)
        w_pad = _fine_bucket(nw)
        u_pad = _fine_bucket(u)
        lay = fused.compact_layout(t_cap, r_pad, w_pad, u_pad, lw)
        buf = np.zeros((lay["total"],), dtype=np.uint8)

        ubc = np.zeros((u, lw), dtype=np.uint8)
        ubc[:, :lkey] = u8[:, :lkey]
        ubc[:, lw - 1] = markers
        buf[lay["ubytes"]:lay["ubytes"] + u * lw] = ubc.reshape(-1)

        def put_i32(name, count, values, fill=0):
            sec = np.full((count,), fill, dtype=np.int32)
            sec[:len(values)] = values
            o = lay[name]
            buf[o:o + 4 * count] = sec.view(np.uint8)

        put_i32("r_uid", r_pad, np.searchsorted(u_s, rb_s))
        put_i32("w_uid", w_pad, np.searchsorted(u_s, wb_s))
        # Start offsets; txns beyond n get sentinel r_pad/w_pad.
        put_i32("r_start", t_cap,
                np.searchsorted(enc.r_txn, np.arange(n)), fill=r_pad)
        put_i32("w_start", t_cap,
                np.searchsorted(enc.w_txn, np.arange(n)), fill=w_pad)
        flags = np.zeros((t_cap,), dtype=np.uint8)
        flags[:n] = enc.t_has_reads
        buf[lay["t_flags"]:lay["t_flags"] + t_cap] = flags
        scal = np.asarray([u, nr, nw, n, 0, 0], dtype=np.int32)
        buf[lay["scalars"]:lay["scalars"] + 4 * len(scal)] = \
            scal.view(np.uint8)

        # t_snap and the now/oldest scalars are version-rebased at dispatch
        # time through an int32 view of the (4-byte-aligned) buffer.
        return {"compact": True, "buf": buf,
                "meta": buf.view(np.int32),
                "snap_off": lay["t_snap"] // 4,
                "scalar_off": lay["scalars"] // 4 + 4,
                "t_snap_abs": enc.t_snap, "nw": nw,
                "caps": (t_cap, r_pad, w_pad),
                "shapes": (t_cap, r_pad, w_pad, u_pad, lw)}

    @staticmethod
    def _pack(enc: EncodedBatch):
        """Bucket-pad the columnar batch into device input: the compact
        single-buffer layout for point batches, else the general layout,
        one uint8 buffer holding the digest rows r_b | r_e | w_b | w_e
        (MAX padded, int32[2R + 2W, 8]) and then the int32 metadata block
        (fused.meta_size), the same content as the JAX backend's
        digests + meta pair."""
        if enc.all_point:
            packed = TorchConflictSet._pack_compact(enc)
            if packed is not None:
                return packed
        from ..ops.digest import DIGEST_BYTES, KEY_LANES
        n = enc.n_txns
        nr = enc.r_txn.shape[0]
        nw = enc.w_txn.shape[0]
        t_cap = _bucket(n)
        r_cap = _bucket(nr)
        w_cap = _bucket(nw)
        n_rows = 2 * r_cap + 2 * w_cap
        d_bytes = n_rows * DIGEST_BYTES
        buf = np.empty((d_bytes + 4 * fused.meta_size(t_cap, r_cap, w_cap),),
                       dtype=np.uint8)
        rows = buf[:d_bytes].view(np.uint32).reshape(n_rows, KEY_LANES)
        rows.fill(0xFFFFFFFF)
        rows[:nr] = enc.r_begin.T
        rows[r_cap:r_cap + nr] = enc.r_end.T
        rows[2 * r_cap:2 * r_cap + nw] = enc.w_begin.T
        rows[2 * r_cap + w_cap:2 * r_cap + w_cap + nw] = enc.w_end.T
        # The metadata block; the scalar slots at its end and the
        # snapshots are stamped at dispatch time.
        meta = buf[d_bytes:].view(np.int32)
        meta.fill(0)
        o = 0
        meta[o:o + nr] = enc.r_txn; o += r_cap
        meta[o:o + nr] = 1; o += r_cap
        meta[o:o + nw] = enc.w_txn; o += w_cap
        meta[o:o + nw] = 1; o += w_cap
        snap_off = o; o += t_cap
        meta[o:o + n] = enc.t_has_reads; o += t_cap
        meta[o:o + n] = 1; o += t_cap
        return {"compact": False, "buf": buf, "meta": meta,
                "snap_off": snap_off, "scalar_off": o,
                "t_snap_abs": enc.t_snap, "nw": nw,
                "caps": (t_cap, r_cap, w_cap)}

    def _dispatch(self, enc, now: Version, oldest_floor: Version,
                  n_txns: int) -> ResolveHandle:
        t_cap, _, _ = enc["caps"]
        need = 2 * enc["nw"] + 2
        with self._lock:
            need_merge = (
                self._delta_bound + need > self.d_cap
                or self._batches_since_merge >= self._gc_interval
                # Proactive rebase long before the int32 offset span is
                # at risk, regardless of the merge cadence.
                or now - self.version_base >= (1 << 30))
        if need_merge:
            self.merge()
        if need > self.d_cap:
            self._grow_delta(need)
        with self._lock:
            self._delta_bound += need
            self._seq += 1
            self._needs[self._seq] = need
            self._batches_since_merge += 1

        self._stamp(enc, now, oldest_floor, n_txns)
        handle = self._invoke_step(enc, n_txns, t_cap)
        self.profile["batches"] += 1
        self.profile["txns"] += n_txns
        self.profile["txn_slots"] += t_cap
        self.profile["compact_batches" if enc["compact"]
                     else "general_batches"] += 1
        with self._lock:
            self._inflight.append(handle)
        return handle

    def _stamp(self, enc, now: Version, oldest_floor: Version,
               n_txns: int) -> None:
        """Write the version-rebased snapshots and the now/oldest scalars
        into the packed buffer (through its int32 view)."""
        meta = enc["meta"]
        so = enc["snap_off"]
        off = np.clip(enc["t_snap_abs"] - self.version_base,
                      -(1 << 31) + 2, None)
        if off.size and off.max() >= self._REL_LIMIT:
            raise err("internal_error",
                      "version offset exceeds int32 window; "
                      "advance new_oldest_version to allow rebasing")
        meta[so:so + n_txns] = off.astype(np.int32)
        sc = enc["scalar_off"]
        meta[sc:sc + 2] = (self._rel(now), self._rel(oldest_floor))

    def _invoke_step(self, enc, n_txns: int, t_cap: int) -> ResolveHandle:
        """One h2d copy of the packed buffer, the step (compact or
        general), the delta table for the NEXT batch, and one d2h copy of
        the verdicts — all enqueued on the backend's stream with no host
        synchronisation."""
        host_buf = torch.from_numpy(enc["buf"])
        with self._on_stream():
            if self._stream is not None:
                host_buf = host_buf.pin_memory()
            out, keep = self._run_step(enc, host_buf)
            if self._stream is None:
                return ResolveHandle(self, out, None, None, n_txns, t_cap)
            host_out = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
            host_out.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return ResolveHandle(self, host_out, event, (host_buf, keep, out),
                             n_txns, t_cap)

    @staticmethod
    def _device_buf(host_buf: torch.Tensor, device) -> torch.Tensor:
        """The packed batch on `device` (a non-blocking copy from pinned
        memory on a CUDA device, a private copy on the CPU)."""
        if device.type == "cuda":
            return host_buf.to(device, non_blocking=True)
        return host_buf.clone()

    @staticmethod
    def _general_views(buf: torch.Tensor, caps):
        """The general layout's digest rows and metadata block in `buf`."""
        _, r_cap, w_cap = caps
        n_rows = 2 * (r_cap + w_cap)
        return (buf[:32 * n_rows].view(torch.int32).view(n_rows, 8),
                buf[32 * n_rows:].view(torch.int32))

    def _run_step(self, enc, host_buf):
        """The step and the next batch's delta table; returns the verdict
        buffer and what must outlive the launches."""
        buf = self._device_buf(host_buf, self.device)
        state = (self.bk, self.bv, self.table, self.size, self.dk, self.dv,
                 self.dtable, self.dsize, self.flag)
        if enc["compact"]:
            step = fused.make_resolve_step_compact(
                self.capacity, self.d_cap, *enc["shapes"], impl=self.impl)
            _, _, _, _, out = step(*state, buf)
        else:
            step = fused.make_resolve_step(self.capacity, self.d_cap,
                                           *enc["caps"], impl=self.impl)
            _, _, _, _, out = step(*state,
                                   *self._general_views(buf, enc["caps"]),
                                   rounds_acc=self.jacobi_rounds)
        self._refresh_dtable()
        return out, buf

    # -- public API ---------------------------------------------------------
    def resolve_encoded_async(self, batch: EncodedBatch, now: Version,
                              new_oldest_version: Optional[Version] = None
                              ) -> ResolveHandle:
        """Dispatch one pre-encoded batch; wait() on the handle for verdicts.
        Batches MUST be dispatched in version order; any number may be in
        flight."""
        old_floor = self.oldest_version
        new_floor = max(new_oldest_version or old_floor, old_floor)
        h = self._dispatch(self._pack(batch), now, old_floor, batch.n_txns)
        self.oldest_version = new_floor
        return h

    def resolve_async(self, transactions: Sequence[CommitTransactionRef],
                      now: Version,
                      new_oldest_version: Optional[Version] = None
                      ) -> ResolveHandle:
        return self.resolve_encoded_async(
            EncodedBatch.from_transactions(transactions), now,
            new_oldest_version)

    def resolve(self, transactions: Sequence[CommitTransactionRef],
                now: Version,
                new_oldest_version: Optional[Version] = None
                ) -> List[CommitResult]:
        return self.resolve_async(transactions, now,
                                  new_oldest_version).wait()

    def resolve_encoded(self, batch: EncodedBatch, now: Version,
                        new_oldest_version: Optional[Version] = None
                        ) -> List[CommitResult]:
        return self.resolve_encoded_async(batch, now,
                                          new_oldest_version).wait()

    def segment_count(self) -> int:
        """Upper bound on live boundaries as of the last wait()ed batch."""
        with self._lock:
            return self._live_boundaries

    def synchronize(self) -> None:
        """Wait for everything enqueued on the backend's stream."""
        if self._stream is not None:
            self._stream.synchronize()


# ---------------------------------------------------------------------------
# State carried across backends (numpy, planar layout of the JAX package)
# ---------------------------------------------------------------------------

_STATE_KEYS = ("bk", "bv", "table", "size", "dk", "dv", "dtable", "dsize",
               "flag", "version_base", "oldest_version", "d_cap")


def state_to_numpy(cs: TorchConflictSet) -> Dict[str, object]:
    """The backend's device state as numpy, in the JAX package's layout:
    bk/dk planar uint32[8, N], bv/dv int32[N], tables int32[LOG+1, N],
    size/dsize/flag np.int32 scalars, plus version_base, oldest_version
    and d_cap."""
    cs.synchronize()

    def scalar(t):
        return np.int32(int(t.cpu()[0]))

    return {"bk": rows_to_planar(cs.bk), "bv": cs.bv.cpu().numpy(),
            "table": cs.table.cpu().numpy(), "size": scalar(cs.size),
            "dk": rows_to_planar(cs.dk), "dv": cs.dv.cpu().numpy(),
            "dtable": cs.dtable.cpu().numpy(), "dsize": scalar(cs.dsize),
            "flag": scalar(cs.flag), "version_base": cs.version_base,
            "oldest_version": cs.oldest_version, "d_cap": cs.d_cap}


def state_from_numpy(cs: TorchConflictSet, state: Dict[str, object]) -> None:
    """Load a device state given as numpy arrays (the keys of
    state_to_numpy; bk/dk planar uint32[8, N]) into `cs`, e.g. a
    TpuConflictSet's state mid-stream.  Merge bookkeeping restarts with
    the optional "delta_bound" (default: the loaded delta size) and
    "batches_since_merge" (default 0), so a caller that passes both keeps
    the two backends' merge cadence in step."""
    cs.synchronize()
    dev = cs.device

    def t(a, rows=False):
        a = planar_to_rows(a) if rows else np.array(a, dtype=np.int32)
        return torch.from_numpy(a).to(dev)

    with cs._on_stream():
        cs.d_cap = int(state["d_cap"])
        cs.bk, cs.bv, cs.table = (t(state["bk"], True), t(state["bv"]),
                                  t(state["table"]))
        cs.dk, cs.dv, cs.dtable = (t(state["dk"], True), t(state["dv"]),
                                   t(state["dtable"]))
        cs.size, cs.dsize, cs.flag = (t(np.reshape(state[k], (1,)))
                                      for k in ("size", "dsize", "flag"))
    cs.synchronize()
    cs.version_base = int(state["version_base"])
    cs.oldest_version = int(state["oldest_version"])
    cs._reset_bookkeeping(live_boundaries=int(state["size"]) +
                          int(state["dsize"]))
    with cs._lock:
        cs._delta_bound = int(state.get("delta_bound", state["dsize"]))
        cs._batches_since_merge = int(state.get("batches_since_merge", 0))
