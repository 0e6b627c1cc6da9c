"""Backend supervision for device-offloaded conflict resolution (the port
of foundationdb_tpu/conflict/supervisor.py, behaviour for behaviour).

A device backend can hang rather than error, strike transient errors
mid-batch, or die; a dead device would otherwise wedge the whole commit
pipeline.  SupervisedConflictSet wraps any device ConflictSet (here
TorchConflictSet or ShardedTorchConflictSet) with the failure story the
Resolver needs:

  * **deadline budget** — every device call runs under the
    CONFLICT_DEVICE_TIMEOUT_S knob (worker lanes guard the calls; a
    wedged device costs abandoned threads, never the reactor);
  * **depth-N dispatch pipeline** (CONFLICT_PIPELINE_DEPTH) — up to N
    batches in flight on the device: batch k+1 host-packs/h2d-enqueues
    on a dispatch lane while batch k's device step runs and batch k-1's
    verdicts d2h-prefetch on a fetch lane; verdict DELIVERY stays
    strictly in submission order (the mirror fold-through, taint
    pruning, and oldest_version advance are sequential), and a full
    pipeline folds its oldest batch before admitting a new dispatch
    (the PipelineStalls counter; occupancy in InflightDepth);
  * **transient retry** — idempotent device calls (the d2h wait, probes)
    retry with exponential backoff on transient errors
    (CONFLICT_DEVICE_MAX_RETRIES / CONFLICT_DEVICE_RETRY_BACKOFF_S);
  * **health monitor** — consecutive failures and latency-SLO strikes
    (in the style of the reference's rpc/failure_monitor.py)
    trip the backend to CPU even when calls technically succeed;
  * **degrade-to-CPU** — on timeout/error/health trip the in-flight
    batches replay IN ORDER through the host-side mirror (an exact
    OracleConflictSet history maintained alongside every device batch),
    so abort decisions stay bit-identical to an all-oracle run and no
    commit batch is ever lost;
  * **re-probe / promotion** — while degraded, the supervisor
    periodically (exponential backoff) rebuilds a fresh device backend
    from the mirror history and promotes back to the device path;
  * **exact long-key recheck** (SURVEY §7 hard part 1) — device digests
    truncate keys past the digest prefix (31 bytes: the 8-byte tenant-salt
    column + 23 relative bytes, ops/digest.py), which is only
    *conservatively* correct.
    The supervisor flags transactions whose verdict could hinge on a
    truncated digest (the txn carries a truncated key, or a read range
    overlaps a *tainted* digest region where device and exact history
    are known to diverge) and re-resolves only flagged batches through
    the mirror, making long-key decisions exactly equal to the oracle.

BUGGIFY sites ("conflict.device.timeout" / ".transient" / ".dead") inject
faults into the device-dispatch path so simulation exercises every
degradation branch.

Soundness of the recheck (why unflagged batches need no oracle work):
digests of keys <= 31 bytes are a strict order-embedding, so for a batch
with no truncated keys and no tainted-region reads, the device decision
procedure is isomorphic to the oracle's.  Divergence can enter only
through truncated keys — a widened insert (device V raised above exact V
for digest-neighbors of the truncated range) or a flipped verdict whose
writes the device inserted (or skipped) against the exact decision.  Both
cases are recorded in the taint set the moment they occur, stamped with
the insert version; a taint entry becomes unreachable once the MVCC floor
passes its version (a conflict requires V > snap >= floor) and is pruned.
"""

from __future__ import annotations

import concurrent.futures as _cf
import time as _time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.buggify import buggify
from ..core.error import FdbError, err
from ..core.histogram import CounterCollection
from ..core.knobs import server_knobs
from ..core.scheduler import current_event_loop_or_none
from ..core.trace import Severity, TraceEvent
# Single source of truth for the digest geometry (ops/digest.py): the
# 8-byte tenant-salt column + 23 relative bytes digest exactly, so only
# keys past PREFIX_BYTES (31) ever reach the exact recheck below.
from ..ops.digest import DIGEST_BYTES as _DIGEST_BYTES
from ..ops.digest import PREFIX_BYTES as _PREFIX_BYTES
from ..txn.types import CommitResult, CommitTransactionRef, KeyRange, Version
from .api import ConflictSet, conservative_conflict_ranges
from .oracle import OracleConflictSet, combine_write_ranges

# Strictly above every real key digest (decodes to prefix 0xff*31 + marker
# 0xff while real length markers are <= 32); the open end of the mirror
# history's final (unbounded) segment during promotion replay.
_INF_KEY = b"\xff" * _DIGEST_BYTES

TRANSIENT_ERRORS = frozenset({
    "operation_failed", "connection_failed", "request_maybe_delivered",
})


def host_digest(key: bytes, round_up: bool = False) -> bytes:
    """The 32-byte device digest of a key, computed host-side
    (ops/digest.py semantics: 31-byte zero-padded prefix — tenant salt +
    relative tail — plus length marker; round_up adds 1ulp to truncated
    keys so a digest range always covers the true key range)."""
    d = key[:_PREFIX_BYTES].ljust(_PREFIX_BYTES, b"\x00") + \
        bytes([min(len(key), _PREFIX_BYTES + 1)])
    if round_up and len(key) > _PREFIX_BYTES:
        d = (int.from_bytes(d, "big") + 1).to_bytes(_DIGEST_BYTES, "big")
    return d


def is_truncated(key: bytes) -> bool:
    return len(key) > _PREFIX_BYTES


def _now() -> float:
    """Health-monitor clock: virtual time under an installed event loop
    (core/scheduler.py), monotonic wall time otherwise."""
    loop = current_event_loop_or_none()
    if loop is not None:
        return loop.now()
    return _time.monotonic()


def _wall() -> float:
    """Device-profiling clock: WALL time on purpose, even under sim.
    Device dispatch/wait and mirror resolves are real host/device work
    whose cost the TorchBackend histograms must report in real seconds;
    none of these readings feed back into scheduling or verdicts, so
    seeded runs still replay identically."""
    return _time.monotonic()


class BackendHealthMonitor:
    """Believed-health state machine for a device backend (the accelerator
    analog of rpc/failure_monitor.py's per-endpoint availability cache).

    Tracks consecutive hard failures and consecutive latency-SLO strikes;
    either reaching its threshold trips the monitor.  While tripped,
    reprobe_due() gates re-promotion attempts on an exponentially backed
    off schedule so a permanently dead device is probed ever more rarely.
    """

    def __init__(self, failure_threshold: int = 3,
                 latency_slo_s: float = 0.0, slo_strikes: int = 8,
                 reprobe_interval_s: float = 5.0,
                 reprobe_max_s: float = 120.0,
                 time_fn: Callable[[], float] = _now) -> None:
        self.failure_threshold = max(1, int(failure_threshold))
        self.latency_slo_s = float(latency_slo_s)
        self.slo_strikes = max(1, int(slo_strikes))
        self.reprobe_interval_s = float(reprobe_interval_s)
        self.reprobe_max_s = float(reprobe_max_s)
        self._time = time_fn
        self.consecutive_failures = 0
        self.consecutive_slow = 0
        self.tripped = False
        self.tripped_at = 0.0
        self.failed_probes = 0
        self.total_failures = 0

    def record_success(self, latency_s: float) -> None:
        self.consecutive_failures = 0
        if self.latency_slo_s > 0 and latency_s > self.latency_slo_s:
            self.consecutive_slow += 1
            if self.consecutive_slow >= self.slo_strikes:
                self.trip()
        else:
            self.consecutive_slow = 0

    def record_failure(self) -> None:
        self.total_failures += 1
        self.consecutive_failures += 1
        if self.consecutive_failures >= self.failure_threshold:
            self.trip()

    def trip(self) -> None:
        if not self.tripped:
            self.tripped = True
            self.tripped_at = self._time()
            self.failed_probes = 0

    def record_probe_failure(self) -> None:
        self.failed_probes += 1
        self.tripped_at = self._time()

    def reprobe_due(self) -> bool:
        if not self.tripped:
            return False
        wait = min(self.reprobe_interval_s * (2 ** self.failed_probes),
                   self.reprobe_max_s)
        return self._time() - self.tripped_at >= wait

    def reset(self) -> None:
        self.tripped = False
        self.consecutive_failures = 0
        self.consecutive_slow = 0
        self.failed_probes = 0


class _DoneFuture:
    """Already-completed future: the inline (budget <= 0, unguarded)
    pipeline mode's stand-in for a worker-lane future."""

    __slots__ = ("_value",)

    def __init__(self, value) -> None:
        self._value = value

    def result(self, timeout=None):
        return self._value


class _DispatchPipeline:
    """The supervisor's depth-N dispatch pipeline (generalizing the old
    single-worker deadline guard).

    Two single-worker lanes preserve in-order device interaction while
    overlapping the three host-visible phases of neighbouring batches:

      dispatch lane — host pack + h2d enqueue (`dev.resolve_*_async`);
                      state-mutating, so strictly one at a time, FIFO in
                      submission order;
      fetch lane    — d2h verdict wait (`handle.wait*`), prefetched as
                      soon as the dispatch future exists so a healthy
                      batch's verdicts are already host-side when the
                      in-order fold reaches it.

    While batch k's device step runs, batch k+1 packs/h2d-enqueues on the
    dispatch lane and batch k-1's verdicts d2h-fetch on the fetch lane;
    the caller thread meanwhile folds delivered verdicts into the mirror.

    The deadline duty is unchanged: collect() bounds any wait on a lane
    future by the CONFLICT_DEVICE_TIMEOUT_S budget; on timeout BOTH lanes
    are abandoned (a wedged device costs two orphan threads, never the
    reactor) and the supervisor discards the whole device object, so the
    orphans can touch nothing the supervisor still uses.  call() keeps
    the old synchronous guarded-call shape for control-plane operations
    (init, promotion rebuild, clear); with budget <= 0 it runs inline."""

    def __init__(self) -> None:
        self._dispatch = None
        self._fetch = None

    def _lane(self, attr: str, name: str):
        ex = getattr(self, attr)
        if ex is None:
            ex = _cf.ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix=name)
            setattr(self, attr, ex)
        return ex

    def submit_dispatch(self, fn: Callable):
        return self._lane("_dispatch", "conflict-dispatch").submit(fn)

    def submit_fetch(self, fn: Callable):
        return self._lane("_fetch", "conflict-fetch").submit(fn)

    def collect(self, fut, timeout_s: float):
        try:
            return fut.result(
                timeout=timeout_s if timeout_s > 0 else None)
        except _cf.TimeoutError:
            fut.cancel()
            self.close()
            raise err("timed_out",
                      f"device call exceeded {timeout_s}s deadline") from None

    def call(self, fn: Callable, timeout_s: float):
        if timeout_s <= 0:
            return fn()
        return self.collect(self.submit_dispatch(fn), timeout_s)

    def close(self) -> None:
        for attr in ("_dispatch", "_fetch"):
            ex = getattr(self, attr)
            if ex is not None:
                ex.shutdown(wait=False)
                setattr(self, attr, None)


class _SyncHandle:
    """Adapter for device backends without resolve_async (native/oracle):
    the resolve already happened; wait() just hands the verdicts over."""

    __slots__ = ("_results",)

    def __init__(self, results: List[CommitResult]) -> None:
        self._results = results

    def wait(self) -> List[CommitResult]:
        return self._results


class SupervisedHandle:
    """In-flight supervised resolution of one batch (wait() -> verdicts).

    Handles fold into the mirror strictly in dispatch order; waiting a
    later handle first transparently folds its predecessors.  Device
    interaction is carried by two lane futures (the depth-N pipeline):
    `dispatch_fut` resolves to (device_handle, t0, t1) once the host
    pack + h2d enqueue finished, `fetch_fut` to the raw device verdicts
    once the d2h wait finished."""

    __slots__ = ("owner", "txns", "now", "new_oldest",
                 "dispatch_fut", "fetch_fut", "device_obj", "dispatch_t0",
                 "results", "codes", "conflicting", "rechecked",
                 "via_fallback", "attribution", "attribution_exact")

    def __init__(self, owner: "SupervisedConflictSet", txns, now: Version,
                 new_oldest: Optional[Version]) -> None:
        self.owner = owner
        self.txns = txns
        self.now = now
        self.new_oldest = new_oldest
        self.dispatch_fut = None           # set when dispatched to device
        self.fetch_fut = None              # prefetched d2h wait
        self.device_obj = None             # which device instance it's on
        self.dispatch_t0 = 0.0
        self.results: Optional[List[CommitResult]] = None
        self.codes = None                  # int8 verdict array (bulk path)
        self.conflicting: Optional[Dict[int, list]] = None
        self.rechecked = False
        self.via_fallback = False
        # Heat-telemetry attribution: {txn index: [(begin, end), ...]}
        # culprit ranges for aborted txns this fold attributed EXACTLY
        # (mirror-resolved batches: all of them; device batches: a
        # CONFLICT_ATTRIBUTION_SAMPLE-bounded prefix).  Aborted txns
        # absent from the dict carry only conservative (whole read set)
        # blame — the consumer falls back per txn.
        self.attribution: Dict[int, list] = {}
        self.attribution_exact: Dict[int, bool] = {}

    @property
    def folded(self) -> bool:
        return self.results is not None or self.codes is not None

    def wait(self) -> List[CommitResult]:
        if not self.folded:
            self.owner._fold_through(self)
        if self.results is None:
            self.results = [CommitResult(int(c)) for c in self.codes]
        return self.results

    def wait_codes(self):
        if not self.folded:
            self.owner._fold_through(self)
        if self.codes is None:
            self.codes = np.asarray([int(r) for r in self.results],
                                    dtype=np.int8)
        return self.codes


class SupervisedConflictSet(ConflictSet):
    """ConflictSet routing batches to a device backend under supervision,
    with an exact host-side mirror for degradation and long-key recheck.

    `make_device(oldest_version=...)` constructs the device backend — it
    is called at init and again at every promotion, so a wedged device
    object is dropped wholesale rather than reused.  `device`, when given,
    is the first device backend, already built by the caller: init then
    calls make_device no time and cannot begin degraded."""

    _instance_seq = 0

    def __init__(self, make_device: Callable[..., ConflictSet],
                 oldest_version: Version = 0,
                 monitor: Optional[BackendHealthMonitor] = None,
                 device: Optional[ConflictSet] = None) -> None:
        super().__init__(oldest_version)
        knobs = server_knobs()
        self._make_device = make_device
        # Dispatch/wait latency bands + transition counters under the
        # "TorchBackend" group.  Counters mirror the `stats` dict -- stats
        # stays the test-facing source of truth, the collection is the
        # emission surface (the hosting resolver runs its emit_loop).
        SupervisedConflictSet._instance_seq += 1
        self.metrics = CounterCollection(
            "TorchBackend", f"backend{SupervisedConflictSet._instance_seq}")
        self._mirror = OracleConflictSet(oldest_version)
        self._monitor = monitor or BackendHealthMonitor(
            failure_threshold=int(knobs.CONFLICT_BACKEND_FAILURE_THRESHOLD),
            latency_slo_s=float(knobs.CONFLICT_DEVICE_LATENCY_SLO_S),
            slo_strikes=int(knobs.CONFLICT_DEVICE_SLO_STRIKES),
            reprobe_interval_s=float(knobs.CONFLICT_BACKEND_REPROBE_S))
        self._pipe = _DispatchPipeline()
        self._pending: List[SupervisedHandle] = []
        # Digest-space intervals [begin, end) @ version where the device
        # history is known to diverge from the exact mirror (widened or
        # missing inserts); reads overlapping a live entry are rechecked.
        self._taint: List[Tuple[bytes, bytes, Version]] = []
        self._buggify_dead = False
        # Test hook: an error name ("timeout"/FdbError name) injected at
        # every device call, or a LIST consumed one entry per call.
        self.force_device_error = None
        self.stats = {"device_batches": 0, "fallback_batches": 0,
                      "rechecked_batches": 0, "degrades": 0,
                      "promotions": 0, "retries": 0, "taint_size": 0,
                      "pipeline_stalls": 0, "conservative_attribution": 0,
                      "exact_attribution": 0}
        self._device: Optional[ConflictSet] = device
        if device is None:
            try:
                self._device = self._guarded(
                    lambda: make_device(oldest_version=oldest_version),
                    retry=True)
            except Exception as e:          # noqa: BLE001
                # No device at startup: begin degraded, re-probe later.
                self._monitor.trip()
                self._trace("ConflictBackendInitDegraded",
                            Error=str(e)[:120])

    # -- guarded device calls ----------------------------------------------
    def _inject_faults(self) -> None:
        if buggify("conflict.device.dead"):
            self._buggify_dead = True
        if self._buggify_dead:
            raise err("timed_out", "BUGGIFY: device backend dead")
        forced = self.force_device_error
        if isinstance(forced, list):        # one injection per device call
            forced = forced.pop(0) if forced else None
            if not self.force_device_error:
                self.force_device_error = None
        if forced:
            if forced == "timeout":
                raise err("timed_out", "injected device timeout")
            raise err(forced, "injected device error")
        if buggify("conflict.device.timeout"):
            raise err("timed_out", "BUGGIFY: injected device timeout")
        if buggify("conflict.device.transient"):
            raise err("operation_failed",
                      "BUGGIFY: injected transient device error")

    def _guarded(self, fn: Callable, retry: bool = False):
        """One supervised device call: BUGGIFY faults, deadline budget,
        and transient retries with exponential backoff.  Pre-call faults
        (injections — the device refusing the call before it starts) are
        always retryable; transient errors raised by `fn` itself are
        retried only when the call is idempotent (retry=True: the d2h
        wait, probes — never a state-mutating dispatch).  Raises on
        unrecovered failure; the CALLER decides whether to degrade."""
        knobs = server_knobs()
        timeout_s = float(knobs.CONFLICT_DEVICE_TIMEOUT_S)
        attempts = 1 + int(knobs.CONFLICT_DEVICE_MAX_RETRIES)
        backoff = float(knobs.CONFLICT_DEVICE_RETRY_BACKOFF_S)
        for attempt in range(attempts):
            if attempt:
                self.stats["retries"] += 1
                self.metrics.counter("Retries").add(1)
                # Blocking sleep is acceptable here: the surrounding
                # resolve is already a synchronous blocking call in the
                # resolver's execution model (like the device call
                # itself); the cap keeps a worst-case retry storm from
                # stalling the caller for more than ~half a second.
                _time.sleep(min(backoff * (2 ** (attempt - 1)), 0.25))
            try:
                self._inject_faults()
            except FdbError as e:
                if e.name in TRANSIENT_ERRORS and attempt + 1 < attempts:
                    continue
                raise
            try:
                return self._pipe.call(fn, timeout_s)
            except FdbError as e:
                if retry and e.name in TRANSIENT_ERRORS \
                        and attempt + 1 < attempts:
                    continue
                raise
        raise AssertionError("unreachable")  # pragma: no cover

    def _trace(self, event: str, **details) -> None:
        ev = TraceEvent(event, Severity.Warn)
        for k, v in details.items():
            ev.detail(k, v)
        ev.log()

    # -- degradation / promotion -------------------------------------------
    def _degrade(self, reason: str) -> None:
        """Leave the device path: later folds of still-pending handles
        find `device_obj is not self._device` and replay through the
        exact mirror IN SUBMISSION ORDER (_fold_through walks _pending
        front-to-back), so a mid-pipeline failure drains the whole
        pipeline deterministically — no batch lost, no reordering."""
        if self._device is None:
            return
        self._device = None
        self._pipe.close()     # abandon both lanes (may be wedged)
        self._taint.clear()      # refers to the discarded device history
        self.stats["taint_size"] = 0
        self._monitor.trip()
        self.stats["degrades"] += 1
        self.metrics.counter("Degrades").add(1)
        self._trace("ConflictBackendDegraded", Reason=reason[:160],
                    Failures=self._monitor.total_failures)

    def _maybe_promote(self) -> None:
        """While degraded: if the re-probe backoff has elapsed, rebuild a
        fresh device from the mirror history and promote back.  Pending
        (mirror-bound) batches fold first so the rebuilt device state
        includes their inserts."""
        if self._device is not None or not self._monitor.reprobe_due():
            return
        if self._pending:
            self._fold_through(self._pending[-1])
        # Snapshot the mirror ON THIS THREAD: the rebuild may run on the
        # deadline guard's worker, and on timeout that worker is abandoned
        # while still executing — it must never read live mirror state the
        # reactor keeps mutating, nor write anything back into self (the
        # _DispatchPipeline invariant).  The rebuild therefore gets copies
        # and RETURNS its results; only this thread installs them.
        floor = self._mirror.oldest_version
        keys = list(self._mirror.history.keys)
        vals = list(self._mirror.history.vals)
        try:
            dev, taint = self._guarded(
                lambda: self._rebuild_device(floor, keys, vals), retry=True)
        except Exception as e:              # noqa: BLE001
            self._monitor.record_probe_failure()
            self._trace("ConflictBackendProbeFailed", Error=str(e)[:120])
            return
        self._taint = taint
        self.stats["taint_size"] = len(taint)
        self._device = dev
        self._monitor.reset()
        self.stats["promotions"] += 1
        self.metrics.counter("Promotions").add(1)
        self._trace("ConflictBackendPromoted", Segments=len(keys))

    def _rebuild_device(self, floor: Version, keys: List[bytes],
                        vals: List[Version]):
        """Fresh device whose history equals the (snapshotted) mirror
        bit-for-bit (up to digest widening, which re-enters the returned
        taint list): V(k)=floor everywhere, then replay live segments
        grouped by version, ascending — version order is what resolve()'s
        insert-at-now semantics require.  Pure with respect to self: may
        run on an abandonable worker thread."""
        dev = self._make_device(oldest_version=floor)
        by_version: Dict[Version, List[Tuple[bytes, bytes]]] = {}
        for i, v in enumerate(vals):
            if v <= floor:
                continue
            end = keys[i + 1] if i + 1 < len(keys) else _INF_KEY
            by_version.setdefault(v, []).append((keys[i], end))
        taint: List[Tuple[bytes, bytes, Version]] = []
        for v in sorted(by_version):
            segs = by_version[v]
            for chunk in range(0, len(segs), 512):
                part = segs[chunk:chunk + 512]
                txn = CommitTransactionRef(write_conflict_ranges=[
                    KeyRange(b, e) for b, e in part])
                res = dev.resolve([txn], v)
                assert res == [CommitResult.COMMITTED]
            for b, e in segs:
                if is_truncated(b) or is_truncated(e):
                    taint.append((host_digest(b), host_digest(e, True), v))
        return dev, taint

    # -- long-key recheck flags --------------------------------------------
    def _taint_overlaps(self, begin: bytes, end: bytes) -> bool:
        db = host_digest(begin)
        de = host_digest(end, round_up=True)
        for tb, te, _v in self._taint:
            if db < te and tb < de:
                return True
        return False

    def _needs_recheck(self, txns: Sequence[CommitTransactionRef]) -> bool:
        """True iff any verdict in the batch could hinge on a truncated
        digest: a txn carries a truncated key in ANY conflict range, or a
        read range overlaps a tainted digest region.  One flagged txn
        re-resolves the whole batch — a flipped verdict changes the
        surviving-writer set, so downstream intra-batch decisions must be
        recomputed too."""
        for tr in txns:
            for r in tr.read_conflict_ranges:
                if is_truncated(r.begin) or is_truncated(r.end):
                    return True
                if self._taint and self._taint_overlaps(r.begin, r.end):
                    return True
            for w in tr.write_conflict_ranges:
                if is_truncated(w.begin) or is_truncated(w.end):
                    return True
        return False

    def _prune_taint(self) -> None:
        floor = self._mirror.oldest_version
        if self._taint:
            self._taint = [t for t in self._taint if t[2] > floor]
        self.stats["taint_size"] = len(self._taint)

    # -- mirror maintenance -------------------------------------------------
    def _mirror_apply(self, txns, final: List[CommitResult], now: Version,
                      new_oldest: Optional[Version]) -> None:
        """Fold an unflagged device batch into the exact mirror: steps 4-5
        of the oracle's resolve (insert surviving writes at `now`, advance
        the floor) driven by the FINAL verdicts."""
        surviving: List[Tuple[bytes, bytes]] = []
        for tr, res in zip(txns, final):
            if res == CommitResult.COMMITTED:
                for w in tr.write_conflict_ranges:
                    if w.begin < w.end:
                        surviving.append((w.begin, w.end))
        self._mirror.history.insert_many(
            combine_write_ranges(surviving), now)
        if new_oldest is not None and \
                new_oldest > self._mirror.oldest_version:
            self._mirror.oldest_version = new_oldest
            self._mirror.history.remove_before(new_oldest)

    def _taint_divergence(self, txns, device: List[CommitResult],
                          final: List[CommitResult], now: Version) -> None:
        """Record digest regions where the device history diverges from the
        exact mirror after this batch: write ranges of txns whose device
        verdict differs from the exact one (missing or spurious device
        inserts), and widened inserts of surviving truncated-key writes."""
        for tr, dv, fv in zip(txns, device, final):
            diverged = dv != fv
            committed = fv == CommitResult.COMMITTED
            for w in tr.write_conflict_ranges:
                if w.begin >= w.end:
                    continue
                if diverged or (committed and (is_truncated(w.begin)
                                               or is_truncated(w.end))):
                    self._taint.append((host_digest(w.begin),
                                        host_digest(w.end, True), now))
        self.stats["taint_size"] = len(self._taint)

    def _attribute_device_batch(self, h: SupervisedHandle,
                                device_codes) -> None:
        """Fix for the device path's conservative conflict reporting
        (the old behavior blamed a reporter's ENTIRE read set): a
        CONFLICT_ATTRIBUTION_SAMPLE-bounded prefix of this batch's
        aborted txns is attributed EXACTLY against the mirror history —
        which still holds the pre-batch state the device's decisions
        were made against — and the remainder keep conservative blame,
        counted in ConservativeAttribution so the fallback is visible.
        Cost is knob-bounded: a numpy/list conflict count plus at most
        `sample` read-range probes of the mirror's segment list."""
        conflict_code = int(CommitResult.CONFLICT)
        if isinstance(device_codes, list):
            conflicted = [i for i, c in enumerate(device_codes)
                          if int(c) == conflict_code]
        else:
            conflicted = np.nonzero(
                np.asarray(device_codes) == conflict_code)[0].tolist()
        n_conflicts = len(conflicted)
        if not n_conflicts:
            h.conflicting = {}
            return
        knobs = server_knobs()
        budget = (int(knobs.CONFLICT_ATTRIBUTION_SAMPLE)
                  if knobs.HEAT_TELEMETRY_ENABLED else 0)
        exact: Dict[int, list] = {}
        if budget > 0:
            exact = self._mirror.attribute_conflicts(
                h.txns, device_codes, budget)
        h.attribution = exact
        h.attribution_exact = {i: True for i in exact}
        conservative = n_conflicts - len(exact)
        self.stats["exact_attribution"] += len(exact)
        if conservative:
            self.stats["conservative_attribution"] += conservative
            self.metrics.counter("ConservativeAttribution").add(
                conservative)
        # Reporters' client-facing ranges: exact where attributed, the
        # conservative whole read set otherwise (still a legal superset).
        conflicting: Dict[int, list] = {}
        for i in conflicted:
            tr = h.txns[i]
            if not getattr(tr, "report_conflicting_keys", False):
                continue
            rs = exact.get(i)
            conflicting[i] = rs if rs is not None else \
                [(r.begin, r.end) for r in tr.read_conflict_ranges]
        h.conflicting = conflicting

    # -- folding -------------------------------------------------------------
    def _fold_through(self, handle: SupervisedHandle) -> None:
        while self._pending:
            h = self._pending.pop(0)
            self._fold_one(h)
            if h is handle:
                return
        assert handle.folded, "handle not pending and not folded"

    def _collect_device_codes(self, h: SupervisedHandle):
        """The d2h half of one supervised device call: BUGGIFY faults,
        deadline budget, transient retries — the fetch-lane analog of
        _guarded(..., retry=True).  The first attempt consumes the
        PREFETCHED fetch future (usually already done: the fetch lane
        ran the wait while earlier batches folded); a transient failure
        re-submits the idempotent wait to the lane and tries again."""
        knobs = server_knobs()
        timeout_s = float(knobs.CONFLICT_DEVICE_TIMEOUT_S)
        attempts = 1 + int(knobs.CONFLICT_DEVICE_MAX_RETRIES)
        backoff = float(knobs.CONFLICT_DEVICE_RETRY_BACKOFF_S)
        fut = h.fetch_fut
        for attempt in range(attempts):
            if attempt:
                self.stats["retries"] += 1
                self.metrics.counter("Retries").add(1)
                _time.sleep(min(backoff * (2 ** (attempt - 1)), 0.25))
            try:
                self._inject_faults()
            except FdbError as e:
                if e.name in TRANSIENT_ERRORS and attempt + 1 < attempts:
                    continue
                raise
            try:
                if fut is not None:
                    return self._pipe.collect(fut, timeout_s)
                # Inline (budget <= 0) mode: run the wait on this thread.
                dh = h.dispatch_fut.result()[0]
                return (dh.wait_codes() if hasattr(dh, "wait_codes")
                        else dh.wait())
            except FdbError as e:
                if e.name in TRANSIENT_ERRORS and attempt + 1 < attempts:
                    if fut is not None:
                        fut = self._submit_fetch(h.dispatch_fut)
                    continue
                raise
        raise AssertionError("unreachable")  # pragma: no cover

    def _submit_fetch(self, dispatch_fut):
        """Queue the d2h wait for a dispatched batch on the fetch lane
        (prefetch): raw int8 codes when the device handle offers the
        bulk path, CommitResult objects otherwise."""
        def _fetch():
            dh = dispatch_fut.result()[0]   # re-raises dispatch failures
            return (dh.wait_codes() if hasattr(dh, "wait_codes")
                    else dh.wait())
        return self._pipe.submit_fetch(_fetch)

    def _fold_one(self, h: SupervisedHandle) -> None:
        device_codes = None
        slo_tripped = False
        if h.dispatch_fut is not None and h.device_obj is self._device \
                and self._device is not None:
            try:
                _t_wait = _wall()
                device_codes = self._collect_device_codes(h)
                _t_done = _wall()
                # The dispatch future is resolved by now (the fetch task
                # consumed it): record the pack+h2d half of the batch.
                _dh, _td0, _td1 = h.dispatch_fut.result()
                h.dispatch_t0 = _td0
                self.metrics.histogram("Dispatch").record(_td1 - _td0)
                # Device-vs-mirror profiling: wait = d2h sync + any
                # remaining device compute; end-to-end = dispatch->codes.
                self.metrics.histogram("DeviceWait").record(
                    _t_done - _t_wait)
                self.metrics.histogram("DeviceBatch").record(
                    _t_done - h.dispatch_t0)
                self._monitor.record_success(_t_done - h.dispatch_t0)
                # Latency SLO strike-out: this batch's verdicts are still
                # valid, but later batches leave the device.  The degrade
                # happens AFTER this batch folds — _degrade clears the
                # taint set, which _needs_recheck below still needs to
                # judge THIS batch exactly.
                slo_tripped = self._monitor.tripped
            except Exception as e:          # noqa: BLE001
                self._monitor.record_failure()
                self._degrade(f"wait failed: {e}")
                device_codes = None
        if device_codes is None:
            # Fallback replay: the exact mirror IS the authoritative
            # history, so replaying the batch through it is bit-identical
            # to an all-oracle run.
            h.via_fallback = True
            self.stats["fallback_batches"] += 1
            self.metrics.counter("FallbackBatches").add(1)
            _t_m = _wall()
            h.results, h.conflicting = self._mirror.resolve_with_conflicts(
                h.txns, h.now, h.new_oldest)
            self.metrics.histogram("MirrorResolve").record(
                _wall() - _t_m)
            # Mirror-resolved: the oracle knows every culprit exactly.
            h.attribution = dict(self._mirror.last_attribution)
            h.attribution_exact = dict(self._mirror.last_attribution_exact)
            self.stats["exact_attribution"] += len(h.attribution)
            self.oldest_version = self._mirror.oldest_version
            self._prune_taint()
            return
        self.stats["device_batches"] += 1
        self.metrics.counter("DeviceBatches").add(1)
        self.metrics.counter("DeviceTxns").add(len(h.txns))
        if self._needs_recheck(h.txns):
            # Exact recheck: re-resolve through the mirror (also updating
            # it); the device's conservative codes are discarded for this
            # batch and the divergence they caused in device history is
            # tainted for future flagging.
            h.rechecked = True
            self.stats["rechecked_batches"] += 1
            self.metrics.counter("RecheckedBatches").add(1)
            _t_m = _wall()
            final, ranges = self._mirror.resolve_with_conflicts(
                h.txns, h.now, h.new_oldest)
            self.metrics.histogram("MirrorResolve").record(
                _wall() - _t_m)
            self._taint_divergence(h.txns, device_codes, final, h.now)
            h.results, h.conflicting = final, ranges
            h.attribution = dict(self._mirror.last_attribution)
            h.attribution_exact = dict(self._mirror.last_attribution_exact)
            self.stats["exact_attribution"] += len(h.attribution)
        else:
            # Device-exact batch: attribute a knob-bounded sample of the
            # aborted txns against the mirror BEFORE this batch's writes
            # land in it (satellite 1 — the pre-insert history is what
            # the conflict decisions were made against).
            self._attribute_device_batch(h, device_codes)
            # Unflagged: device verdicts are provably exact (see module
            # docstring); fold them into the mirror as-is.  The bulk path
            # delivers raw int8 codes (kept as-is; wait() materializes
            # CommitResult objects only on demand).
            self._mirror_apply(h.txns, device_codes, h.now, h.new_oldest)
            if isinstance(device_codes, list):
                h.results = device_codes
            else:
                h.codes = device_codes
        self.oldest_version = self._mirror.oldest_version
        self._prune_taint()
        if slo_tripped:
            self._degrade("latency SLO exceeded")

    # -- public API -----------------------------------------------------------
    def _inject_dispatch_faults(self) -> None:
        """Pre-dispatch fault injection with _guarded's transient-retry
        policy (pre-call faults — the device refusing the call before it
        starts — are always retryable).  Runs ON THE CALLER THREAD so
        BUGGIFY draws stay deterministic under sim; only after it passes
        is the real dispatch handed to the pipeline's dispatch lane."""
        knobs = server_knobs()
        attempts = 1 + int(knobs.CONFLICT_DEVICE_MAX_RETRIES)
        backoff = float(knobs.CONFLICT_DEVICE_RETRY_BACKOFF_S)
        for attempt in range(attempts):
            if attempt:
                self.stats["retries"] += 1
                self.metrics.counter("Retries").add(1)
                _time.sleep(min(backoff * (2 ** (attempt - 1)), 0.25))
            try:
                self._inject_faults()
                return
            except FdbError as e:
                if e.name in TRANSIENT_ERRORS and attempt + 1 < attempts:
                    continue
                raise

    def _submit(self, txns: List[CommitTransactionRef], enc, now: Version,
                new_oldest: Optional[Version]) -> SupervisedHandle:
        """Shared dispatch half of resolve_async/resolve_encoded_async:
        enforce the depth-N pipeline bound (folding the oldest in-flight
        batches first — strict in-order delivery), then enqueue the
        device dispatch on the dispatch lane and its d2h wait on the
        fetch lane."""
        h = SupervisedHandle(self, txns, now, new_oldest)
        knobs = server_knobs()
        depth = max(1, int(knobs.CONFLICT_PIPELINE_DEPTH))
        if len(self._pending) >= depth:
            # Dispatch blocked on a full pipeline: deliver the oldest
            # batch(es) before admitting this one.
            self.stats["pipeline_stalls"] += 1
            self.metrics.counter("PipelineStalls").add(1)
            self._fold_through(self._pending[len(self._pending) - depth])
        if self._device is None:
            self._maybe_promote()
        if self._device is not None:
            dev = self._device
            timeout_s = float(knobs.CONFLICT_DEVICE_TIMEOUT_S)
            try:
                self._inject_dispatch_faults()

                def _dispatch():
                    # Dispatch band: host pack + h2d enqueue (the async
                    # device step returns before compute finishes, so
                    # this isolates the send half of a batch).
                    t0 = _wall()
                    if enc is not None and \
                            hasattr(dev, "resolve_encoded_async"):
                        dh = dev.resolve_encoded_async(enc, now, new_oldest)
                    elif hasattr(dev, "resolve_async"):
                        dh = dev.resolve_async(txns, now, new_oldest)
                    else:
                        dh = _SyncHandle(dev.resolve(txns, now, new_oldest))
                    return dh, t0, _wall()

                if timeout_s <= 0:
                    h.dispatch_fut = _DoneFuture(_dispatch())
                else:
                    h.dispatch_fut = self._pipe.submit_dispatch(_dispatch)
                    h.fetch_fut = self._submit_fetch(h.dispatch_fut)
                h.device_obj = dev
            except Exception as e:          # noqa: BLE001
                # Dispatch is NOT retried: it mutates device state, so a
                # mid-dispatch failure leaves it unknown — degrade and let
                # the mirror own this batch (and promotion rebuild later).
                # (Pipelined dispatch failures surface at this batch's
                # fold instead — still before any verdict delivery.)
                self._monitor.record_failure()
                self._degrade(f"dispatch failed: {e}")
        self._pending.append(h)
        self.metrics.histogram("InflightDepth").record(
            float(len(self._pending)))
        return h

    def resolve_async(self, transactions: Sequence[CommitTransactionRef],
                      now: Version,
                      new_oldest_version: Optional[Version] = None
                      ) -> SupervisedHandle:
        return self._submit(list(transactions), None, now,
                            new_oldest_version)

    def resolve_encoded_async(self, batch, now: Version,
                              new_oldest_version: Optional[Version] = None,
                              transactions: Optional[
                                  Sequence[CommitTransactionRef]] = None
                              ) -> SupervisedHandle:
        """Bulk columnar dispatch (the bench path): the device gets the
        pre-encoded batch (zero per-txn Python work on the dispatch
        lane).  `transactions` — the SAME batch in object form — is
        REQUIRED: the exact mirror (degrade replay, long-key recheck,
        fold-in of surviving writes) operates on raw keys the encoded
        form no longer carries."""
        if transactions is None:
            raise TypeError(
                "SupervisedConflictSet.resolve_encoded_async needs the "
                "object-form transactions for its exact mirror")
        return self._submit(list(transactions), batch, now,
                            new_oldest_version)

    def resolve(self, transactions: Sequence[CommitTransactionRef],
                now: Version,
                new_oldest_version: Optional[Version] = None
                ) -> List[CommitResult]:
        return self.resolve_async(transactions, now,
                                  new_oldest_version).wait()

    def resolve_with_conflicts(self, transactions, now: Version,
                               new_oldest_version: Optional[Version] = None):
        h = self.resolve_async(transactions, now, new_oldest_version)
        verdicts = h.wait()
        # Heat-telemetry surface: exact culprits where this batch's fold
        # attributed them (mirror-resolved: all; device path: the
        # knob-bounded sample) — consumers fall back to a txn's read set
        # for aborted indices absent from the dict.
        self.last_attribution = h.attribution
        self.last_attribution_exact = h.attribution_exact
        if h.conflicting is not None:       # exact (mirror-resolved) path
            return verdicts, h.conflicting
        return verdicts, conservative_conflict_ranges(verdicts, transactions)

    def clear(self, version: Version) -> None:
        if self._pending:
            self._fold_through(self._pending[-1])
        self._mirror.clear(version)
        self._taint.clear()
        self.stats["taint_size"] = 0
        if self._device is not None:
            try:
                self._guarded(lambda: self._device.clear(version))
            except Exception as e:          # noqa: BLE001
                self._monitor.record_failure()
                self._degrade(f"clear failed: {e}")

    # -- introspection --------------------------------------------------------
    @property
    def degraded(self) -> bool:
        return self._device is None

    @property
    def device(self) -> Optional[ConflictSet]:
        return self._device

    @property
    def monitor(self) -> BackendHealthMonitor:
        return self._monitor

    def segment_count(self) -> int:
        return self._mirror.history.segment_count()

    def status(self) -> Dict[str, object]:
        out = dict(self.stats, degraded=self.degraded,
                   pending=len(self._pending),
                   tripped=self._monitor.tripped,
                   consecutive_failures=self._monitor.consecutive_failures)
        device = self.stats["device_batches"]
        out["recheck_rate"] = (self.stats["rechecked_batches"] / device
                               if device else 0.0)
        # Device-side batch shape accounting (torch_backend.py profile):
        # occupancy % = real txns per padded device slot — low occupancy
        # means the bucket quantization is burning h2d bytes.
        prof = getattr(self._device, "profile", None)
        if prof:
            out["device_profile"] = dict(prof)
            if prof.get("txn_slots"):
                out["batch_occupancy_pct"] = round(
                    100.0 * prof["txns"] / prof["txn_slots"], 1)
        bands = {}
        for name, hist in self.metrics.histograms.items():
            s = hist.snapshot()
            if s.count:
                bands[name] = s.to_status()
        if bands:
            out["latency_statistics"] = bands
        return out
