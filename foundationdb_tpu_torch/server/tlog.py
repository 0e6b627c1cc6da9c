"""TLog: the write-ahead log role -- version-ordered append, per-tag peek
and pop, spill, lock and recovery (trimmed copy of
foundationdb_tpu/server/tlog.py).

Reference: fdbserver/TLogServer.actor.cpp -- tLogCommit (:2080) appends a
version's messages in prev->version chain order and fsyncs (doQueueCommit
:1966); tLogPeekMessages (:1584) serves per-tag cursors for storage-server
pulls; pop trims acknowledged prefixes per tag.  With a DiskQueue every
commit is also a record in it, written and fsynced before the durable
frontier moves past its version; past TLOG_SPILL_THRESHOLD resident
bytes the oldest durable entries of the heaviest tags become references
into the queue file (spill-by-reference), which peek reads back under
its byte budget.

The role answers within the call: commit() finds its predecessor already
appended, because the log system pushes versions in chain order (a gap
raises instead of parking), and syncs before it replies, so the reply is
the durable version.  A write or fsync that fails raises out of commit()
with nothing acknowledged (the reference's _die_on_disk_error), and so
does a spilled record that fails its read: it is never skipped.  peek()
answers with what the log holds at once (the reference parks a peek
above its version until a commit arrives; here the puller stops).

Recovery (the epoch end): lock() stops a generation and reports its end
and popped versions; from_disk() rebuilds a TLog of a killed generation
from its queue file; a new generation's TLog carries each tag's
un-popped data from an old holder (recover_from, which pages through
peek's byte budget up to the recovery version, where the reference peeks
once and keeps what the first reply holds), makes it durable in its own
queue, and records its starting version (write_genesis).

On a simulated or real process (run(process)), actors serve the TLog's
interface (commit, peek, pop, confirm_running, lock, waitFailure) with
the same calls; a commit that arrives ahead of its predecessor (two
proxies' pushes cross on the network) is held until the predecessor is
appended, as the reference's tLogCommit waits for its prev_version.

Left out: the queuing metrics, the commit-debug spans and the latency
bands.
"""

from __future__ import annotations

import struct
from collections import deque
from time import perf_counter
from typing import Deque, Dict, List, Optional, Tuple

from ..core.knobs import server_knobs
from ..core.wire import Reader, Writer
from ..txn.types import Mutation, MutationType, Version
from .disk_queue import DiskQueue
from ..core.error import err
from ..core.trace import Severity, TraceEvent
from .failure import hold_wait_failure
from .interfaces import (Tag, TLogCommitRequest, TLogConfirmRunningRequest,
                         TLogInterface, TLogLockReply, TLogLockRequest,
                         TLogPeekReply, TLogPeekRequest, TLogPopRequest, ask)

_PACK_HDR = struct.Struct("<II").pack
_PACK_U8U32 = struct.Struct("<BI").pack
_PACK_U32 = struct.Struct("<I").pack


def _pack_commit(version: Version, prev_version: Version,
                 known_committed: Version,
                 popped: Dict[Tag, Version],
                 messages: Dict[Tag, List[Mutation]]) -> bytes:
    """One DiskQueue record per committed version (the reference packs
    version blocks into DiskQueue pages, TLogServer.actor.cpp:293
    TLogQueueEntry), byte for byte the reference's."""
    w = Writer().i64(version).i64(prev_version).i64(known_committed)
    w.u16(len(popped))
    for tag, v in popped.items():
        w.u32(tag).i64(v)
    w.u16(len(messages))
    append = w._parts.append
    for tag, msgs in messages.items():
        append(_PACK_HDR(tag, len(msgs)))
        for m in msgs:
            p1 = m.param1
            append(_PACK_U8U32(int(m.type), len(p1)))
            append(p1)
            p2 = m.param2
            append(_PACK_U32(len(p2)))
            append(p2)
    return w.done()


def _unpack_commit(blob: bytes):
    r = Reader(blob)
    version, prev_version, known_committed = r.i64(), r.i64(), r.i64()
    popped = {r.u32(): r.i64() for _ in range(r.u16())}
    messages: Dict[Tag, List[Mutation]] = {}
    for _ in range(r.u16()):
        tag = r.u32()
        msgs = [Mutation(MutationType(r.u8()), r.bytes_(), r.bytes_())
                for _ in range(r.u32())]
        messages[tag] = msgs
    return version, prev_version, known_committed, popped, messages


def _nbytes(msgs: List[Mutation]) -> int:
    return sum(len(m.param1) + len(m.param2) + 12 for m in msgs)


def peek_through(tlog: "TLog", tag: Tag, begin: Version,
                 until: Version) -> List[Tuple[Version, List[Mutation]]]:
    """Every entry of `tag` in `tlog` from `begin` up to `until`, paging
    through peek's byte budget until a reply ends past `until` (the
    reference's recovery peeks once and keeps only the first page)."""
    out: List[Tuple[Version, List[Mutation]]] = []
    while True:
        reply = ask(tlog.peek, TLogPeekRequest(tag=tag, begin=begin))
        out += [(v, msgs) for v, msgs in reply.messages if v <= until]
        if reply.end > until:
            return out
        if reply.end <= begin:
            raise RuntimeError(f"tlog {tlog.id}: peek of tag {tag} at "
                               f"{begin} made no progress")
        begin = reply.end


class TLog:
    def __init__(self, tlog_id: str = "log0",
                 recovery_version: Version = 0,
                 disk_queue: Optional[DiskQueue] = None,
                 epoch: int = 1) -> None:
        self.id = tlog_id
        self.epoch = epoch
        self.version: Version = recovery_version          # appended
        self.durable_version: Version = recovery_version  # fsynced
        self.known_committed_version: Version = recovery_version
        # tag -> deque of (version, mutations), version-ascending: the
        # RESIDENT suffix of each tag's data.
        self.tag_data: Dict[Tag, Deque[Tuple[Version, List[Mutation]]]] = {}
        # tag -> deque of (version, queue seq, payload bytes): the SPILLED
        # prefix, served from the queue file.  Spilled versions precede
        # resident ones.
        self.spilled: Dict[Tag, Deque[Tuple[Version, int, int]]] = {}
        self.poppedtags: Dict[Tag, Version] = {}
        self.bytes_input = 0
        # Resident payload bytes (all tags, and each tag's), driving the
        # spill; bytes spilled and bytes trimmed by pops, both tiers.
        self.bytes_in_memory = 0
        self.tag_bytes: Dict[Tag, int] = {}
        self.bytes_spilled = 0
        self.bytes_popped = 0
        # Set by lock(), or when the queue's write or fsync failed; a
        # stopped log drops every commit and confirm.
        self.stopped = False
        # None: memory only, and the durable frontier moves at once.
        self.disk_queue = disk_queue
        # (version, queue seq, tags in record) per pushed record, for
        # pop-driven trimming; version -> the seq of its record.
        self._record_seqs: Deque[Tuple[Version, int, frozenset]] = deque()
        self._seq_of_version: Dict[Version, int] = {}
        # Seconds of the last commit's write + fsync of the queue.
        self.last_sync_s = 0.0
        # The interface its actors serve once it runs on a process.
        self.interface = TLogInterface(tlog_id)

    @classmethod
    def from_disk(cls, tlog_id: str, disk_queue: DiskQueue,
                  epoch: int = 0) -> "TLog":
        """Rebuild a killed generation's TLog from its queue: replay the
        surviving commit records in order (reference: a rebooted worker
        re-instantiates its TLogs from disk, worker.actor.cpp's data
        directory scan).  It serves lock and peek for the next recovery."""
        records = disk_queue.recover()
        t = cls(tlog_id, 0, disk_queue=disk_queue, epoch=epoch)
        for seq, blob in records:
            version, _prev, kcv, popped, messages = _unpack_commit(blob)
            for tag, v in popped.items():
                t.poppedtags[tag] = max(t.poppedtags.get(tag, 0), v)
            for tag, msgs in messages.items():
                t.tag_data.setdefault(tag, deque()).append((version, msgs))
                nbytes = _nbytes(msgs)
                t.bytes_input += nbytes
                t.bytes_in_memory += nbytes
                t.tag_bytes[tag] = t.tag_bytes.get(tag, 0) + nbytes
            t.known_committed_version = max(t.known_committed_version, kcv)
            t._record_seqs.append((version, seq, frozenset(messages)))
            # A generation's genesis record repeats its recovery version,
            # which may also be its last carried record's: the version
            # keeps the record that holds its messages (the reference's
            # maps it to the empty genesis, so a spilled read of it finds
            # no messages and its peek skips the entry).
            if messages or version not in t._seq_of_version:
                t._seq_of_version[version] = seq
            if version > t.version:
                t.version = version
        t.durable_version = t.version
        for tag, popped_v in t.poppedtags.items():
            q = t.tag_data.get(tag)
            while q and q[0][0] <= popped_v:
                _v, msgs = q.popleft()
                nbytes = _nbytes(msgs)
                t.bytes_in_memory -= nbytes
                t.bytes_popped += nbytes
                if tag in t.tag_bytes:
                    t.tag_bytes[tag] -= nbytes
        # Re-apply the memory bound: no commit will arrive at an old
        # generation to trigger the spill.
        t._maybe_spill()
        TraceEvent("TLogRecoveredFromDisk").detail("Id", tlog_id).detail(
            "Version", t.version).detail("Records", len(records)).log()
        return t

    def write_genesis(self) -> None:
        """Durably record this generation's starting version as an empty
        commit record, so that a generation killed before its first
        commit does not come back at end version 0 (which would roll the
        next recovery below the storage servers)."""
        if self.disk_queue is None or self.version <= 0:
            return
        self.disk_queue.push(_pack_commit(self.version, self.version,
                                          self.known_committed_version,
                                          {}, {}))
        self.disk_queue.commit()

    # -- generation handoff --------------------------------------------------
    def recover_from(self, recover_tags: Dict[Tag, "TLog"],
                     recover_popped: Dict[Tag, Version],
                     recovery_version: Version) -> None:
        """Carry each tag's un-popped data (<= recovery_version) from its
        old-generation holder before serving, and make it durable in this
        generation's queue: once the new core state is written only this
        generation is locked at the next restart.  The holder's entries
        are read with peek_through."""
        for tag, old in recover_tags.items():
            popped = recover_popped.get(tag, 0)
            q = self.tag_data.setdefault(tag, deque())
            for v, msgs in peek_through(old, tag, popped + 1,
                                        recovery_version):
                q.append((v, msgs))
                nbytes = _nbytes(msgs)
                self.bytes_in_memory += nbytes
                self.tag_bytes[tag] = self.tag_bytes.get(tag, 0) + nbytes
            if popped:
                self.poppedtags[tag] = popped
        if self.disk_queue is not None:
            by_version: Dict[Version, Dict[Tag, List[Mutation]]] = {}
            for tag, q in self.tag_data.items():
                for v, msgs in q:
                    by_version.setdefault(v, {})[tag] = msgs
            prev_v = 0
            for v in sorted(by_version):
                seq = self.disk_queue.push(_pack_commit(
                    v, prev_v, self.known_committed_version,
                    dict(self.poppedtags), by_version[v]))
                self._record_seqs.append((v, seq, frozenset(by_version[v])))
                self._seq_of_version[v] = seq
                prev_v = v
            self.disk_queue.commit()
        TraceEvent("TLogRecovered").detail("Id", self.id).detail(
            "Tags", len(recover_tags)).detail(
            "RecoveryVersion", recovery_version).log()

    def lock(self, req: TLogLockRequest) -> None:
        """Epoch end (reference TLogLockResult): stop accepting commits and
        report the end version and each tag's popped version."""
        self.stopped = True
        TraceEvent("TLogLocked").detail("Id", self.id).detail(
            "ByEpoch", req.epoch).detail("End", self.version).log()
        req.reply.send(TLogLockReply(
            end_version=self.version,
            known_committed_version=self.known_committed_version,
            tags=dict(self.poppedtags) | {
                t: self.poppedtags.get(t, 0) for t in self.tag_data}))

    # -- commit (reference tLogCommit :2080) ---------------------------------
    def commit(self, req: TLogCommitRequest) -> None:
        """Append `req`'s version after its predecessor, make it durable
        and reply with the appended version.  A resend of a version
        already appended is answered without a second append."""
        if self.stopped:
            return     # stopped: no reply (the reference drops it)
        if req.prev_version > self.version:
            raise RuntimeError(
                f"tlog {self.id}: version {req.version} arrived before its "
                f"predecessor {req.prev_version} (appended {self.version}): "
                "the log system pushes versions in chain order")
        if req.version > self.version:
            assert self.version == req.prev_version, (
                f"tlog {self.id}: version chain broken "
                f"{self.version} != {req.prev_version}")
            for tag, msgs in req.messages.items():
                if not msgs:
                    continue
                q = self.tag_data.setdefault(tag, deque())
                q.append((req.version, msgs))
                nbytes = _nbytes(msgs)
                self.bytes_input += nbytes
                self.bytes_in_memory += nbytes
                self.tag_bytes[tag] = self.tag_bytes.get(tag, 0) + nbytes
            self.known_committed_version = max(self.known_committed_version,
                                               req.known_committed_version)
            if self.disk_queue is not None:
                seq = self.disk_queue.push(_pack_commit(
                    req.version, req.prev_version,
                    self.known_committed_version, dict(self.poppedtags),
                    req.messages))
                self._record_seqs.append(
                    (req.version, seq, frozenset(req.messages)))
                self._seq_of_version[req.version] = seq
            self.version = req.version
            # Before the sync, as the reference's (only entries already
            # durable can spill).
            self._maybe_spill()
        self._sync()
        req.reply.send(self.version)

    def _sync(self) -> None:
        """The group sync (reference doQueueCommit): one write + fsync of
        every record appended so far before the durable frontier moves to
        the appended version; with no queue it moves at once.  A failing
        write or fsync raises here, the frontier unmoved, and stops the
        role."""
        if self.durable_version >= self.version:
            return
        target = self.version
        if self.disk_queue is not None:
            t0 = perf_counter()
            try:
                self.disk_queue.commit()
            except BaseException:
                # A log that cannot fsync must not ack again: the role is
                # dead from here on, as the reference's process is
                # (_die_on_disk_error), and the error goes to the caller.
                self.stopped = True
                raise
            self.last_sync_s = perf_counter() - t0
        self.durable_version = target
        # Entries appended before this sync are durable now, so a pending
        # overflow can evict them.
        self._maybe_spill()

    # -- spill-by-reference (reference TLogData spill fields :293) -----------
    def _maybe_spill(self) -> None:
        """When resident payload bytes exceed TLOG_SPILL_THRESHOLD, turn
        the oldest DURABLE entries of the heaviest tags into (version,
        seq, bytes) references into the queue, down to 3/4 of the
        threshold: a lagging storage server's backlog then lives on disk
        and its peeks read the queue file."""
        if self.disk_queue is None:
            return
        limit = int(server_knobs().TLOG_SPILL_THRESHOLD)
        if self.bytes_in_memory <= limit:
            return
        durable = self.durable_version
        spilled_bytes = 0
        while self.bytes_in_memory > limit * 3 // 4:
            # Heaviest tag first: that's the laggard filling the heap.
            tag = max(self.tag_bytes, key=lambda t: self.tag_bytes.get(t, 0),
                      default=None)
            if tag is None or self.tag_bytes.get(tag, 0) <= 0:
                break
            q = self.tag_data.get(tag)
            progressed = False
            while q and self.bytes_in_memory > limit * 3 // 4:
                version, msgs = q[0]
                seq = self._seq_of_version.get(version)
                if version > durable or seq is None:
                    break      # only durable records are readable from disk
                q.popleft()
                nbytes = _nbytes(msgs)
                self.bytes_in_memory -= nbytes
                self.tag_bytes[tag] -= nbytes
                spilled_bytes += nbytes
                self.spilled.setdefault(tag, deque()).append(
                    (version, seq, nbytes))
                progressed = True
            if not progressed:
                break          # nothing durable to evict yet
        if spilled_bytes:
            self.bytes_spilled += spilled_bytes
            TraceEvent("TLogSpilled").detail("Id", self.id).detail(
                "Bytes", spilled_bytes).detail(
                "InMemory", self.bytes_in_memory).log()

    # -- peek / pop ----------------------------------------------------------
    def peek(self, req: TLogPeekRequest) -> None:
        """The tag's entries at and after `req.begin`, spilled ones read
        back from the queue file first, within the byte budget: at least
        one entry is always sent, and a reply cut short lowers end and
        max_known_version to the first version not sent, so the puller
        peeks again from there."""
        budget = int(server_knobs().TLOG_PEEK_DESIRED_BYTES)
        out: List[Tuple[Version, List[Mutation]]] = []
        sent_bytes = 0
        cut: Optional[Version] = None
        for v, seq, _nb in self.spilled.get(req.tag) or ():
            if v < req.begin:
                continue
            if sent_bytes >= budget:
                cut = v
                break
            msgs = self._read_spilled(req.tag, v, seq)
            out.append((v, msgs))
            sent_bytes += _nbytes(msgs)
        if cut is None:
            for v, msgs in self.tag_data.get(req.tag) or ():
                if v < req.begin:
                    continue
                if sent_bytes >= budget:
                    cut = v
                    break
                out.append((v, msgs))
                sent_bytes += _nbytes(msgs)
        if cut is not None:
            req.reply.send(TLogPeekReply(messages=out, end=cut,
                                         max_known_version=cut - 1))
        else:
            req.reply.send(TLogPeekReply(
                messages=out, end=self.version + 1,
                max_known_version=self.version))

    def _read_spilled(self, tag: Tag, version: Version,
                      seq: int) -> List[Mutation]:
        """A spilled entry's mutations from its queue record.  A record
        that fails its CRC, or is missing, raises io_error and stops the
        role: the puller must never advance past it."""
        try:
            blob = self.disk_queue.read_payload(seq)
            if blob is None:
                raise err("io_error", f"tlog {self.id}: spilled record "
                          f"{seq} of version {version} is gone")
        except BaseException:
            self.stopped = True
            TraceEvent("TLogDiskError", Severity.Error).detail(
                "Id", self.id).detail("Op", "peek").detail(
                "Seq", seq).log()
            raise
        _v, _p, _k, _pop, messages = _unpack_commit(blob)
        return messages[tag]

    def pop(self, req: TLogPopRequest) -> None:
        prev = self.poppedtags.get(req.tag, 0)
        if req.to > prev:
            self.poppedtags[req.tag] = req.to
            sq = self.spilled.get(req.tag)
            if sq is not None:
                while sq and sq[0][0] <= req.to:
                    _v, _seq, nb = sq.popleft()
                    self.bytes_popped += nb
            q = self.tag_data.get(req.tag)
            if q is not None:
                while q and q[0][0] <= req.to:
                    _v, msgs = q.popleft()
                    nbytes = _nbytes(msgs)
                    self.bytes_in_memory -= nbytes
                    self.bytes_popped += nbytes
                    if req.tag in self.tag_bytes:
                        self.tag_bytes[req.tag] -= nbytes
            self._trim_queue()
        if req.reply is not None:
            req.reply.send(None)

    def _trim_queue(self) -> None:
        """Trim disk records from the front while every tag each record
        carries has popped past it (the trim frontier is persisted with the
        next append -- the reference's lazy page-header popped location).
        TXS_TAG records are popped only at recovery, so a queue holding
        metadata mutations retains everything after the first un-popped
        one."""
        if self.disk_queue is None:
            return
        last_seq = 0
        while self._record_seqs:
            version, seq, tags = self._record_seqs[0]
            if not all(self.poppedtags.get(t, 0) >= version for t in tags):
                break
            self._record_seqs.popleft()
            self._seq_of_version.pop(version, None)
            last_seq = seq
        if last_seq:
            self.disk_queue.pop(last_seq)

    def confirm_running(self, req: TLogConfirmRunningRequest) -> None:
        """The GRV proxy's liveness confirm: answered unless stopped."""
        if not self.stopped:
            req.reply.send(None)

    # -- the serve loops (a process) -----------------------------------------
    async def _serve(self, stream, handler) -> None:
        async for req in stream.queue:
            handler(req)

    async def _serve_commits(self) -> None:
        """commit() each request, holding one whose predecessor has not
        been appended yet until it has (keyed by prev_version); a held
        request's reply breaks when the actor ends."""
        held: Dict[Version, TLogCommitRequest] = {}
        try:
            async for req in self.interface.commit.queue:
                if req.prev_version > self.version and not self.stopped:
                    held[req.prev_version] = req
                    continue
                self.commit(req)
                while self.version in held:
                    self.commit(held.pop(self.version))
        finally:
            for req in held.values():
                req.reply.send_error(err("broken_promise"))

    def run(self, process) -> list:
        """Register the interface's streams on `process` and spawn its
        serve loops there; their futures."""
        for stream in self.interface.streams():
            process.register(stream)
        i = self.interface
        return [
            process.spawn(self._serve_commits(), f"{self.id}.commit"),
            process.spawn(self._serve(i.peek, self.peek), f"{self.id}.peek"),
            process.spawn(self._serve(i.pop, self.pop), f"{self.id}.pop"),
            process.spawn(self._serve(i.confirm_running,
                                      self.confirm_running),
                          f"{self.id}.confirmRunning"),
            process.spawn(self._serve(i.lock, self.lock), f"{self.id}.lock"),
            process.spawn(hold_wait_failure(i.wait_failure),
                          f"{self.id}.waitFailure")]
