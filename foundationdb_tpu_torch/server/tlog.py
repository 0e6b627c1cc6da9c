"""TLog: the write-ahead log role -- version-ordered append, per-tag peek
and pop (trimmed copy of foundationdb_tpu/server/tlog.py).

Reference: fdbserver/TLogServer.actor.cpp -- tLogCommit (:2080) appends a
version's messages in prev->version chain order and fsyncs (doQueueCommit
:1966); tLogPeekMessages (:1584) serves per-tag cursors for storage-server
pulls; pop trims acknowledged prefixes per tag.  Messages stay resident in
memory; with a DiskQueue every commit is also a record in it, written and
fsynced before the durable frontier moves past its version.

The role answers within the call: commit() finds its predecessor already
appended, because the log system pushes versions in chain order (a gap
raises instead of parking), and syncs before it replies, so the reply is
the durable version.  A write or fsync that fails raises out of commit()
with nothing acknowledged (the reference's _die_on_disk_error).  peek()
answers with what the log holds at once (the reference parks a peek
above its version until a commit arrives; here the puller stops).

Left out for a later slice: spilling to the queue file (_maybe_spill and
the spilled branch of peek), recovery (from_disk, write_genesis,
recover_from, the lock), the queuing metrics, the commit-debug spans and
the latency bands.
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
from .interfaces import (Tag, TLogCommitRequest, TLogConfirmRunningRequest,
                         TLogPeekReply, TLogPeekRequest, TLogPopRequest)

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


class TLog:
    def __init__(self, tlog_id: str = "log0",
                 recovery_version: Version = 0,
                 disk_queue: Optional[DiskQueue] = None) -> None:
        self.id = tlog_id
        self.version: Version = recovery_version          # appended
        self.durable_version: Version = recovery_version  # fsynced
        self.known_committed_version: Version = recovery_version
        # tag -> deque of (version, mutations), version-ascending.
        self.tag_data: Dict[Tag, Deque[Tuple[Version, List[Mutation]]]] = {}
        self.poppedtags: Dict[Tag, Version] = {}
        self.bytes_input = 0
        # Set when the queue's write or fsync failed; a stopped log drops
        # every commit and confirm (the reference's lock sets it too).
        self.stopped = False
        # None: memory only, and the durable frontier moves at once.
        self.disk_queue = disk_queue
        # (version, queue seq, tags in record) per pushed record, for
        # pop-driven trimming.
        self._record_seqs: Deque[Tuple[Version, int, frozenset]] = deque()
        # Seconds of the last commit's write + fsync of the queue.
        self.last_sync_s = 0.0

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
                self.bytes_input += _nbytes(msgs)
            self.known_committed_version = max(self.known_committed_version,
                                               req.known_committed_version)
            if self.disk_queue is not None:
                seq = self.disk_queue.push(_pack_commit(
                    req.version, req.prev_version,
                    self.known_committed_version, dict(self.poppedtags),
                    req.messages))
                self._record_seqs.append(
                    (req.version, seq, frozenset(req.messages)))
            self.version = req.version
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

    # -- peek / pop ----------------------------------------------------------
    def peek(self, req: TLogPeekRequest) -> None:
        """The tag's entries at and after `req.begin`, within the byte
        budget: at least one entry is always sent, and a reply cut short
        lowers end and max_known_version to the first version not sent,
        so the puller peeks again from there."""
        budget = int(server_knobs().TLOG_PEEK_DESIRED_BYTES)
        out: List[Tuple[Version, List[Mutation]]] = []
        sent_bytes = 0
        cut: Optional[Version] = None
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

    def pop(self, req: TLogPopRequest) -> None:
        prev = self.poppedtags.get(req.tag, 0)
        if req.to > prev:
            self.poppedtags[req.tag] = req.to
            q = self.tag_data.get(req.tag)
            if q is not None:
                while q and q[0][0] <= req.to:
                    q.popleft()
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
            last_seq = seq
        if last_seq:
            self.disk_queue.pop(last_seq)

    def confirm_running(self, req: TLogConfirmRunningRequest) -> None:
        """The GRV proxy's liveness confirm: answered unless stopped."""
        if not self.stopped:
            req.reply.send(None)
