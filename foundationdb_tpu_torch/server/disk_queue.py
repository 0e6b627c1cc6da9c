"""DiskQueue: a durable, checksummed log of records with recovery scan (the
port of foundationdb_tpu/server/disk_queue.py, whole).

Reference: fdbserver/DiskQueue.actor.cpp (+ IDiskQueue.h) -- the durable
ring buffer under the TLog: records are appended with checksums, commit()
makes the prefix durable (fsync), pop() trims acknowledged prefixes, and
recovery scans forward validating checksums, stopping at the first
torn/corrupt record -- so exactly a durable PREFIX of pushed records
survives a power loss.

Record framing (little-endian): MAGIC:2 | seq:8 | popped:8 | len:4 | crc:4
| payload.  `popped` persists the trim frontier piggybacked on appends
(the reference stores it in page headers).  The crc spans the header
fields AND the payload, so bit-rot anywhere in a frame -- including the
trim frontier -- fails validation.

The file is anything with the RealFile surface (server/real_fs.py):
write, read, truncate, sync and size, each synchronous, so the queue's
methods are too (the reference's awaits them).  A failed write or sync
raises out of commit(): the caller must not treat the records as durable.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

from ..core.coverage import test_coverage
from ..core.error import err
from ..core.trace import Severity, TraceEvent

_MAGIC = 0xFDB1
_HDR = struct.Struct("<HQQII")
# The CRC covers the header fields AND the payload (reference DiskQueue
# page checksums span the whole page): a bit flipped in `popped` or
# `seq` must be as detectable as one in the payload.
_HDR_CRC = struct.Struct("<HQQI")


def _frame_crc(seq: int, popped: int, payload: bytes) -> int:
    return zlib.crc32(payload, zlib.crc32(
        _HDR_CRC.pack(_MAGIC, seq, popped, len(payload))))


class DiskQueue:
    def __init__(self, file) -> None:
        self.file = file
        self.next_seq = 1
        self.popped_seq = 0          # records <= this are logically gone
        self._write_offset = 0
        self._pending: List[bytes] = []
        # seq -> (payload offset, payload length): random access by seq.
        # Entries drop at pop().
        self._index: dict = {}
        self._pending_offset = 0

    # -- write path ----------------------------------------------------------
    def push(self, payload: bytes) -> int:
        """Append one record (buffered until commit); returns its seq."""
        seq = self.next_seq
        self.next_seq += 1
        crc = _frame_crc(seq, self.popped_seq, payload)
        frame = _HDR.pack(_MAGIC, seq, self.popped_seq,
                          len(payload), crc) + payload
        self._index[seq] = (self._write_offset + self._pending_offset +
                            _HDR.size, len(payload))
        self._pending_offset += len(frame)
        self._pending.append(frame)
        return seq

    def read_payload(self, seq: int) -> Optional[bytes]:
        """Read one DURABLE record's payload by seq; None if unknown or
        already popped.  The frame's CRC is re-verified on every read:
        corruption raises io_error."""
        loc = self._index.get(seq)
        if loc is None or seq <= self.popped_seq:
            return None
        offset, length = loc
        if offset + length > self._write_offset:
            return None            # not yet committed to the file
        hdr = self.file.read(offset - _HDR.size, _HDR.size)
        payload = self.file.read(offset, length)
        magic, hseq, popped, hlen, crc = _HDR.unpack(hdr)
        if magic != _MAGIC or hseq != seq or hlen != length or \
                _frame_crc(hseq, popped, payload) != crc:
            test_coverage("DiskQueueCrcCaught")
            TraceEvent("DiskQueueCorruptRecord", Severity.Error).detail(
                "File", self.file.name).detail("Seq", seq).detail(
                "Offset", offset).log()
            raise err("io_error",
                      f"disk queue record {seq} failed CRC in "
                      f"{self.file.name}")
        return payload

    def commit(self) -> None:
        """Write buffered records and fsync (reference group commit)."""
        if self._pending:
            blob = b"".join(self._pending)
            self._pending = []
            self._pending_offset = 0
            self.file.write(self._write_offset, blob)
            self._write_offset += len(blob)
        self.file.sync()

    def pop(self, up_to_seq: int) -> None:
        """Trim records <= seq (durably recorded with the NEXT append, as
        in the reference's lazy page-header update)."""
        if up_to_seq > self.popped_seq:
            self.popped_seq = up_to_seq
            for seq in [s for s in self._index if s <= up_to_seq]:
                del self._index[seq]

    # -- recovery (reference recovery scan) ----------------------------------
    def recover(self) -> List[Tuple[int, bytes]]:
        """Scan from the start; return surviving un-popped records in order.
        Stops at the first invalid/torn record: everything before it was
        durable, everything after never fully reached disk."""
        size = self.file.size()
        offset = 0
        records: List[Tuple[int, bytes]] = []
        max_popped = 0
        last_seq = 0
        while offset + _HDR.size <= size:
            hdr = self.file.read(offset, _HDR.size)
            magic, seq, popped, length, crc = _HDR.unpack(hdr)
            if magic != _MAGIC or seq != last_seq + 1:
                break
            if offset + _HDR.size + length > size:
                break                      # torn tail
            payload = self.file.read(offset + _HDR.size, length)
            if _frame_crc(seq, popped, payload) != crc:
                # Corrupt record: recovery keeps the valid prefix only.
                test_coverage("DiskQueueCrcCaught")
                TraceEvent("DiskQueueCrcMismatch", Severity.Warn).detail(
                    "File", self.file.name).detail("Seq", seq).log()
                break                      # corrupt tail
            records.append((seq, payload))
            self._index[seq] = (offset + _HDR.size, length)
            max_popped = max(max_popped, popped)
            last_seq = seq
            offset += _HDR.size + length
        self.next_seq = last_seq + 1
        self.popped_seq = max_popped
        for seq in [s for s in self._index if s <= max_popped]:
            del self._index[seq]
        self._write_offset = offset
        # Anything beyond the valid prefix is garbage from a torn write:
        # discard it so future appends are consistent.
        self.file.truncate(offset)
        self.file.sync()
        out = [(s, p) for s, p in records if s > max_popped]
        TraceEvent("DiskQueueRecovered").detail(
            "File", self.file.name).detail("Records", len(out)).detail(
            "NextSeq", self.next_seq).detail("Popped", max_popped).log()
        return out
