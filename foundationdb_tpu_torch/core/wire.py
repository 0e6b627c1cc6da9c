"""Binary wire-format primitives: length-prefixed, little-endian (the port
of foundationdb_tpu/core/wire.py's Writer and Reader).

Reference: flow/serialize.h — the "classic" serializer writes fields in
declaration order as fixed-width little-endian integers and length-prefixed
byte strings, producing a byte-order-stable format shared by the transport
and every durable file (DiskQueue payloads, coordinated state).  This module
is the Python analog: an explicit Writer/Reader pair (no reflection, no
pickling), which the port uses for the TLog's commit records
(server/tlog.py), the shard map's team values (server/system_data.py)
and the RPC frames (rpc/serde.py), whose columnar key streams take
longest_common_prefix_len.
"""

from __future__ import annotations

import struct

_U8 = struct.Struct("<B")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")


class Writer:
    def __init__(self) -> None:
        self._parts: list = []

    def u8(self, v: int) -> "Writer":
        self._parts.append(_U8.pack(v))
        return self

    def u16(self, v: int) -> "Writer":
        self._parts.append(_U16.pack(v))
        return self

    def u32(self, v: int) -> "Writer":
        self._parts.append(_U32.pack(v))
        return self

    def i64(self, v: int) -> "Writer":
        self._parts.append(_I64.pack(v))
        return self

    def bytes_(self, b: bytes) -> "Writer":
        self._parts.append(_U32.pack(len(b)))
        self._parts.append(bytes(b))
        return self

    def str_(self, s: str) -> "Writer":
        return self.bytes_(s.encode("utf-8"))

    def done(self) -> bytes:
        return b"".join(self._parts)


class Reader:
    def __init__(self, data: bytes) -> None:
        self._d = data
        self._o = 0

    def u8(self) -> int:
        v = _U8.unpack_from(self._d, self._o)[0]
        self._o += 1
        return v

    def u16(self) -> int:
        v = _U16.unpack_from(self._d, self._o)[0]
        self._o += 2
        return v

    def u32(self) -> int:
        v = _U32.unpack_from(self._d, self._o)[0]
        self._o += 4
        return v

    def i64(self) -> int:
        v = _I64.unpack_from(self._d, self._o)[0]
        self._o += 8
        return v

    def bytes_(self) -> bytes:
        n = self.u32()
        b = self._d[self._o:self._o + n]
        self._o += n
        return b

    def str_(self) -> str:
        return self.bytes_().decode("utf-8")

    def at_end(self) -> bool:
        return self._o >= len(self._d)


def longest_common_prefix_len(a: bytes, b: bytes) -> int:
    """Length of the longest common prefix, by binary search over slice
    compares (no per-byte Python loop); the columnar frames'
    prefix-truncated key streams (rpc/serde.py)."""
    n = min(len(a), len(b))
    if n == 0 or a[:1] != b[:1]:
        return 0
    if a[:n] == b[:n]:
        return n
    lo, hi = 1, n - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if a[:mid] == b[:mid]:
            lo = mid
        else:
            hi = mid - 1
    return lo
