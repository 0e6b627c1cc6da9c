"""Atomic mutation operators, matching the reference bit-for-bit (the port
of foundationdb_tpu/txn/atomic.py, whole).

Reference: fdbclient/Atomic.h (doLittleEndianAdd, doAnd/doAndV2, doOr,
doXor, doAppendIfFits, doMin/doMinV2, doMax, doByteMin, doByteMax,
doCompareAndClear).  Applied by storage servers when ingesting mutations
(server/storage.py).  `existing=None` means the key is absent; a returned
None means the key becomes absent (CompareAndClear).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from .types import MutationType

VALUE_SIZE_LIMIT = 100_000  # reference CLIENT_KNOBS->VALUE_SIZE_LIMIT


def do_little_endian_add(existing: Optional[bytes], operand: bytes) -> bytes:
    existing = existing or b""
    if not existing or not operand:
        return operand
    out = bytearray(len(operand))
    carry = 0
    n = min(len(existing), len(operand))
    for i in range(n):
        s = existing[i] + operand[i] + carry
        out[i] = s & 0xFF
        carry = s >> 8
    for i in range(n, len(operand)):
        s = operand[i] + carry
        out[i] = s & 0xFF
        carry = s >> 8
    return bytes(out)


def do_and(existing: Optional[bytes], operand: bytes) -> bytes:
    existing = existing or b""
    if not operand:
        return operand
    n = min(len(existing), len(operand))
    out = bytearray(len(operand))   # tail beyond existing stays zero
    for i in range(n):
        out[i] = existing[i] & operand[i]
    return bytes(out)


def do_and_v2(existing: Optional[bytes], operand: bytes) -> bytes:
    if existing is None:
        return operand
    return do_and(existing, operand)


def do_or(existing: Optional[bytes], operand: bytes) -> bytes:
    existing = existing or b""
    if not existing or not operand:
        return operand
    n = min(len(existing), len(operand))
    out = bytearray(operand)
    for i in range(n):
        out[i] = existing[i] | operand[i]
    return bytes(out)


def do_xor(existing: Optional[bytes], operand: bytes) -> bytes:
    existing = existing or b""
    if not existing or not operand:
        return operand
    n = min(len(existing), len(operand))
    out = bytearray(operand)
    for i in range(n):
        out[i] = existing[i] ^ operand[i]
    return bytes(out)


def do_append_if_fits(existing: Optional[bytes], operand: bytes) -> bytes:
    existing = existing or b""
    if not existing:
        return operand
    if not operand:
        return existing
    if len(existing) + len(operand) > VALUE_SIZE_LIMIT:
        return existing
    return existing + operand


def _le_truncated_existing(existing: bytes, operand: bytes) -> bytes:
    """existing truncated/zero-padded to operand length (doMax/doMin reply)."""
    out = bytearray(len(operand))
    n = min(len(existing), len(operand))
    out[:n] = existing[:n]
    return bytes(out)


def do_max(existing: Optional[bytes], operand: bytes) -> bytes:
    existing = existing or b""
    if not existing or not operand:
        return operand
    # Compare as little-endian unsigned ints of operand's width.
    for i in range(len(operand) - 1, len(existing) - 1, -1):
        if operand[i] != 0:
            return operand
    for i in range(min(len(operand), len(existing)) - 1, -1, -1):
        if operand[i] > existing[i]:
            return operand
        if operand[i] < existing[i]:
            return _le_truncated_existing(existing, operand)
    return operand


def do_min(existing: Optional[bytes], operand: bytes) -> bytes:
    if not operand:
        return operand
    existing = existing or b""
    for i in range(len(operand) - 1, len(existing) - 1, -1):
        if operand[i] != 0:
            return _le_truncated_existing(existing, operand)
    for i in range(min(len(operand), len(existing)) - 1, -1, -1):
        if operand[i] > existing[i]:
            return _le_truncated_existing(existing, operand)
        if operand[i] < existing[i]:
            return operand
    return operand


def do_min_v2(existing: Optional[bytes], operand: bytes) -> bytes:
    if existing is None:
        return operand
    return do_min(existing, operand)


def do_byte_max(existing: Optional[bytes], operand: bytes) -> bytes:
    if existing is None:
        return operand
    return existing if existing > operand else operand


def do_byte_min(existing: Optional[bytes], operand: bytes) -> bytes:
    if existing is None:
        return operand
    return existing if existing < operand else operand


def do_compare_and_clear(existing: Optional[bytes],
                         operand: bytes) -> Optional[bytes]:
    if existing is None or existing == operand:
        return None
    return existing


_OPS: Dict[MutationType, Callable[[Optional[bytes], bytes], Optional[bytes]]] = {
    MutationType.AddValue: do_little_endian_add,
    MutationType.And: do_and,
    MutationType.AndV2: do_and_v2,
    MutationType.Or: do_or,
    MutationType.Xor: do_xor,
    MutationType.AppendIfFits: do_append_if_fits,
    MutationType.Max: do_max,
    MutationType.Min: do_min,
    MutationType.MinV2: do_min_v2,
    MutationType.ByteMax: do_byte_max,
    MutationType.ByteMin: do_byte_min,
    MutationType.CompareAndClear: do_compare_and_clear,
}


def apply_atomic(op: MutationType, existing: Optional[bytes],
                 operand: bytes) -> Optional[bytes]:
    """Apply atomic op; returns new value or None (key cleared)."""
    fn = _OPS.get(op)
    if fn is None:
        raise ValueError(f"not an atomic op: {op!r}")
    return fn(existing, operand)
