"""The native C++ conflict set, through ctypes over a C interface (a copy
of foundationdb_tpu/conflict/native.py).

The CPU engine the reference keeps as fdbserver/SkipList.cpp, here an
ordered boundary map compiled from conflict/native_src/conflict.cpp.  The
library is built from that source with g++ at first use, as the port
builds its CUDA kernels (kernels/__init__.py): into build/native/ beside
the package, never next to the source, through a temporary file renamed
into place; a failed build raises with the compiler's stderr.  Its
verdicts equal the oracle's for well-formed ranges; degenerate ranges
(begin >= end) are dropped before encoding, with the read presence kept
for the too-old rule.  It is host code: no device, no kernel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence

from ..core.wire import Writer
from ..txn.types import CommitResult, CommitTransactionRef, Version
from .api import ConflictSet

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "conflict", "native_src", "conflict.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
SO = os.path.join(BUILD_DIR, "libconflict.so")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()


def build() -> ctypes.CDLL:
    """Compile conflict.cpp into build/native/libconflict.so when the
    library is missing or older than its source, and load it (once a
    process)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(SO) or \
                os.path.getmtime(SO) < os.path.getmtime(SRC):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{SO}.{os.getpid()}.tmp"
            proc = subprocess.run(["g++", *CXX_FLAGS, SRC, "-o", tmp],
                                  capture_output=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    "g++ failed on conflict.cpp:\n" +
                    proc.stderr.decode(errors="replace") +
                    proc.stdout.decode(errors="replace"))
            os.replace(tmp, SO)
        lib = ctypes.CDLL(SO)
        lib.cs_new.restype = ctypes.c_void_p
        lib.cs_new.argtypes = [ctypes.c_int64]
        lib.cs_free.argtypes = [ctypes.c_void_p]
        lib.cs_segment_count.restype = ctypes.c_int64
        lib.cs_segment_count.argtypes = [ctypes.c_void_p]
        lib.cs_resolve.restype = ctypes.c_int
        lib.cs_resolve.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int64, ctypes.c_char_p]
        _lib = lib
        return lib


class NativeConflictSet(ConflictSet):
    # The ctypes call blocks the calling thread for the whole batch; the
    # resolver routes it through core/threadpool.run_blocking.
    offload_blocking = True

    def __init__(self, oldest_version: Version = 0) -> None:
        super().__init__(oldest_version)
        self._lib = build()
        self._h = self._lib.cs_new(oldest_version)

    def __del__(self):  # noqa: D105
        if getattr(self, "_h", None):
            self._lib.cs_free(self._h)
            self._h = None

    def resolve(self, transactions: Sequence[CommitTransactionRef],
                now: Version,
                new_oldest_version: Optional[Version] = None
                ) -> List[CommitResult]:
        new_floor = max(new_oldest_version or self.oldest_version,
                        self.oldest_version)
        w = Writer().i64(now).i64(new_floor).u32(len(transactions))
        for t in transactions:
            w.i64(t.read_snapshot)
            reads = [r for r in t.read_conflict_ranges if r.begin < r.end]
            # Unfiltered read presence: the too-old rule counts a txn as
            # reading even if all its ranges are degenerate (the oracle's
            # contract).
            w.u8(1 if t.read_conflict_ranges else 0)
            w.u32(len(reads))
            for r in reads:
                w.bytes_(r.begin).bytes_(r.end)
            writes = [x for x in t.write_conflict_ranges if x.begin < x.end]
            w.u32(len(writes))
            for x in writes:
                w.bytes_(x.begin).bytes_(x.end)
        req = w.done()
        out = ctypes.create_string_buffer(max(len(transactions), 1))
        rc = self._lib.cs_resolve(self._h, req, len(req), out)
        if rc != 0:
            raise RuntimeError(f"native cs_resolve failed: {rc}")
        self.oldest_version = new_floor
        return [CommitResult(b) for b in out.raw[:len(transactions)]]

    def segment_count(self) -> int:
        return int(self._lib.cs_segment_count(self._h))
