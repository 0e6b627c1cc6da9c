"""A durable file on the real filesystem (trimmed copy of
foundationdb_tpu/server/real_fs.py).

Reference: fdbrpc/IAsyncFile.h served by AsyncFileKAIO (real disk).  The
port's roles answer within the call, so every operation here is
synchronous, sync() included: a DiskQueue commit (server/disk_queue.py)
returns only once its bytes are on disk, and an OSError from the write or
the fsync propagates to the caller.  Kept: RealFile whole.  The
reference's RealFileSystem (a directory's open, rename and delete) serves
its worker processes and storage engines' checkpoints, which the port
does not have: the caller names each file's path.
"""

from __future__ import annotations

import os

from ..core.error import err


class RealFile:
    """One file opened read-write; pwrite/pread + fsync."""

    def __init__(self, path: str, name: str) -> None:
        self.name = name
        self._path = path
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        self.open = True

    def write(self, offset: int, data: bytes) -> None:
        self._check_open()
        os.pwrite(self._fd, bytes(data), offset)

    def truncate(self, size: int) -> None:
        self._check_open()
        os.ftruncate(self._fd, size)

    def sync(self) -> None:
        self._check_open()
        os.fsync(self._fd)

    def read(self, offset: int, length: int) -> bytes:
        self._check_open()
        return os.pread(self._fd, length, offset)

    def size(self) -> int:
        return os.fstat(self._fd).st_size

    def _check_open(self) -> None:
        if not self.open:
            raise err("operation_failed", f"file {self.name} closed")

    def close(self) -> None:
        if self.open:
            self.open = False
            os.close(self._fd)

