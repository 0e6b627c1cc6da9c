"""Durable files on the real filesystem (the port of
foundationdb_tpu/server/real_fs.py, whole).

Reference: fdbrpc/IAsyncFile.h served by AsyncFileKAIO (real disk).  The
port's roles answer within the call, so every operation here is
synchronous, sync() included: a DiskQueue commit (server/disk_queue.py)
returns only once its bytes are on disk, and an OSError from the write or
the fsync propagates to the caller.  RealFile is one file; RealFileSystem
is a data directory as the durable namespace of a cluster's roles: the
TLogs' queues (tlog-<id>.wal), the storage engines' files
(storage-<tag>.wal, .snap, .btree) and the core state, opened, listed,
renamed and deleted by name (server/worker.py's boot scan, the memory
engine's snapshot promote).
"""

from __future__ import annotations

import os
from typing import List

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



class RealFileSystem:
    """A directory as the durable namespace of a cluster's roles."""

    def __init__(self, datadir: str) -> None:
        self.datadir = datadir
        os.makedirs(datadir, exist_ok=True)
        self._open_files = {}

    @property
    def files(self) -> List[str]:
        return sorted(os.listdir(self.datadir))

    def _path(self, name: str) -> str:
        # Durable role files are flat names (tlog-X.wal, storage-N.btree);
        # refuse anything that would escape the datadir.
        if "/" in name or name.startswith("."):
            raise err("operation_failed", f"bad file name {name!r}")
        return os.path.join(self.datadir, name)

    def open(self, name: str, create: bool = True) -> RealFile:
        f = self._open_files.get(name)
        if f is not None and f.open:
            return f
        path = self._path(name)
        if not create and not os.path.exists(path):
            raise err("operation_failed", f"no such file {name}")
        f = RealFile(path, name)
        self._open_files[name] = f
        return f

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))

    def size(self, name: str) -> int:
        return os.stat(self._path(name)).st_size

    def sync_dir(self) -> None:
        """fsync the directory itself: a rename or unlink in it is durable
        once this returns."""
        fd = os.open(self.datadir, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def rename(self, old: str, new: str) -> None:
        """Atomic promote via os.replace.  The moved file's open handle
        stays valid (same inode); a previously-open handle of the
        REPLACED target becomes an orphan (delete semantics) and is
        dropped from the open-file table so later opens see the new
        inode, never the orphan."""
        f = self._open_files.pop(old, None)
        os.replace(self._path(old), self._path(new))
        if f is not None:
            f.name = new
            self._open_files[new] = f
        else:
            self._open_files.pop(new, None)

    def delete(self, name: str) -> None:
        """POSIX unlink: an already OPEN handle stays valid (writes go to
        the orphaned inode)."""
        self._open_files.pop(name, None)
        try:
            os.unlink(self._path(name))
        except FileNotFoundError:
            pass

    def close(self) -> None:
        """Close every file this namespace opened (a clean shutdown; a
        killed cluster drops it instead)."""
        for f in self._open_files.values():
            f.close()
        self._open_files = {}
