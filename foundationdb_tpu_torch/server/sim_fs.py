"""A simulated machine's durable files (a trimmed copy of
foundationdb_tpu/server/sim_fs.py).

Reference: fdbrpc/AsyncFileNonDurable.actor.h -- a file whose writes reach
the disk only at sync, so a power failure loses what was not synced.  The
port's durable roles call their files synchronously (server/real_fs.py's
surface: write, truncate, sync, read, size), so every operation here is
synchronous too and takes no simulated time.  A SimFile keeps the synced
image and the log of writes since the last sync; reads see both, as the
page cache does.  SimFileSystem is a machine's namespace of files, kept
across process reboots and kills, with power_fail_all() dropping every
un-synced write.

Left out: the reference's disk fault profiles (latency spikes, io_error
injection, bit rot), its buggified slow disk and the torn and partial
writes of a power failure (here every un-synced write is dropped, one of
the outcomes the reference draws).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..core.error import err
from ..core.trace import Severity, TraceEvent


class SimFile:
    """One simulated file: the synced image, the current image (synced
    plus un-synced writes) and the un-synced operations in issue order."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.durable = bytearray()
        self.cache = bytearray()
        # ("w", offset, data) or ("t", size, b""), replayed at sync.
        self.pending: List[Tuple[str, int, bytes]] = []
        self.open = True

    def write(self, offset: int, data: bytes) -> None:
        self._check_open()
        data = bytes(data)
        self.pending.append(("w", offset, data))
        self._apply_op(self.cache, "w", offset, data)

    def truncate(self, size: int) -> None:
        self._check_open()
        self.pending.append(("t", size, b""))
        self._apply_op(self.cache, "t", size, b"")

    def sync(self) -> None:
        self._check_open()
        for op, arg, data in self.pending:
            self._apply_op(self.durable, op, arg, data)
        self.pending = []

    def read(self, offset: int, length: int) -> bytes:
        self._check_open()
        return bytes(self.cache[offset:offset + length])

    def size(self) -> int:
        return len(self.cache)

    def close(self) -> None:
        self.open = False

    def _check_open(self) -> None:
        if not self.open:
            raise err("operation_failed", f"file {self.name} closed")

    @staticmethod
    def _apply_op(buf: bytearray, op: str, arg: int, data: bytes) -> None:
        if op == "w":
            if len(buf) < arg + len(data):
                buf.extend(b"\x00" * (arg + len(data) - len(buf)))
            buf[arg:arg + len(data)] = data
        else:
            del buf[arg:]

    def power_fail(self) -> None:
        """Every un-synced operation is lost."""
        lost = len(self.pending)
        self.pending = []
        self.cache = bytearray(self.durable)
        TraceEvent("SimFilePowerFail", Severity.Warn).detail(
            "File", self.name).detail("Lost", lost).log()


class SimFileSystem:
    """A machine's file namespace (RealFileSystem's surface): survives a
    process's kill and reboot; power_fail_all() loses what was not
    synced."""

    def __init__(self) -> None:
        self.by_name: Dict[str, SimFile] = {}

    @property
    def files(self) -> List[str]:
        return sorted(self.by_name)

    def open(self, name: str, create: bool = True) -> SimFile:
        f = self.by_name.get(name)
        if f is None:
            if not create:
                raise err("operation_failed", f"no such file {name}")
            f = self.by_name[name] = SimFile(name)
        f.open = True
        return f

    def exists(self, name: str) -> bool:
        return name in self.by_name

    def size(self, name: str) -> int:
        return self.by_name[name].size()

    def rename(self, old: str, new: str) -> None:
        """Atomic promote: `old` replaces any `new`."""
        f = self.by_name.pop(old, None)
        if f is None:
            raise err("operation_failed", f"no such file {old}")
        f.name = new
        self.by_name[new] = f

    def delete(self, name: str) -> None:
        self.by_name.pop(name, None)

    def sync_dir(self) -> None:
        """Renames and deletes here are durable at once."""

    def close(self) -> None:
        for f in self.by_name.values():
            f.close()

    def power_fail_all(self) -> None:
        for f in self.by_name.values():
            f.power_fail()
