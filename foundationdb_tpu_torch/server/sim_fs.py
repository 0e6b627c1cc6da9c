"""A simulated machine's durable files (a trimmed copy of
foundationdb_tpu/server/sim_fs.py).

Reference: fdbrpc/AsyncFileNonDurable.actor.h -- a file whose writes reach
the disk only at sync, so a power failure loses what was not synced.  The
port's durable roles call their files synchronously (server/real_fs.py's
surface: write, truncate, sync, read, size), so every operation here is
synchronous too and takes no simulated time.  A SimFile keeps the synced
image and the log of writes since the last sync; reads see both, as the
page cache does.  SimFileSystem is a machine's namespace of files, kept
across process reboots and kills.

Faults, drawn from the deterministic generator so a failing seed replays
them (reference AsyncFileNonDurable and its diskFailureInjector):
  * a DiskFaultProfile (:28) on a file: io_error on a read, a write or a
    sync, up to a budget, and bit rot after a successful sync (one bit of
    the durable image flipped, for the readers' checksums to catch);
    SimFileSystem.set_fault_profile attaches one by file name,
    clear_fault_profiles removes them all;
  * a power failure (power_fail_all): each un-synced operation is kept,
    dropped, or (a write) torn to a prefix that may have a bit flipped,
    as the reference draws them (:511-552).
The draws are the reference's, in its order, for the same seed.  The
port's files take no simulated time, so a profile's latency spike is
only drawn (keeping that order) and counted in `latency_spikes`: it has
no duration to wait.  The reference's buggified slow disk is left out
for the same reason.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..core.buggify import buggify
from ..core.coverage import test_coverage
from ..core.error import err
from ..core.rng import deterministic_random
from ..core.trace import Severity, TraceEvent


@dataclass
class DiskFaultProfile:
    """One file's live faults.  io_error_*_p: the chance an operation
    raises io_error (fatal to the role above, which is what the chaos
    tests hold); bitrot_sync_p: the chance a successful sync then flips
    one bit of the durable image; max_io_errors: the budget of io_errors
    (so a test can inject exactly one and let the restarted process
    recover on a healthy disk); latency_spike_p: the chance of a spike
    (see the module docstring)."""

    io_error_read_p: float = 0.0
    io_error_write_p: float = 0.0
    io_error_sync_p: float = 0.0
    latency_spike_p: float = 0.0
    bitrot_sync_p: float = 0.0
    max_io_errors: int = 1 << 30

    @classmethod
    def from_knobs(cls) -> "DiskFaultProfile":
        """The ambient profile BUGGIFY attaches to fresh files: latency
        spikes only (io_error and bit rot are injected on purpose, where
        the topology can absorb a death)."""
        from ..core.knobs import server_knobs
        k = server_knobs()
        return cls(latency_spike_p=k.SIM_DISK_LATENCY_SPIKE_P)


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
        # Live faults (None: a healthy disk).
        self.faults: Optional[DiskFaultProfile] = None
        self.io_errors_injected = 0
        self.latency_spikes = 0

    # -- fault injection -----------------------------------------------------
    def _should_io_error(self, kind: str) -> bool:
        """The profile's chance for `kind`, within the io_error budget;
        draws only when a profile is attached."""
        f = self.faults
        if f is None:
            return False
        p = getattr(f, f"io_error_{kind}_p")
        if not p or self.io_errors_injected >= f.max_io_errors:
            return False
        if deterministic_random().random01() >= p:
            return False
        self.io_errors_injected += 1
        return True

    def _fault_point(self, kind: str) -> None:
        """A write's or a sync's faults: the latency draw, then io_error."""
        f = self.faults
        if f is not None and f.latency_spike_p and \
                deterministic_random().random01() < f.latency_spike_p:
            self.latency_spikes += 1
        if self._should_io_error(kind):
            self._raise_io_error(kind)

    def _raise_io_error(self, kind: str) -> None:
        test_coverage("SimDiskIoErrorInjected")
        TraceEvent("SimDiskIoError", Severity.Warn).detail(
            "File", self.name).detail("Op", kind).log()
        raise err("io_error", f"injected {kind} error on {self.name}")

    def _maybe_bitrot(self) -> None:
        """After a sync: flip one bit somewhere in the durable image (and
        the page cache's view of it), damage only checksums can catch."""
        f = self.faults
        if f is None or not f.bitrot_sync_p or not self.durable:
            return
        rng = deterministic_random()
        if rng.random01() >= f.bitrot_sync_p:
            return
        i = rng.random_int(0, len(self.durable))
        bit = 1 << rng.random_int(0, 8)
        self.durable[i] ^= bit
        self.cache[i] ^= bit
        test_coverage("SimDiskBitRotInjected")
        TraceEvent("SimDiskBitRot", Severity.Warn).detail(
            "File", self.name).detail("Offset", i).log()

    # -- the file surface ----------------------------------------------------
    def write(self, offset: int, data: bytes) -> None:
        self._check_open()
        self._fault_point("write")
        data = bytes(data)
        self.pending.append(("w", offset, data))
        self._apply_op(self.cache, "w", offset, data)

    def truncate(self, size: int) -> None:
        self._check_open()
        self.pending.append(("t", size, b""))
        self._apply_op(self.cache, "t", size, b"")

    def sync(self) -> None:
        self._check_open()
        self._fault_point("sync")
        for op, arg, data in self.pending:
            self._apply_op(self.durable, op, arg, data)
        self.pending = []
        self._maybe_bitrot()

    def read(self, offset: int, length: int) -> bytes:
        self._check_open()
        if self._should_io_error("read"):
            self._raise_io_error("read")
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
        """Each un-synced operation, in issue order, reached the disk,
        was dropped or (a write) was torn to a prefix, a bit of which may
        be flipped (reference :511-552)."""
        rng = deterministic_random()
        survived = 0
        for op, arg, data in self.pending:
            roll = rng.random01()
            if op == "t":
                # Metadata: reached the disk or not.
                if roll < 0.5:
                    self._apply_op(self.durable, op, arg, data)
                    survived += 1
                continue
            if roll < 0.5:
                self._apply_op(self.durable, op, arg, data)    # made it
                survived += 1
            elif roll < 0.8:
                continue                                       # dropped
            else:                                              # torn
                cut = rng.random_int(0, len(data) + 1)
                garbled = bytearray(data[:cut])
                if garbled and rng.random01() < 0.5:
                    i = rng.random_int(0, len(garbled))
                    garbled[i] ^= 1 << rng.random_int(0, 8)
                if garbled:
                    self._apply_op(self.durable, op, arg, bytes(garbled))
                    survived += 1
        self.pending = []
        self.cache = bytearray(self.durable)
        TraceEvent("SimFilePowerFail", Severity.Warn).detail(
            "File", self.name).detail("Survived", survived).log()


class SimFileSystem:
    """A machine's file namespace (RealFileSystem's surface): survives a
    process's kill and reboot; power_fail_all() loses what was not
    synced."""

    def __init__(self) -> None:
        self.by_name: Dict[str, SimFile] = {}
        # (name substring, profile): "" matches every file; covers files
        # opened before and after the rule.
        self._fault_rules: List[Tuple[str, Optional[DiskFaultProfile]]] = []

    def set_fault_profile(self, name_substr: str,
                          profile: Optional[DiskFaultProfile]) -> None:
        """Attach `profile` (None detaches) to every file whose name
        contains `name_substr`."""
        self._fault_rules.append((name_substr, profile))
        for name, f in self.by_name.items():
            if name_substr in name:
                f.faults = profile

    def clear_fault_profiles(self) -> None:
        self._fault_rules.clear()
        for f in self.by_name.values():
            f.faults = None

    @property
    def files(self) -> List[str]:
        return sorted(self.by_name)

    def open(self, name: str, create: bool = True) -> SimFile:
        f = self.by_name.get(name)
        if f is None:
            if not create:
                raise err("operation_failed", f"no such file {name}")
            f = self.by_name[name] = SimFile(name)
            # The ambient faults when the site fires; explicit rules win.
            if buggify("sim_fs.fault_profile"):
                f.faults = DiskFaultProfile.from_knobs()
            for substr, profile in self._fault_rules:
                if substr in name:
                    f.faults = profile
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
        for substr, profile in self._fault_rules:
            if substr in new:
                f.faults = profile

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
