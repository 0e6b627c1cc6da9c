"""Deterministic randomness and the run digest (a copy of
foundationdb_tpu/core/rng.py).

All randomness inside a simulation comes from deterministic_random(), so
a run is reproducible from its seed; nondeterministic_random() is for ids
that must not perturb a replay (reference flow/IRandom.h
g_nondeterministic_random).  The generator makes the same draws as the
reference's for the same seed, and RunDigest gives the same values for
the same fold sequence.  The port's generator and digest are its own, so
the port's draws and folds never touch another package's.
"""

from __future__ import annotations

import math
import os
import random
import struct
import zlib
from collections import deque
from typing import Deque, Optional, Sequence, Tuple, TypeVar

T = TypeVar("T")


class DeterministicRandom:
    def __init__(self, seed: int) -> None:
        self.seed = seed
        self._r = random.Random(seed)

    def random01(self) -> float:
        return self._r.random()

    def random_int(self, lo: int, hi: int) -> int:
        """Uniform integer in [lo, hi) (reference randomInt semantics)."""
        return self._r.randrange(lo, hi)

    def random_int64(self, lo: int, hi: int) -> int:
        return self._r.randrange(lo, hi)

    def random_unique_id(self) -> str:
        return f"{self._r.getrandbits(64):016x}{self._r.getrandbits(64):016x}"

    def random_alpha_numeric(self, length: int) -> str:
        chars = "abcdefghijklmnopqrstuvwxyz0123456789"
        return "".join(self._r.choice(chars) for _ in range(length))

    def random_bytes(self, length: int) -> bytes:
        if not length:
            return b""
        return self._r.getrandbits(8 * length).to_bytes(length, "little")

    def random_choice(self, seq: Sequence[T]) -> T:
        return seq[self.random_int(0, len(seq))]

    def random_skewed_uint32(self, lo: int, hi: int) -> int:
        """Log-uniform in [lo, hi) (reference randomSkewedUInt32)."""
        min_l = math.log2(max(lo, 1))
        max_l = math.log2(hi)
        return min(int(2 ** (min_l + self.random01() * (max_l - min_l))),
                   hi - 1)

    def shuffle(self, lst: list) -> None:
        self._r.shuffle(lst)

    def coinflip(self) -> bool:
        return self.random01() < 0.5

    def unseed(self) -> int:
        """A digest of the generator's final state (the reference's
        'unseed'): two runs that made the same draws end equal, and any
        extra, missing or reordered draw changes it.  Reading it draws
        nothing."""
        return zlib.crc32(repr(self._r.getstate()).encode()) & 0xFFFFFFFF


class RunDigest:
    """A rolling hash of a simulation's schedule: the scheduler folds each
    dispatched (virtual time, task seq) and the tracer each (event type,
    time), so a run that diverges without touching the generator is
    caught too.  Every CHECKPOINT_EVERY folds a checkpoint is kept for
    the first-divergence report of two same-seed runs."""

    CHECKPOINT_EVERY = 1024
    MAX_CHECKPOINTS = 1 << 16

    __slots__ = ("value", "folds", "checkpoints", "last_event")

    def __init__(self) -> None:
        self.value = 0
        self.folds = 0
        # (fold count, digest value, last trace event type, last time)
        self.checkpoints: Deque[Tuple[int, int, str, float]] = deque(
            maxlen=self.MAX_CHECKPOINTS)
        self.last_event = ""

    _TASK = struct.Struct("<dI")

    def fold_task(self, when: float, seq: int) -> None:
        self.value = zlib.crc32(
            self._TASK.pack(when, seq & 0xFFFFFFFF), self.value)
        self.folds += 1
        if self.folds % self.CHECKPOINT_EVERY == 0:
            self.checkpoints.append(
                (self.folds, self.value, self.last_event, when))

    def fold_event(self, name: str, t: float) -> None:
        self.value = zlib.crc32(name.encode(), self.value ^ hash(t) &
                                0xFFFFFFFF)
        self.folds += 1
        self.last_event = name


_run_digest = RunDigest()


def run_digest() -> RunDigest:
    return _run_digest


def reset_run_digest() -> RunDigest:
    """A fresh digest for a new run.  An EventLoop binds the digest that
    is current when it is made, so reset before building the world."""
    global _run_digest
    _run_digest = RunDigest()
    return _run_digest


def run_unseed() -> int:
    """The run's unseed: the generator's final state folded with the
    schedule digest; equal across two runs iff both the draws and the
    dispatched schedule and trace stream were."""
    return (deterministic_random().unseed() ^
            (_run_digest.value * 0x9E3779B1 & 0xFFFFFFFF))


_det: Optional[DeterministicRandom] = None
# Seeded from the OS: its ids differ across processes and runs, which is
# what they are for.
_nondet = DeterministicRandom(int.from_bytes(os.urandom(8), "little"))


def set_deterministic_random(rng: DeterministicRandom) -> None:
    global _det
    _det = rng


def deterministic_random() -> DeterministicRandom:
    global _det
    if _det is None:
        _det = DeterministicRandom(1)
    return _det


def nondeterministic_random() -> DeterministicRandom:
    return _nondet
