"""Deterministic randomness (trimmed copy of foundationdb_tpu/core/rng.py).

What core/buggify.py and the simulated network draw from: a seeded
generator (the same draws as the reference's for the same seed) and the
process-wide instance, which a simulation seeds with
set_deterministic_random.  The port's generator is its own, so the
port's draws never touch another package's random state.
"""

from __future__ import annotations

import random
from typing import Optional


class DeterministicRandom:
    def __init__(self, seed: int) -> None:
        self.seed = seed
        self._r = random.Random(seed)

    def random01(self) -> float:
        return self._r.random()

    def random_int(self, lo: int, hi: int) -> int:
        """Uniform integer in [lo, hi) (reference randomInt semantics)."""
        return self._r.randrange(lo, hi)

    def random_unique_id(self) -> str:
        return f"{self._r.getrandbits(64):016x}{self._r.getrandbits(64):016x}"


_det: Optional[DeterministicRandom] = None


def set_deterministic_random(rng: DeterministicRandom) -> None:
    global _det
    _det = rng


def deterministic_random() -> DeterministicRandom:
    global _det
    if _det is None:
        _det = DeterministicRandom(1)
    return _det
