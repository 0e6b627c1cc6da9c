"""Deterministic randomness (trimmed copy of foundationdb_tpu/core/rng.py).

Only what core/buggify.py draws from: a seeded generator and the
process-wide instance.  The port's generator is its own, so the port's
buggify draws never touch another package's random state.
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


_det: Optional[DeterministicRandom] = None


def deterministic_random() -> DeterministicRandom:
    global _det
    if _det is None:
        _det = DeterministicRandom(1)
    return _det
