"""NotifiedVersion: a monotonically increasing value with whenAtLeast waits.

Reference: fdbclient/Notified.h (Notified<Version>), as copied in
foundationdb_tpu/server/notified.py: the version-chaining primitive a
resolver waits on (Resolver.actor.cpp:148
self->version.whenAtLeast(req.prevVersion)).  The port has no reactor and
no futures: a waiter is a continuation, called with the new value.
Waiters sit in the reference's (threshold, seq) heap and set() wakes
those now due in the reference's order: lowest threshold first, arrival
order among equal thresholds.
"""

from __future__ import annotations

import heapq
from typing import Callable, List, Tuple

Waiter = Callable[[int], None]


class NotifiedVersion:
    """Monotonic value; continuations run when it reaches a threshold."""

    __slots__ = ("_value", "_waiters", "_seq")

    def __init__(self, value: int = 0) -> None:
        self._value = value
        self._waiters: List[Tuple[int, int, Waiter]] = []  # heap by threshold
        self._seq = 0

    def get(self) -> int:
        return self._value

    def when_at_least(self, threshold: int, waiter: Waiter) -> None:
        """Call waiter(value) now if the value has reached `threshold`,
        else from the set() that reaches it."""
        if self._value >= threshold:
            waiter(self._value)
            return
        self._seq += 1
        heapq.heappush(self._waiters, (threshold, self._seq, waiter))

    def set(self, value: int) -> None:
        assert value >= self._value, \
            f"NotifiedVersion moved backwards: {self._value} -> {value}"
        self._value = value
        while self._waiters and self._waiters[0][0] <= value:
            _, _, waiter = heapq.heappop(self._waiters)
            waiter(value)

    def waiting(self) -> int:
        """Continuations not yet woken."""
        return len(self._waiters)

    def drop_waiters(self) -> int:
        """Forget every continuation not yet woken; returns how many."""
        n = len(self._waiters)
        self._waiters = []
        return n
