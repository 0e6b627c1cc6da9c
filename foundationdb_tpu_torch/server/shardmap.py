"""RangeMap: sorted key-range -> value map for resolver routing.

The port of foundationdb_tpu/server/shardmap.py, whole.  Reference:
KeyRangeMap<T> (fdbclient/KeyRangeMap.h) -- the structure behind
ProxyCommitData::keyResolvers (CommitProxyServer.actor.cpp:154-181).  A
RangeMap partitions the whole keyspace into contiguous half-open ranges,
each carrying a value; set_range splits/merges boundaries.
"""

from __future__ import annotations

import bisect
from typing import Any, Generic, Iterator, List, Tuple, TypeVar

T = TypeVar("T")


class RangeMap(Generic[T]):
    """Partition of [b'', end_key) into ranges with values.

    Internally: parallel sorted lists `bounds` / `values` where range i is
    [bounds[i], bounds[i+1]) with values[i]; bounds[0] == b'' always.
    """

    def __init__(self, default: T = None, end_key: bytes = b"\xff\xff") -> None:
        self.end_key = end_key
        self._bounds: List[bytes] = [b""]
        self._values: List[T] = [default]

    def __len__(self) -> int:
        return len(self._values)

    # -- queries -------------------------------------------------------------
    def _idx(self, key: bytes) -> int:
        return bisect.bisect_right(self._bounds, key) - 1

    def lookup(self, key: bytes) -> T:
        return self._values[self._idx(key)]

    def range_containing(self, key: bytes) -> Tuple[bytes, bytes, T]:
        i = self._idx(key)
        end = self._bounds[i + 1] if i + 1 < len(self._bounds) else self.end_key
        return self._bounds[i], end, self._values[i]

    def range_before(self, end_key: bytes) -> Tuple[bytes, bytes, T]:
        """Range containing the greatest key strictly below `end_key`."""
        i = max(0, bisect.bisect_left(self._bounds, end_key) - 1)
        end = self._bounds[i + 1] if i + 1 < len(self._bounds) else self.end_key
        return self._bounds[i], end, self._values[i]

    def intersecting(self, begin: bytes, end: bytes
                     ) -> Iterator[Tuple[bytes, bytes, T]]:
        """Yield (range_begin, range_end, value) clipped to [begin, end)."""
        if begin >= end:
            return
        i = self._idx(begin)
        while i < len(self._values):
            rb = self._bounds[i]
            re = self._bounds[i + 1] if i + 1 < len(self._bounds) else self.end_key
            if rb >= end:
                return
            yield max(rb, begin), min(re, end), self._values[i]
            i += 1

    def ranges(self) -> Iterator[Tuple[bytes, bytes, T]]:
        yield from self.intersecting(b"", self.end_key)

    def copy(self) -> "RangeMap[T]":
        out: RangeMap[T] = RangeMap(end_key=self.end_key)
        out._bounds = list(self._bounds)
        out._values = list(self._values)
        return out

    # -- updates -------------------------------------------------------------
    def set_range(self, begin: bytes, end: bytes, value: T) -> None:
        """Assign `value` to [begin, end), splitting boundaries as needed."""
        if begin >= end:
            return
        # Value that the tail at `end` must keep.
        tail_value = self.lookup(end) if end < self.end_key else None
        lo = bisect.bisect_left(self._bounds, begin)
        hi = bisect.bisect_left(self._bounds, end)
        new_bounds: List[bytes] = [begin]
        new_values: List[T] = [value]
        if end < self.end_key:
            new_bounds.append(end)
            new_values.append(tail_value)
            # If an existing boundary at `end` already starts a range, keep it
            # (its value is tail_value anyway; dedup below).
            if hi < len(self._bounds) and self._bounds[hi] == end:
                new_bounds.pop()
                new_values.pop()
        self._bounds[lo:hi] = new_bounds
        self._values[lo:hi] = new_values
        self._coalesce_around(lo)

    def _coalesce_around(self, i: int) -> None:
        """Merge adjacent equal-valued ranges near index i."""
        lo = max(i - 1, 0)
        hi = min(i + 2, len(self._values))
        j = lo + 1
        while j < hi and j < len(self._values):
            if self._values[j] == self._values[j - 1]:
                del self._bounds[j]
                del self._values[j]
                hi -= 1
            else:
                j += 1

    def __repr__(self) -> str:  # pragma: no cover
        parts = [f"[{b!r},{e!r})->{v!r}" for b, e, v in self.ranges()]
        return "RangeMap(" + ", ".join(parts) + ")"
