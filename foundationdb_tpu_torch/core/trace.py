"""Structured trace events (trimmed copy of foundationdb_tpu/core/trace.py).

TraceEvent builds one record and log() appends it to an in-process ring
that tests read with `recent_events()`.  The ring is the port's own: its
events never reach another package's tracer or any simulation digest.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, List, Optional

RING_SIZE = 4096


class Severity:
    Debug = 5
    Info = 10
    Warn = 20
    WarnAlways = 30
    Error = 40


_ring: Deque[Dict[str, Any]] = deque(maxlen=RING_SIZE)


class TraceEvent:
    """Builder-style structured log record."""

    __slots__ = ("_event", "_logged")

    def __init__(self, type_name: str, severity: int = Severity.Info,
                 id: str = "") -> None:
        from .scheduler import now
        self._event: Dict[str, Any] = {"Type": type_name,
                                       "Severity": severity,
                                       "Time": round(now(), 6)}
        if id:
            self._event["ID"] = id
        self._logged = False

    def detail(self, key: str, value: Any) -> "TraceEvent":
        self._event[key] = value
        return self

    def error(self, e: BaseException) -> "TraceEvent":
        self._event["Error"] = repr(e)
        return self

    def log(self) -> None:
        if not self._logged:
            self._logged = True
            _ring.append(self._event)

    def __del__(self) -> None:  # auto-log on drop, like the reference
        try:
            self.log()
        except Exception:  # pragma: no cover - interpreter shutdown
            pass


def recent_events(type_name: Optional[str] = None) -> List[Dict[str, Any]]:
    """The ring's events, oldest first, optionally of one type."""
    return [e for e in _ring if type_name is None or e["Type"] == type_name]


def trace_batch_event(event_type: str, debug_id: str, location: str) -> None:
    """Transaction debug correlation (reference g_traceBatch.addEvent:
    "TransactionDebug"/"CommitDebug" point events at every hop, keyed by
    the transaction's debug id).  No-op without a debug id."""
    if debug_id:
        TraceEvent(event_type).detail("DebugID", debug_id).detail(
            "Location", location).log()
