"""The event loop the port runs under, if any (no reactor of its own).

The reference's supervisor reads virtual time from its simulation reactor
and its metrics actor sleeps on it (foundationdb_tpu/core/scheduler.py).
The port has no reactor: a caller that runs the port inside one installs
that loop here with set_event_loop.  Any object with `now()` and
`delay(seconds)` will do; delay returns whatever the loop's actors await.
With no loop installed, now() is monotonic wall time and delay raises.
"""

from __future__ import annotations

import time as _time

_current = None


def set_event_loop(loop) -> None:
    """Install `loop` (or None to remove it)."""
    global _current
    _current = loop


def current_event_loop_or_none():
    """The installed loop, or None."""
    return _current


def now() -> float:
    """The installed loop's time, or monotonic wall time without one."""
    if _current is not None:
        return _current.now()
    return _time.monotonic()


def delay(seconds: float):
    """The installed loop's delay(seconds), for an actor of that loop to
    await."""
    if _current is None:
        raise RuntimeError("no event loop installed (core.scheduler."
                           "set_event_loop)")
    return _current.delay(seconds)

