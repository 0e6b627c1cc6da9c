"""waitFailure servers/clients (a copy of foundationdb_tpu/server/failure.py;
reference fdbserver/WaitFailure.actor.cpp).

A role registers a wait_failure stream and holds every request forever;
when the hosting process dies (or the holder actor is cancelled), the held
ReplyPromises break — delivering broken_promise to watchers.  The watcher
side simply get_reply's and treats any error as "the role failed".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..core.error import FdbError, err


@dataclass
class WaitFailureRequest:
    reply: Any = None


async def hold_wait_failure(stream) -> None:
    held = []
    try:
        async for req in stream.queue:
            held.append(req)
    finally:
        # Break held promises EXPLICITLY at cancellation (role/epoch end):
        # the GC-driven ReplyPromise.__del__ fallback is not prompt on an
        # idle real process (reference cycles park cancelled actor frames
        # until a gen-2 collection), and a remote watcher parked on this
        # role's failure signal is exactly what re-recruitment liveness
        # hangs on — observed: a fenced epoch whose master died was never
        # replaced because the CC's waitFailure future never broke.
        for req in held:
            if req.reply is not None and not req.reply.is_set():
                req.reply.send_error(err("broken_promise"))


async def wait_failure_of(interface) -> None:
    """Resolves (normally) when the role behind `interface` fails."""
    from ..rpc.endpoint import RequestStream
    try:
        await RequestStream.at(interface.wait_failure.endpoint).get_reply(
            WaitFailureRequest())
    except FdbError:
        return
