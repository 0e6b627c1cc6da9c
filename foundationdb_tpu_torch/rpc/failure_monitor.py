"""Failure monitoring: endpoint availability + waitFailure heartbeats (a
copy of foundationdb_tpu/rpc/failure_monitor.py).

Reference: fdbrpc/FailureMonitor.h:140 SimpleFailureMonitor (per-endpoint
availability state machine fed by transport failures) and
fdbserver/WaitFailure.actor.cpp (explicit heartbeat RPC: a client holds a
waitFailure request open on a role; if the role stops answering, the client
declares it failed — this is how the cluster controller notices dead roles).
"""

from __future__ import annotations

from typing import Dict

from ..core.error import FdbError
from ..core.futures import AsyncVar, Future
from ..core.scheduler import delay
from .endpoint import Endpoint, RequestStream, RequestStreamStub


class FailureMonitor:
    """Tracks believed availability of endpoints (client-side cache)."""

    def __init__(self) -> None:
        self._failed: Dict[Endpoint, AsyncVar] = {}

    def _state(self, ep: Endpoint) -> AsyncVar:
        st = self._failed.get(ep)
        if st is None:
            st = self._failed[ep] = AsyncVar(False)
        return st

    def set_status(self, ep: Endpoint, failed: bool) -> None:
        self._state(ep).set(failed)

    def is_failed(self, ep: Endpoint) -> bool:
        st = self._failed.get(ep)
        return bool(st.get()) if st is not None else False

    def on_state_change(self, ep: Endpoint) -> Future:
        return self._state(ep).on_change()


class WaitFailureRequest:
    """Heartbeat request; the server simply never replies until it dies."""

    __slots__ = ("reply",)


async def wait_failure_server(stream: RequestStream) -> None:
    """Server side: accept heartbeat requests and hold them open forever.
    When the process dies, its held ReplyPromises break, signalling clients.
    (Reference fdbserver/WaitFailure.actor.cpp keeps a bounded queue.)"""
    held = []
    async for req in stream.queue:
        held.append(req.reply)
        if len(held) > 1000:
            held.pop(0).send(None)


async def wait_failure_client(ep: Endpoint, timeout: float = 1.0,
                              retries: int = 2) -> None:
    """Client side: returns (normally) once the endpoint is believed FAILED.

    Holds a request open; if the reply breaks (process death) the endpoint
    has failed. A reply or timeout means still alive; re-arm. `retries`
    consecutive transport failures are required, tolerating one reboot blip.
    """
    failures = 0
    while True:
        try:
            req = WaitFailureRequest()
            fut = RequestStreamStub(ep).get_reply(req)
            from ..core.futures import wait_any
            idx, _ = await wait_any([fut, delay(timeout)])
            if idx == 1:
                fut.cancel()
                failures = 0
                continue
            failures = 0  # got an eviction reply: server alive
        except FdbError as e:
            if e.name in ("broken_promise", "connection_failed",
                          "request_maybe_delivered"):
                failures += 1
                if failures >= retries:
                    return
                await delay(0.1)
            else:
                raise
