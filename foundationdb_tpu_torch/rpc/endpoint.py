"""Typed request streams, delivered within the process (a trimmed copy of
foundationdb_tpu/rpc/endpoint.py).

Reference: fdbrpc/fdbrpc.h:595 (RequestStream<Req>, the typed RPC
surface; each request carries a ReplyPromise) and fdbrpc/FlowTransport.h
(Endpoint).  A RequestStream has a server half, the PromiseStream `queue`
a role's actor reads, and a client half, get_reply(request), which
attaches a reply promise to the request as `request.reply`, hands it to
the queue and returns the Future of the answer.  The role answers through
`req.reply.send(value)` or `req.reply.send_error(error)`; a reply dropped
unanswered gives the caller broken_promise, as the reference's SAV
destruction does, and so does a request to a stopped stream.

There is no network, no serialization, no latency and no delivery
priority: `endpoint` is the
stream itself and `RequestStream.at(endpoint)` gives it back, so a
client written against the reference's `RequestStream.at(x.endpoint)
.get_reply(req)` runs unchanged, and a transport can later put an
address behind `endpoint` without touching the callers.
"""

from __future__ import annotations

from typing import Any

from ..core.error import err
from ..core.futures import Future, Promise, PromiseStream, error_future

# Error names that mean "the transport failed", not "the request was
# processed and rejected": callers may retry or fail over on these
# (reference: errors LoadBalance/tryGetReply treat as retriable).
TRANSPORT_ERRORS = frozenset({"broken_promise", "connection_failed",
                              "request_maybe_delivered"})


class RequestStream:
    """Server half: `queue`, read by the role (`async for req in
    stream.queue`).  Client half: get_reply(request)."""

    def __init__(self, name: str = "") -> None:
        self.name = name
        self.queue: PromiseStream = PromiseStream()
        self.stopped = False

    # -- server side --------------------------------------------------------
    @property
    def endpoint(self) -> "RequestStream":
        """Where a client sends: the stream itself (local delivery)."""
        return self

    def deliver(self, request: Any) -> None:
        self.queue.send(request)

    def stop(self) -> None:
        """The role behind this stream is gone: every buffered request's
        reply breaks, and later requests answer broken_promise."""
        self.stopped = True
        self.queue.break_buffered_replies()

    # -- client side --------------------------------------------------------
    @staticmethod
    def at(ep: "RequestStream") -> "RequestStream":
        return ep

    def get_reply(self, request: Any) -> Future:
        """Send `request`; the Future of its reply.  broken_promise when
        the stream was stopped or the role drops the reply unanswered."""
        if self.stopped:
            return error_future(err("broken_promise",
                                    f"{self.name}: stopped"))
        p: Promise = Promise()
        request.reply = p
        f = p.get_future()
        self.deliver(request)
        return f
