"""Endpoints and typed request streams (a copy of
foundationdb_tpu/rpc/endpoint.py).

Reference: fdbrpc/FlowTransport.h:34 (Endpoint, a token-addressed receiver
on a NetworkAddress) and fdbrpc/fdbrpc.h:595 (RequestStream<Req>, the typed
RPC surface; each request carries a ReplyPromise serialized inside it).

A RequestStream has a server half, the PromiseStream `queue` a role's
actor reads, registered on the network under a token by the process the
role runs on (SimProcess.register, RealProcess.register), and a client
half, the Endpoint (address and token) that interface structs carry.
Requests are plain objects; the network attaches a `reply` ReplyPromise
before delivery, as the reference's transport deserializes a ReplyPromise
from the request bytes.  The role answers through `req.reply.send(value)`
or `req.reply.send_error(error)`; a reply dropped unanswered gives the
caller broken_promise, as the reference's SAV destruction does.

A stream registered on no process (a stub a test serves itself, the
roles of a cluster that was never started) is its own endpoint:
`RequestStream.at(stream)` gives it back and get_reply hands the request
to its queue within the process, with no latency.  Once registered, its
endpoint is an Endpoint and every request crosses the installed network
(rpc/network.py SimNetwork or rpc/real_network.py RealNetwork).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Union

from ..core.error import err
from ..core.futures import Future, Promise, PromiseStream
from ..core.scheduler import TaskPriority

# Error names that mean "the transport failed", not "the request was
# processed and rejected": callers may retry or fail over on these
# (reference: errors LoadBalance/tryGetReply treat as retriable).
TRANSPORT_ERRORS = frozenset({"broken_promise", "connection_failed",
                              "request_maybe_delivered"})


class NetworkAddress(NamedTuple):
    """Process address (reference flow/network.h NetworkAddress)."""

    ip: str
    port: int

    def __str__(self) -> str:
        return f"{self.ip}:{self.port}"


class Endpoint(NamedTuple):
    """A token-addressed message target on a process."""

    address: NetworkAddress
    token: str

    def __str__(self) -> str:
        return f"{self.address}/{self.token}"


class ReplyPromise:
    """The reply half of one RPC (reference ReplyPromise<T>).

    Made by the network at delivery; `send` / `send_error` route the
    reply back to the caller's process.  Dropping it unset gives the
    caller broken_promise, like SAV destruction in the reference."""

    __slots__ = ("_send_fn", "_done")

    def __init__(self, send_fn) -> None:
        self._send_fn = send_fn
        self._done = False

    def send(self, value: Any = None) -> None:
        if not self._done:
            self._done = True
            self._send_fn(value, None)

    def send_error(self, e: BaseException) -> None:
        if not self._done:
            self._done = True
            self._send_fn(None, e)

    def is_set(self) -> bool:
        return self._done

    def __del__(self) -> None:
        try:
            if not self._done:
                self.send_error(err("broken_promise"))
        except Exception:  # pragma: no cover - interpreter shutdown
            pass


class RequestStream:
    """Typed RPC stream.  The server half owns `queue`; the client half
    is `endpoint`, shippable inside interface structs.

    Server:
        rs = RequestStream("commit")
        process.register(rs)
        async for req in rs.queue: ... req.reply.send(...)
    Client:
        reply = await RequestStream.at(ep).get_reply(MyRequest(...))
    """

    def __init__(self, name: str = "",
                 priority: TaskPriority = TaskPriority.DefaultEndpoint
                 ) -> None:
        self.name = name
        self.priority = priority
        self.queue: PromiseStream = PromiseStream()
        self._endpoint: Optional[Endpoint] = None

    # -- server side --------------------------------------------------------
    def set_endpoint(self, ep: Endpoint) -> None:
        self._endpoint = ep

    @property
    def endpoint(self) -> Union[Endpoint, "RequestStream"]:
        """The Endpoint the stream was registered under; the stream
        itself while it is registered on no process."""
        return self if self._endpoint is None else self._endpoint

    def deliver(self, request: Any) -> None:
        self.queue.send(request)

    # -- client side --------------------------------------------------------
    @staticmethod
    def at(ep, priority: TaskPriority = TaskPriority.DefaultEndpoint):
        """The client handle of `ep`: a stub for an Endpoint, the stream
        itself for an unregistered stream."""
        if isinstance(ep, RequestStream):
            return ep
        return RequestStreamStub(ep, priority)

    def get_reply(self, request: Any,
                  from_address: Optional[NetworkAddress] = None) -> Future:
        """Send `request`; the Future of its reply (broken_promise when
        the role is gone or drops the reply unanswered)."""
        if self._endpoint is not None:
            return RequestStreamStub(self._endpoint, self.priority).get_reply(
                request, from_address)
        p: Promise = Promise()
        request.reply = p
        f = p.get_future()
        self.deliver(request)
        return f

    def send(self, request: Any,
             from_address: Optional[NetworkAddress] = None) -> None:
        if self._endpoint is not None:
            RequestStreamStub(self._endpoint, self.priority).send(
                request, from_address)
        else:
            self.deliver(request)


@dataclass(frozen=True)
class RequestStreamStub:
    """Client handle to a remote RequestStream endpoint."""

    ep: Endpoint
    priority: TaskPriority = TaskPriority.DefaultEndpoint

    def get_reply(self, request: Any,
                  from_address: Optional[NetworkAddress] = None) -> Future:
        """Send `request`; Future of the reply.  broken_promise if the
        target process is dead or rebooted (the transport-level failure
        signal the reference maps to request_maybe_delivered in
        tryGetReply)."""
        from .network import get_network
        return get_network().send_request(self.ep, request, self.priority,
                                          from_address)

    async def try_get_reply(self, request: Any):
        """get_reply, mapping transport failure to None (reference
        tryGetReply returning ErrorOr with request_maybe_delivered)."""
        from ..core.error import FdbError
        try:
            return await self.get_reply(request)
        except FdbError as e:
            if e.name in TRANSPORT_ERRORS:
                return None
            raise

    def send(self, request: Any,
             from_address: Optional[NetworkAddress] = None) -> None:
        """One-way send (no reply routing)."""
        from .network import get_network
        get_network().send_one_way(self.ep, request, self.priority,
                                   from_address)
