"""Real TCP network: the SimNetwork surface over non-blocking sockets (a
copy of foundationdb_tpu/rpc/real_network.py without TLS).

Reference: fdbrpc/FlowTransport.actor.cpp — one connection per peer pair,
ConnectPacket version handshake (:355), token-addressed endpoint map (:55),
deliver() dispatch (:919), broken-promise signalling when a peer connection
dies.  This module implements the same `register` / `send_request` /
`send_one_way` surface as rpc/network.py's SimNetwork, so EVERY role and
client runs unchanged over real sockets — the sim remains the deterministic
test vehicle, this is the deployment plane (Net2 vs Sim2).

Framing (all little-endian, over the reactor in core/scheduler.py):

    handshake := u32 magic 0x0FDB7C02 | u16 protocol version
    frame     := u32 length | u8 kind | body
    kind 0 REQUEST : token str | u64 reply_id | bytes envelope(request)
    kind 1 REPLY_OK: u64 reply_id | serde(value)
    kind 2 REPLY_ER: u64 reply_id | serde(FdbError)
    kind 3 ONEWAY  : token str | bytes envelope(message)

envelope() is serde.encode_envelope: the sender's span context + the
serde value (the port sends the empty span: it keeps no ambient span).

Failure semantics match what upper layers can observe in simulation: a dead
peer / reset connection breaks every pending reply promise routed over that
connection (broken_promise); an unknown token gets an immediate
broken_promise error reply (the receiver never registered, or rebooted).
Connections are dialed lazily on first send and redialed after failure.

Left out: TLS (the reference's `tls=` argument and _tls_pump, which come
with fdbserver's --tls-* flags).
"""

from __future__ import annotations

import errno
import socket
import struct
from typing import Any, Dict, List, Optional, Tuple

from ..core.error import err
from ..core.futures import Future, Promise
from ..core.scheduler import EventLoop, TaskPriority
from ..core.trace import Severity, TraceEvent
from . import serde
from .endpoint import Endpoint, NetworkAddress, ReplyPromise, RequestStream

MAGIC = 0x0FDB7C02
PROTOCOL_VERSION = 3   # v3: requests/one-ways ship as span envelopes
_HS = struct.Struct("<IH")
_LEN = struct.Struct("<I")

K_REQUEST = 0
K_REPLY_OK = 1
K_REPLY_ER = 2
K_ONEWAY = 3

_MAX_FRAME = 64 << 20


class _Conn:
    """One peer connection (either direction) on the reactor."""

    def __init__(self, net: "RealNetwork", sock: socket.socket,
                 peer_key: Optional[Tuple[str, int]], outbound: bool,
                 connecting: bool = False) -> None:
        self.net = net
        self.sock = sock
        self.peer_key = peer_key       # canonical dial address (outbound)
        self.outbound = outbound
        self.closed = False
        self._in = bytearray()
        self._out = bytearray()
        self._hs_done = False
        self._writer_on = False
        # Non-blocking dial in progress: frames buffer into _out; the
        # writer callback fires on connect completion (or SO_ERROR).
        self._connecting = connecting
        sock.setblocking(False)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        if outbound:
            self._queue_out(_HS.pack(MAGIC, PROTOCOL_VERSION))
            if not connecting:
                self._flush()
        if connecting:
            self._writer_on = True
            self.net.loop.add_writer(self.sock, self._on_connect_complete)
            # Blackholed SYNs (host down without RST) never become writable;
            # give up after a bounded dial window instead of holding the
            # conn (and its buffered requests) forever.
            self.net.loop.call_at(self.net.loop.now() + 5.0,
                                  self._on_connect_deadline)
        self.net.loop.add_reader(self.sock, self._on_readable)

    def _queue_out(self, data: bytes) -> None:
        self._out += data

    # -- non-blocking connect completion --------------------------------------
    def _on_connect_complete(self) -> None:
        if self.closed or not self._connecting:
            return
        soerr = self.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
        self._writer_on = False
        self.net.loop.remove_writer(self.sock)
        self._connecting = False
        if soerr != 0:
            TraceEvent("ConnectFailed", Severity.Warn).detail(
                "Peer", f"{self.peer_key}").detail(
                "Error", errno.errorcode.get(soerr, str(soerr))).log()
            self.net._note_dial_failure(self.peer_key)
            self.close()
            return
        self.net._dial_backoff.pop(self.peer_key, None)
        self._flush()

    def _on_connect_deadline(self) -> None:
        if self.closed or not self._connecting:
            return
        TraceEvent("ConnectTimedOut", Severity.Warn).detail(
            "Peer", f"{self.peer_key}").log()
        self.net._note_dial_failure(self.peer_key)
        self.close()

    # -- sending -------------------------------------------------------------
    def send_frame(self, kind: int, body: bytes) -> None:
        if self.closed:
            return
        self._queue_out(_LEN.pack(1 + len(body)) + bytes([kind]) + body)
        self._flush()

    def _flush(self) -> None:
        if self.closed:
            return
        if self._connecting:
            return                     # buffer until the dial completes
        try:
            while self._out:
                n = self.sock.send(self._out)
                if n == 0:
                    break
                del self._out[:n]
        except BlockingIOError:
            pass
        except OSError:
            self.close()
            return
        if self._out and not self._writer_on:
            self._writer_on = True
            self.net.loop.add_writer(self.sock, self._on_writable)
        elif not self._out and self._writer_on:
            self._writer_on = False
            self.net.loop.remove_writer(self.sock)

    def _on_writable(self) -> None:
        self._flush()

    # -- receiving -----------------------------------------------------------
    def _on_readable(self) -> None:
        try:
            while True:
                chunk = self.sock.recv(1 << 18)
                if not chunk:
                    self.close()
                    return
                self._in += chunk
                if len(chunk) < (1 << 18):
                    break
        except BlockingIOError:
            pass
        except OSError:
            self.close()
            return
        self._drain_frames()

    def _drain_frames(self) -> None:
        if not self._hs_done:
            if len(self._in) < _HS.size:
                return
            magic, ver = _HS.unpack_from(self._in, 0)
            if magic != MAGIC or ver != PROTOCOL_VERSION:
                TraceEvent("ConnectionRejected", Severity.Warn).detail(
                    "Magic", magic).detail("Version", ver).log()
                self.close()
                return
            del self._in[:_HS.size]
            self._hs_done = True
            if not self.outbound:
                self._queue_out(_HS.pack(MAGIC, PROTOCOL_VERSION))
                self._flush()
        while True:
            if len(self._in) < 4:
                return
            (n,) = _LEN.unpack_from(self._in, 0)
            if n > _MAX_FRAME:
                self.close()
                return
            if len(self._in) < 4 + n:
                return
            body = bytes(self._in[4:4 + n])
            del self._in[:4 + n]
            if self.closed:
                return
            try:
                self.net._on_frame(self, body[0], body[1:])
            except Exception as e:  # noqa: BLE001 — one bad frame must not
                # take down the process; drop it (caller sees timeout/break)
                TraceEvent("FrameDispatchError", Severity.Warn).detail(
                    "Error", repr(e)).log()

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        # A refused dial can surface through the READER callback first
        # (RST marks the fd readable; recv raises before the writer
        # callback ever runs) — record the failure here so the negative-TTL
        # dial cache engages on the common ECONNREFUSED path too.
        if self._connecting:
            self.net._note_dial_failure(self.peer_key)
            self._connecting = False
        self.net.loop.remove_reader(self.sock)
        if self._writer_on:
            self.net.loop.remove_writer(self.sock)
        try:
            self.sock.close()
        except OSError:
            pass
        self.net._on_conn_closed(self)


class RealNetwork:
    """Token-addressed RPC over real TCP; same surface as SimNetwork."""

    def __init__(self, loop: EventLoop, listen_ip: str = "127.0.0.1",
                 listen_port: int = 0) -> None:
        """Listen on (`listen_ip`, `listen_port`; 0 picks a free port) on
        `loop`, a real-mode EventLoop (EventLoop(sim=False)); `address`
        is where peers reach this process."""
        self.loop = loop
        self._endpoints: Dict[Endpoint, Tuple[RequestStream, int]] = {}
        self._conns: Dict[Tuple[str, int], _Conn] = {}
        self._all_conns: List[_Conn] = []
        # reply_id -> (Promise, conn, send time)
        self._pending: Dict[int, Tuple[Promise, _Conn, float]] = {}
        # peer key -> monotonic time before which we won't re-dial
        self._dial_backoff: Dict[Tuple[str, int], float] = {}
        self._next_reply_id = 1
        self.messages_sent = 0
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((listen_ip, listen_port))
        self._listener.listen(64)
        self._listener.setblocking(False)
        ip, port = self._listener.getsockname()
        self.address = NetworkAddress(ip, port)
        loop.add_reader(self._listener, self._on_accept)
        # Per-peer health telemetry: this process's view of every peer
        # it talks to — RTTs, disconnects, dial failures, bytes — gated
        # on PEER_HEALTH_ENABLED at each sample site.
        from .peer_metrics import PeerMetricsTable
        self.peer_metrics = PeerMetricsTable(str(self.address))
        self._ever_dialed: set = set()
        serde.bootstrap_registry()

    def peer_table(self, src_ip: str = ""):
        """SimNetwork-surface accessor: a real process has exactly one
        table (its own), whatever `src_ip` the caller holds."""
        return self.peer_metrics

    def _health_on(self) -> bool:
        from ..core.knobs import server_knobs
        return bool(server_knobs().PEER_HEALTH_ENABLED)

    # -- registration (SimNetwork surface) -----------------------------------
    def register(self, process, stream: RequestStream,
                 token: Optional[str] = None) -> Endpoint:
        from ..core.rng import deterministic_random
        token = token or (stream.name + ":" +
                          deterministic_random().random_unique_id()[:16])
        ep = Endpoint(process.address, token)
        self._endpoints[ep] = (stream, getattr(process, "epoch", 0))
        stream.set_endpoint(ep)
        if hasattr(process, "_tokens"):
            process._tokens.add(token)
        return ep

    def unregister_process(self, address: NetworkAddress) -> None:
        for ep in [e for e in self._endpoints if e.address == address]:
            stream, _epoch = self._endpoints.pop(ep)
            stream.queue.break_buffered_replies()

    def unregister_stream(self, stream: RequestStream) -> None:
        """Drop ONE stream's endpoint (a replaced role halting while its
        process lives on): later requests get an error reply instead of
        buffering into a queue nobody serves."""
        ep = stream._endpoint
        if ep is not None:
            self._endpoints.pop(ep, None)
        stream.queue.break_buffered_replies()

    # -- connections ---------------------------------------------------------
    def _on_accept(self) -> None:
        while True:
            try:
                sock, addr = self._listener.accept()
            except BlockingIOError:
                return
            except OSError:
                return
            conn = _Conn(self, sock, None, outbound=False)
            self._all_conns.append(conn)

    def _get_conn(self, addr: NetworkAddress) -> Optional[_Conn]:
        key = (addr.ip, addr.port)
        conn = self._conns.get(key)
        if conn is not None and not conn.closed:
            return conn
        # Negative-TTL dial cache: a just-failed peer isn't re-dialed on
        # every send (each failed dial costs a round of reactor callbacks;
        # without the cache a hot retry loop would churn sockets).
        until = self._dial_backoff.get(key)
        if until is not None and self.loop.now() < until:
            return None
        # Lazy NON-BLOCKING dial (connect_ex + writer-completion callback):
        # a peer that blackholes SYNs must not stall the reactor thread —
        # frames buffer on the conn until the handshake flushes, and every
        # pending reply breaks if the dial fails (reference Net2 connects
        # asynchronously on the network thread too).
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        rc = sock.connect_ex(key)
        if rc not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK):
            sock.close()
            TraceEvent("ConnectFailed", Severity.Warn).detail(
                "Peer", f"{addr}").detail(
                "Error", errno.errorcode.get(rc, str(rc))).log()
            self._note_dial_failure(key)
            return None
        conn = _Conn(self, sock, key, outbound=True, connecting=(rc != 0))
        self._conns[key] = conn
        self._all_conns.append(conn)
        if self._health_on():
            if key in self._ever_dialed:
                self.peer_metrics.sample_reconnect(f"{key[0]}:{key[1]}")
            self._ever_dialed.add(key)
        return conn

    def _note_dial_failure(self, key) -> None:
        if key is not None:
            self._dial_backoff[key] = self.loop.now() + 1.0
            if self._health_on():
                self.peer_metrics.sample_disconnect(f"{key[0]}:{key[1]}")

    def _on_conn_closed(self, conn: _Conn) -> None:
        if conn.peer_key is not None and \
                self._conns.get(conn.peer_key) is conn:
            del self._conns[conn.peer_key]
        if conn in self._all_conns:
            self._all_conns.remove(conn)
        # Break every reply pending on this connection (the transport-level
        # failure signal; reference: connection_failed -> broken_promise).
        dead = [rid for rid, entry in self._pending.items()
                if entry[1] is conn]
        if dead and conn.peer_key is not None and self._health_on():
            pk = f"{conn.peer_key[0]}:{conn.peer_key[1]}"
            for _ in dead:
                self.peer_metrics.sample_disconnect(pk)
        for rid in dead:
            promise = self._pending.pop(rid)[0]
            if not promise.is_set() and not promise.get_future().is_ready():
                promise.send_error(err("broken_promise"))

    # -- frame dispatch ------------------------------------------------------
    def _on_frame(self, conn: _Conn, kind: int, body: bytes) -> None:
        from ..core.wire import Reader
        r = Reader(body)
        if kind == K_REQUEST:
            token = r.str_()
            reply_id = r.i64()
            # Span-carrying envelope (serde.encode_envelope; reference
            # SpanContext on each FlowTransport packet).
            request, span = serde.decode_envelope(r.bytes_())
            self._deliver_request(conn, token, reply_id, request, span)
        elif kind in (K_REPLY_OK, K_REPLY_ER):
            reply_id = r.i64()
            entry = self._pending.pop(reply_id, None)
            if entry is None:
                return             # late reply after failure: drop
            promise, _c, t0 = entry
            if conn.peer_key is not None and self._health_on():
                self.peer_metrics.sample_rtt(
                    f"{conn.peer_key[0]}:{conn.peer_key[1]}",
                    self.loop.now() - t0, self.loop.now(),
                    nbytes=len(body))
            if promise.is_set() or promise.get_future().is_ready():
                return
            value = serde.decode_value(r)
            if kind == K_REPLY_ER:
                promise.send_error(value if isinstance(value, BaseException)
                                   else err("operation_failed", str(value)))
            else:
                promise.send(value)
        elif kind == K_ONEWAY:
            token = r.str_()
            message, span = serde.decode_envelope(r.bytes_())
            entry = self._find_endpoint(token)
            if entry is not None:
                if span:
                    try:
                        message.span_context = span
                    except Exception:  # noqa: BLE001 — slots/immutable
                        pass
                entry[0].deliver(message)
            else:
                # One-way sends have no reply channel to carry an error;
                # a token miss here is the ONLY record the message ever
                # existed (observed: a master nudge dropped this way).
                TraceEvent("OneWayDropped", Severity.Warn).detail(
                    "Token", token).log()

    def _find_endpoint(self, token: str):
        return self._endpoints.get(Endpoint(self.address, token))

    def _deliver_request(self, conn: _Conn, token: str, reply_id: int,
                         request: Any, span: str = "") -> None:
        from ..core.wire import Writer
        entry = self._find_endpoint(token)
        if entry is None:
            w = Writer().i64(reply_id)
            serde.encode_value(w, err("broken_promise"))
            conn.send_frame(K_REPLY_ER, w.done())
            return
        stream, _epoch = entry

        def route_reply(value: Any, e: Optional[BaseException]) -> None:
            if conn.closed:
                return
            w = Writer().i64(reply_id)
            if e is None:
                try:
                    serde.encode_value(w, value)
                except Exception as enc:  # noqa: BLE001
                    # The promise is already consumed by the time encode
                    # runs; swallowing here would leave the caller's
                    # get_reply hanging FOREVER (observed with an
                    # unregistered stream inside a reply payload).  Turn
                    # it into an error reply instead.
                    TraceEvent("ReplyEncodeFailed", Severity.Error).detail(
                        "Token", token).detail("Error", repr(enc)).log()
                    e = err("internal_error",
                            f"reply encode failed: {enc!r}")
                    w = Writer().i64(reply_id)
            if e is not None:
                if not isinstance(e, Exception) or not hasattr(e, "code"):
                    e = err("operation_failed", repr(e))
                serde.encode_value(w, e)
                conn.send_frame(K_REPLY_ER, w.done())
            else:
                conn.send_frame(K_REPLY_OK, w.done())

        request.reply = ReplyPromise(route_reply)
        if span:
            # Handlers run later as actors: the context rides the request.
            try:
                request.span_context = span
            except Exception:  # noqa: BLE001 — slots/immutable payloads
                pass
        stream.deliver(request)

    # -- sending (SimNetwork surface) ----------------------------------------
    def send_request(self, ep: Endpoint, request: Any,
                     priority: TaskPriority = TaskPriority.DefaultEndpoint,
                     from_address: Optional[NetworkAddress] = None) -> Future:
        from ..core.wire import Writer
        self.messages_sent += 1
        promise: Promise = Promise()
        if ep.address == self.address:
            # Local delivery: no serialization, direct like the sim.
            entry = self._endpoints.get(ep)
            if entry is None:
                self.loop.call_soon(
                    lambda: promise.send_error(err("broken_promise")))
                return promise.get_future()
            stream = entry[0]

            def local_reply(value: Any, e: Optional[BaseException]) -> None:
                if promise.is_set() or promise.get_future().is_ready():
                    return
                if e is not None:
                    promise.send_error(e)
                else:
                    promise.send(value)

            request.reply = ReplyPromise(local_reply)
            self.loop.call_soon(lambda: stream.deliver(request), priority)
            return promise.get_future()
        conn = self._get_conn(ep.address)
        if conn is None:
            self.loop.call_soon(
                lambda: promise.send_error(err("broken_promise")))
            return promise.get_future()
        reply_id = self._next_reply_id
        self._next_reply_id += 1
        self._pending[reply_id] = (promise, conn, self.loop.now())
        w = Writer().str_(ep.token).i64(reply_id)
        w.bytes_(serde.encode_envelope(request))
        frame = w.done()
        if self._health_on():
            self.peer_metrics.sample_request(str(ep.address), len(frame))
        conn.send_frame(K_REQUEST, frame)
        return promise.get_future()

    def send_one_way(self, ep: Endpoint, message: Any,
                     priority: TaskPriority = TaskPriority.DefaultEndpoint,
                     from_address: Optional[NetworkAddress] = None) -> None:
        from ..core.wire import Writer
        self.messages_sent += 1
        if ep.address == self.address:
            entry = self._endpoints.get(ep)
            if entry is not None:
                stream = entry[0]
                self.loop.call_soon(lambda: stream.deliver(message), priority)
            return
        conn = self._get_conn(ep.address)
        if conn is None:
            TraceEvent("OneWayNoConn", Severity.Warn).detail(
                "Peer", f"{ep.address}").log()
            return
        w = Writer().str_(ep.token)
        w.bytes_(serde.encode_envelope(message))
        conn.send_frame(K_ONEWAY, w.done())

    def close(self) -> None:
        self.loop.remove_reader(self._listener)
        try:
            self._listener.close()
        except OSError:
            pass
        for c in list(self._all_conns):
            c.close()


class RealProcess:
    """The real-mode process handle: same duck-typed surface the roles use
    on SimProcess (spawn/register/address/name/alive/epoch), plus the
    machine filesystem for durable roles."""

    def __init__(self, loop: EventLoop, network: RealNetwork,
                 name: str = "", process_class: str = "unset",
                 fs=None, locality=None) -> None:
        from ..core.futures import AsyncVar
        self.loop = loop
        self.network = network
        self.address = network.address
        self.name = name or str(self.address)
        self.process_class = process_class
        self.alive = True
        self.epoch = 0
        self.excluded = False
        self.fs = fs
        self.locality = locality
        self._tokens: set = set()
        self._actors: List[Future] = []
        self.shutdown_signal: AsyncVar = AsyncVar(None)

    def spawn(self, coro, name: str = "") -> Future:
        f = self.loop.spawn(coro, name or f"{self.name}:actor")
        self._actors.append(f)
        self._actors = [a for a in self._actors if not a.is_ready()]
        return f

    def register(self, stream: RequestStream,
                 token: Optional[str] = None) -> Endpoint:
        return self.network.register(self, stream, token)

    def die(self, reason: str = "") -> None:
        """Real-process suicide (reference: io_error exits fdbserver)."""
        TraceEvent("ProcessSuicide", Severity.Warn).detail(
            "Process", self.name).detail("Reason", reason).log()
        import os
        os._exit(44)
