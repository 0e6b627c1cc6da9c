"""Real TCP transport skeleton: token-addressed frames in the wire format
(a copy of foundationdb_tpu/rpc/transport.py).

Reference: fdbrpc/FlowTransport.actor.cpp — one connection per peer pair, a
`ConnectPacket` version handshake (:355), token-addressed endpoint delivery
(`deliver` :919).  This module is the multi-process half of that design for
the framework's wire format (core/wire.py):

    frame    := u32 length | u64 token | u8 kind | u8 span_len | span
                | payload
    kind     := 0 request (payload ends with a u64 reply token)
                1 reply
    handshake:= u32 magic 0x0FDB7C01 | u16 protocol version

The span field is the cross-process trace context (reference
flow/Tracing.h SpanContext riding every FlowTransport packet): a request
carries the span its caller names and the reply echoes it back (the port
keeps no ambient span to install around the handler).  Protocol version 2
(v1 frames had no span field).

Serialization of the demonstrator messages lives in `serialize_kv_*` —
the classic length-prefixed field order of flow/serialize.h.  The
simulation transport (rpc/network.py) remains the test vehicle for the
full role surface; this transport is deployed process-to-process over real
sockets (tests/test_torch_reactor.py runs a KV service in a separate OS
process).  The role interfaces cross processes on rpc/real_network.py,
over the event loop's real-IO reactor.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, Dict, Optional, Tuple

from ..core.wire import Reader, Writer

MAGIC = 0x0FDB7C01
PROTOCOL_VERSION = 2                # v2: frames carry a span context
_HDR = struct.Struct("<I")          # frame length
_TOKEN_KIND = struct.Struct("<QB")  # token, kind

KIND_REQUEST = 0
KIND_REPLY = 1


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            # close() raced this reader thread (EBADF/ECONNRESET at
            # teardown): same as a clean peer close — end the frame
            # loop instead of dying with an unhandled thread exception.
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


def _send_frame(sock: socket.socket, token: int, kind: int,
                payload: bytes, span: str = "") -> None:
    sb = span.encode()[:255]
    body = (_TOKEN_KIND.pack(token, kind) + bytes([len(sb)]) + sb +
            payload)
    sock.sendall(_HDR.pack(len(body)) + body)


def _recv_frame(sock: socket.socket
                ) -> Optional[Tuple[int, int, bytes, str]]:
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (n,) = _HDR.unpack(hdr)
    body = _recv_exact(sock, n)
    if body is None:
        return None
    token, kind = _TOKEN_KIND.unpack_from(body, 0)
    o = _TOKEN_KIND.size
    span_len = body[o]
    span = body[o + 1:o + 1 + span_len].decode(errors="replace")
    return token, kind, body[o + 1 + span_len:], span


class TcpTransport:
    """Thread-per-connection transport endpoint (server and client halves).

    register(token, handler) installs `handler(payload: bytes) -> bytes`;
    incoming request frames dispatch by token and the returned bytes go
    back as a reply frame correlated by the embedded reply token."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._handlers: Dict[int, Callable[[bytes], bytes]] = {}
        self._lock = threading.Lock()
        # Serializes whole frames onto shared sockets: sendall can
        # interleave across threads on partial sends, corrupting the
        # peer's framing.
        self._send_lock = threading.Lock()
        self._replies: Dict[int, threading.Event] = {}
        self._reply_data: Dict[int, bytes] = {}
        self._next_reply_token = 1 << 32
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(16)
        self.address = self._listener.getsockname()
        self._stopping = False
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        self._peer_socks: Dict[Tuple[str, int], socket.socket] = {}
        # Per-peer health telemetry (rpc/peer_metrics.py):
        # request/reply RTTs, timeout/disconnect counters, bytes both
        # ways — the real-TCP half of the gray-failure plane.  Samples
        # are gated on PEER_HEALTH_ENABLED at each call site.
        from .peer_metrics import PeerMetricsTable
        self.peer_metrics = PeerMetricsTable(
            f"{self.address[0]}:{self.address[1]}")
        self._ever_connected: set = set()

    # -- server half ---------------------------------------------------------
    def register(self, token: int, handler: Callable[[bytes], bytes]) -> None:
        self._handlers[token] = handler

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        # ConnectPacket-style handshake (reference :355): refuse mismatched
        # protocol versions up front.
        hs = _recv_exact(conn, 6)
        if hs is None:
            return
        magic, ver = struct.unpack("<IH", hs)
        if magic != MAGIC or ver != PROTOCOL_VERSION:
            conn.close()
            return
        conn.sendall(struct.pack("<IH", MAGIC, PROTOCOL_VERSION))
        self._frame_loop(conn)

    def _frame_loop(self, conn: socket.socket) -> None:
        while True:
            frame = _recv_frame(conn)
            if frame is None:
                return
            token, kind, payload, span = frame
            if kind == KIND_REQUEST:
                r = Reader(payload)
                body = r.bytes_()
                reply_token = r.i64()
                handler = self._handlers.get(token)
                if handler is None:
                    continue   # unknown endpoint: drop (broken promise)
                # The reply echoes the caller's span back (reference:
                # SpanContext rides each FlowTransport packet).
                try:
                    result = handler(body)
                except Exception:  # noqa: BLE001 — one bad request must
                    # not tear down the connection; the caller's reply
                    # promise breaks via its timeout.
                    continue
                with self._send_lock:
                    _send_frame(conn, reply_token, KIND_REPLY, result,
                                span)
            elif kind == KIND_REPLY:
                with self._lock:
                    ev = self._replies.get(token)
                    if ev is None:
                        continue   # late reply after timeout: drop, don't leak
                    self._reply_data[token] = payload
                ev.set()

    # -- client half ---------------------------------------------------------
    def _connect(self, addr: Tuple[str, int]) -> socket.socket:
        with self._lock:
            sock = self._peer_socks.get(addr)
        if sock is not None:
            return sock
        sock = socket.create_connection(addr)
        sock.sendall(struct.pack("<IH", MAGIC, PROTOCOL_VERSION))
        ack = _recv_exact(sock, 6)
        if ack is None:
            raise ConnectionError("peer closed during handshake")
        magic, ver = struct.unpack("<IH", ack)
        if magic != MAGIC or ver != PROTOCOL_VERSION:
            raise ConnectionError("protocol version mismatch")
        with self._lock:
            existing = self._peer_socks.get(addr)
            if existing is not None:
                sock.close()   # lost the connect race; use the winner
                return existing
            self._peer_socks[addr] = sock
            if addr in self._ever_connected:
                from ..core.knobs import server_knobs
                if server_knobs().PEER_HEALTH_ENABLED:
                    self.peer_metrics.sample_reconnect(
                        f"{addr[0]}:{addr[1]}")
            self._ever_connected.add(addr)
        # The outbound handshake already happened; run the bare frame loop
        # (replies and peer-initiated requests both arrive here).
        threading.Thread(target=self._frame_loop, args=(sock,),
                         daemon=True).start()
        return sock

    def request(self, addr: Tuple[str, int], token: int, payload: bytes,
                timeout: float = 10.0, span: str = "") -> bytes:
        """Blocking request/reply over the peer connection.  `span` rides
        the frame and its reply."""
        from ..core.knobs import server_knobs
        sample = bool(server_knobs().PEER_HEALTH_ENABLED)
        peer_key = f"{addr[0]}:{addr[1]}"
        try:
            sock = self._connect(addr)
        except (OSError, ConnectionError):
            if sample:
                self.peer_metrics.sample_disconnect(peer_key)
            raise
        with self._lock:
            reply_token = self._next_reply_token
            self._next_reply_token += 1
            ev = threading.Event()
            self._replies[reply_token] = ev
        body = Writer().bytes_(payload).i64(reply_token).done()
        if sample:
            self.peer_metrics.sample_request(peer_key, len(body))
            import time as _time
            t0 = _time.monotonic()
        with self._send_lock:
            _send_frame(sock, token, KIND_REQUEST, body, span)
        try:
            if not ev.wait(timeout):
                if sample:
                    self.peer_metrics.sample_timeout(peer_key)
                raise TimeoutError(f"no reply for token {token}")
            with self._lock:
                reply = self._reply_data.pop(reply_token)
            if sample:
                import time as _time
                self.peer_metrics.sample_rtt(
                    peer_key,
                    _time.monotonic() - t0,
                    nbytes=len(reply))
            return reply
        finally:
            # Always unregister both entries, or timed-out waits leak
            # (late replies are dropped at the frame loop once the wait
            # entry is gone).
            with self._lock:
                self._replies.pop(reply_token, None)
                self._reply_data.pop(reply_token, None)

    def close(self) -> None:
        self._stopping = True
        try:
            self._listener.close()
        except OSError:
            pass
        # Snapshot under the lock: _connect threads may still be
        # registering winners of a connect race.
        with self._lock:
            socks = list(self._peer_socks.values())
        for s in socks:
            try:
                s.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Demonstrator message serialization (classic field-order style)
# ---------------------------------------------------------------------------

TOKEN_KV_GET = 0x100
TOKEN_KV_SET = 0x101
TOKEN_KV_RANGE = 0x102


def pack_kv_set(key: bytes, value: bytes) -> bytes:
    return Writer().bytes_(key).bytes_(value).done()


def unpack_kv_set(b: bytes) -> Tuple[bytes, bytes]:
    r = Reader(b)
    return r.bytes_(), r.bytes_()


def pack_kv_get(key: bytes) -> bytes:
    return Writer().bytes_(key).done()


def pack_value_reply(value: Optional[bytes]) -> bytes:
    w = Writer().u8(1 if value is not None else 0)
    if value is not None:
        w.bytes_(value)
    return w.done()


def unpack_value_reply(b: bytes) -> Optional[bytes]:
    r = Reader(b)
    return r.bytes_() if r.u8() else None
