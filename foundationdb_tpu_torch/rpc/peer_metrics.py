"""Per-peer transport health telemetry (the gray-failure substrate; a
copy of foundationdb_tpu/rpc/peer_metrics.py).

Reference: fdbrpc/FlowTransport.actor.cpp Peer — every live peer carries
pingLatencies, timeoutCount, connectFailedCount, bytesSent/bytesReceived;
fdbserver/Worker health monitoring folds them into per-peer degradation
verdicts shipped to the cluster controller (UpdateWorkerHealthRequest).

This module is the shared sample plane for BOTH transports: the sim
network (rpc/network.py) keeps one PeerMetricsTable per source ip so each
simulated process observes its own peers, and the real transports
(rpc/real_network.py, rpc/transport.py) keep one process-local table.
Each table owns a CounterCollection (core/histogram.py, group
"PeerHealth"), whose emit_loop gives the {group}Metrics events.

Hot-path cost when PEER_HEALTH_ENABLED is off: one knob attribute read
per send (the transports gate every call into this module on the knob).
"""

from __future__ import annotations

from typing import Dict, Optional

from ..core.histogram import CounterCollection

# EMA fold factor for per-peer RTT: ~10 samples of memory — fast enough
# that a grayClog-ed link crosses PEER_DEGRADED_LATENCY_S within a few
# pings, slow enough that one latency spike doesn't flip a verdict alone.
EMA_ALPHA = 0.2


class PeerMetrics:
    """Health samples for ONE peer as seen from this process (reference
    FlowTransport's per-Peer counters).  Pure arithmetic — no RNG, no
    scheduling — so sampling never perturbs deterministic replays."""

    __slots__ = ("peer", "rtt_ema", "requests", "replies", "timeouts",
                 "disconnects", "reconnects", "bytes_sent",
                 "bytes_received", "last_reply_at",
                 "window_attempts", "window_failures")

    def __init__(self, peer: str) -> None:
        self.peer = peer
        self.rtt_ema: Optional[float] = None   # None until the first sample
        self.requests = 0
        self.replies = 0
        self.timeouts = 0
        self.disconnects = 0
        self.reconnects = 0
        self.bytes_sent = 0
        self.bytes_received = 0
        self.last_reply_at = 0.0
        # Current health-evaluation window (reset by take_window): the
        # timeout-fraction verdict needs attempts/failures SINCE the last
        # evaluation, not lifetime totals that old history would anchor.
        self.window_attempts = 0
        self.window_failures = 0

    def record_rtt(self, rtt: float, at: float = 0.0) -> None:
        self.replies += 1
        self.window_attempts += 1
        self.last_reply_at = at
        self.rtt_ema = rtt if self.rtt_ema is None else \
            (1.0 - EMA_ALPHA) * self.rtt_ema + EMA_ALPHA * rtt

    def record_timeout(self) -> None:
        self.timeouts += 1
        self.window_attempts += 1
        self.window_failures += 1

    def record_disconnect(self) -> None:
        self.disconnects += 1
        self.window_attempts += 1
        self.window_failures += 1

    def take_window(self) -> tuple:
        """(attempts, failures) since the previous call; resets the
        window.  One health-monitor evaluation consumes one window."""
        w = (self.window_attempts, self.window_failures)
        self.window_attempts = 0
        self.window_failures = 0
        return w

    def to_doc(self) -> Dict[str, object]:
        return {"rtt_ema": round(self.rtt_ema, 6)
                if self.rtt_ema is not None else None,
                "requests": self.requests, "replies": self.replies,
                "timeouts": self.timeouts,
                "disconnects": self.disconnects,
                "reconnects": self.reconnects,
                "bytes_sent": self.bytes_sent,
                "bytes_received": self.bytes_received}


class PeerMetricsTable:
    """All peers observed by one process, plus the aggregate
    CounterCollection (group "PeerHealth")."""

    def __init__(self, owner: str) -> None:
        self.owner = owner
        self.peers: Dict[str, PeerMetrics] = {}
        self.collection = CounterCollection("PeerHealth", owner)

    def peer(self, key: str) -> PeerMetrics:
        pm = self.peers.get(key)
        if pm is None:
            pm = self.peers[key] = PeerMetrics(key)
        return pm

    def sample_request(self, key: str, nbytes: int = 0) -> None:
        pm = self.peer(key)
        pm.requests += 1
        pm.bytes_sent += nbytes
        self.collection.counter("Requests").add(1)
        if nbytes:
            self.collection.counter("BytesSent").add(nbytes)

    def sample_rtt(self, key: str, rtt: float, at: float = 0.0,
                   nbytes: int = 0) -> None:
        pm = self.peer(key)
        pm.record_rtt(rtt, at)
        pm.bytes_received += nbytes
        self.collection.counter("Replies").add(1)
        if nbytes:
            self.collection.counter("BytesReceived").add(nbytes)
        self.collection.histogram("PeerLatency").record(rtt)

    def sample_timeout(self, key: str) -> None:
        self.peer(key).record_timeout()
        self.collection.counter("Timeouts").add(1)

    def sample_disconnect(self, key: str) -> None:
        self.peer(key).record_disconnect()
        self.collection.counter("Disconnects").add(1)

    def sample_reconnect(self, key: str) -> None:
        self.peer(key).reconnects += 1
        self.collection.counter("Reconnects").add(1)

    def to_doc(self) -> Dict[str, object]:
        return {k: self.peers[k].to_doc() for k in sorted(self.peers)}
