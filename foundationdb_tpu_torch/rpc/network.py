"""Simulated network: deterministic latency, clogging, partitions (a copy
of foundationdb_tpu/rpc/network.py).

Reference: fdbrpc/sim2.actor.cpp — Sim2Conn (:181) models per-connection
latency and delivery; SimClogging (:121) delays traffic between process
pairs; FlowTransport delivers by endpoint token (FlowTransport.actor.cpp:919
deliver()).  This module collapses transport + sim-network into one object:
every message delivery is a scheduled callback on the shared deterministic
event loop, with latency drawn from the deterministic RNG.

Failure semantics (matching what upper layers can observe in the reference):
  * target process dead / endpoint unregistered / pair partitioned
      → caller's reply future gets broken_promise after ~latency
        (the transport's connection-failure signal);
  * receiver drops its ReplyPromise unset (actor cancelled by kill/reboot)
      → broken_promise routed back;
  * clogged pair → delivery (or reply) deferred until unclogged, never lost.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ..core.error import err
from ..core.futures import Future, Promise
from ..core.rng import deterministic_random
from ..core.scheduler import TaskPriority, get_event_loop
from ..core.trace import Severity, TraceEvent
from .endpoint import Endpoint, NetworkAddress, ReplyPromise, RequestStream


class SimNetwork:
    """All inter-process message passing in a simulation."""

    MIN_LATENCY = 0.0001
    MAX_LATENCY = 0.0015

    def __init__(self) -> None:
        # (address, token) -> (stream, epoch of registering process)
        self._endpoints: Dict[Endpoint, Tuple[RequestStream, int]] = {}
        # address -> SimProcess (set by Simulator)
        self.processes: Dict[NetworkAddress, Any] = {}
        # (ip, ip) -> virtual time until which the pair is clogged
        self._clog_until: Dict[Tuple[str, str], float] = {}
        # ip -> virtual time until which ALL its traffic is clogged
        # (reference sim2 clogInterface — the unit the nemesis swizzles).
        self._clog_ip_until: Dict[str, float] = {}
        self._partitioned: set = set()  # frozenset({ip, ip})
        # Gray clog: (ip, ip) -> (extra latency, until).
        # Unlike a clog, delivery still HAPPENS — just inflated: the
        # slow-but-alive link shape that quorum checks can never see and
        # the peer-health plane exists to detect.
        self._gray_until: Dict[Tuple[str, str], Tuple[float, float]] = {}
        # Per-source-ip peer telemetry (rpc/peer_metrics.py): each
        # simulated process observes its own peers, exactly like one
        # real-mode process's transport table.
        self._peer_tables: Dict[str, Any] = {}
        self.messages_sent = 0

    # -- registration -------------------------------------------------------
    def register(self, process, stream: RequestStream,
                 token: Optional[str] = None) -> Endpoint:
        token = token or (stream.name + ":" +
                          deterministic_random().random_unique_id()[:16])
        ep = Endpoint(process.address, token)
        self._endpoints[ep] = (stream, process.epoch)
        stream.set_endpoint(ep)
        process._tokens.add(token)
        return ep

    def unregister_process(self, address: NetworkAddress) -> None:
        """Drop every endpoint at `address` (process killed/rebooted).

        Buffered-but-unserved requests get their reply promises broken
        DETERMINISTICALLY here: leaving them to reply-wrapper __del__ means
        a request caught in a reference cycle only breaks when cyclic GC
        happens to run — observed as wall-clock-dependent post-kill stalls
        (the reference's SAV destruction is deterministic by refcount)."""
        for ep in [e for e in self._endpoints if e.address == address]:
            stream, _epoch = self._endpoints.pop(ep)
            stream.queue.break_buffered_replies()

    def unregister_stream(self, stream: RequestStream) -> None:
        """Drop ONE stream's endpoint (a replaced role halting while its
        process lives on): senders from then on get broken_promise instead
        of buffering into a queue nobody serves."""
        ep = stream._endpoint
        if ep is not None:
            self._endpoints.pop(ep, None)
        stream.queue.break_buffered_replies()

    # -- fault injection ----------------------------------------------------
    def clog_pair(self, a: str, b: str, seconds: float) -> None:
        """Delay all traffic between ips a and b for `seconds` (reference
        ISimulator::clogPair, sim2 SimClogging)."""
        until = get_event_loop().now() + seconds
        for pair in ((a, b), (b, a)):
            self._clog_until[pair] = max(self._clog_until.get(pair, 0.0), until)
        TraceEvent("ClogPair", Severity.Info).detail("A", a).detail("B", b) \
            .detail("Seconds", seconds).log()

    def clog_ip(self, ip: str, seconds: float) -> None:
        """Delay ALL traffic to and from `ip` (reference
        ISimulator::clogInterface): the swizzle nemesis clogs whole
        machines one at a time and unclogs them in reverse order."""
        until = get_event_loop().now() + seconds
        self._clog_ip_until[ip] = max(self._clog_ip_until.get(ip, 0.0),
                                      until)
        TraceEvent("ClogInterface", Severity.Info).detail(
            "IP", ip).detail("Seconds", seconds).log()

    def unclog_ip(self, ip: str) -> None:
        if self._clog_ip_until.pop(ip, None) is not None:
            TraceEvent("UnclogInterface", Severity.Info).detail(
                "IP", ip).log()

    def gray_clog_pair(self, a: str, b: str, extra_latency: float,
                       seconds: float) -> None:
        """Inflate latency between ips a and b by `extra_latency` for
        `seconds` WITHOUT stopping delivery — the gray-failure shape
        (half-broken NIC, saturated link): every request still succeeds,
        just slowly, so only the peer-health plane can see it."""
        until = get_event_loop().now() + seconds
        for pair in ((a, b), (b, a)):
            old = self._gray_until.get(pair)
            self._gray_until[pair] = (
                max(extra_latency, old[0]) if old else extra_latency,
                max(old[1], until) if old else until)
        TraceEvent("GrayClogPair", Severity.Info).detail("A", a).detail(
            "B", b).detail("ExtraLatency", extra_latency).detail(
            "Seconds", seconds).log()

    def ungray_pair(self, a: str, b: str) -> None:
        if self._gray_until.pop((a, b), None) is not None or \
                self._gray_until.pop((b, a), None) is not None:
            TraceEvent("UngrayPair", Severity.Info).detail(
                "A", a).detail("B", b).log()

    def partition_pair(self, a: str, b: str) -> None:
        self._partitioned.add(frozenset((a, b)))

    def heal_partition(self, a: str, b: str) -> None:
        self._partitioned.discard(frozenset((a, b)))

    def heal_all(self) -> None:
        self._partitioned.clear()
        self._clog_until.clear()
        self._clog_ip_until.clear()
        self._gray_until.clear()

    # -- peer telemetry ------------------------------------------------------
    def peer_table(self, src_ip: str):
        """The PeerMetricsTable of the process at `src_ip` (lazily
        created): what its worker health monitor folds into verdicts."""
        t = self._peer_tables.get(src_ip)
        if t is None:
            from .peer_metrics import PeerMetricsTable
            t = self._peer_tables[src_ip] = PeerMetricsTable(src_ip)
        return t

    # -- delivery -----------------------------------------------------------
    def _latency(self) -> float:
        rng = deterministic_random()
        return (self.MIN_LATENCY +
                rng.random01() * (self.MAX_LATENCY - self.MIN_LATENCY))

    _CLOG_RECHECK_S = 0.25

    def _delivery_time(self, src: str, dst: str) -> Optional[float]:
        """Virtual time at which a message sent now arrives (latency
        only — clogging is re-evaluated at delivery time, see
        _deliver_when_unclogged), or None if the pair is partitioned."""
        if frozenset((src, dst)) in self._partitioned and src != dst:
            return None
        return (get_event_loop().now() + self._latency() +
                self._gray_extra(src, dst))

    def _gray_extra(self, src: str, dst: str) -> float:
        """Extra one-way latency from an active gray clog (0.0 when the
        pair is clean or the inflation window has expired)."""
        if not self._gray_until:
            return 0.0
        entry = self._gray_until.get((src, dst))
        if entry is None:
            return 0.0
        extra, until = entry
        if get_event_loop().now() >= until:
            del self._gray_until[(src, dst)]
            return 0.0
        return extra

    def _clog_time(self, src: str, dst: str) -> float:
        clog = self._clog_until.get((src, dst), 0.0)
        if self._clog_ip_until and src != dst:
            # Self-traffic is exempt, like partitions: co-hosted roles
            # talk in-process, not over the clogged interface.
            clog = max(clog, self._clog_ip_until.get(src, 0.0),
                       self._clog_ip_until.get(dst, 0.0))
        return clog

    def _deliver_when_unclogged(self, src: str, dst: str, when: float,
                                fn, priority: TaskPriority) -> None:
        """Run `fn` at `when`, deferred while the (src, dst) path is
        clogged — re-checked AT DELIVERY TIME, not frozen at send time:
        an unclog (the nemesis's reverse-order swizzle release) must
        free traffic captured mid-clog, and a clog extended after the
        send must keep holding it.  While clogged, the re-check hops at
        min(clog expiry, now + _CLOG_RECHECK_S) so a shrunk clog
        releases within one bounded, deterministic step.  (The
        reference's re-check is a closure that names itself, a cycle
        that keeps the message, and so its reply promise, alive until
        the cyclic collector runs; here each hop is a fresh callback, so
        a message whose receiver died breaks its promise at once.)"""
        loop = get_event_loop()
        loop.call_at(when, lambda: self._clog_step(loop, src, dst, fn,
                                                   priority), priority)

    def _clog_step(self, loop, src: str, dst: str, fn,
                   priority: TaskPriority) -> None:
        clog = self._clog_time(src, dst)
        t = loop.now()
        if clog > t:
            loop.call_at(min(clog, t + self._CLOG_RECHECK_S),
                         lambda: self._clog_step(loop, src, dst, fn,
                                                 priority), priority)
        else:
            fn()

    def _process_alive(self, address: NetworkAddress, epoch: int) -> bool:
        p = self.processes.get(address)
        return p is not None and p.alive and p.epoch == epoch

    @staticmethod
    def _ambient_src_ip(ep: Endpoint) -> str:
        """The sender's ip when the caller didn't say: the address of
        the simulated process whose actor is executing right now
        (ActorTask.process, inherited through spawns).  Without this,
        src defaulted to the DESTINATION ip and the src==dst self-traffic
        exemption silently bypassed every clog and partition for request
        delivery.  Harness/client actors have no process: they send from a sentinel
        outside the machine set, so interface clogs on the TARGET still
        apply while pair faults never match."""
        from ..core.futures import current_task
        t = current_task()
        p = t.process if t is not None else None
        if p is not None:
            return p.address.ip
        return "0.0.0.0"

    def send_request(self, ep: Endpoint, request: Any,
                     priority: TaskPriority = TaskPriority.DefaultEndpoint,
                     from_address: Optional[NetworkAddress] = None) -> Future:
        """Deliver `request` to the endpoint; Future of its reply."""
        loop = get_event_loop()
        self.messages_sent += 1
        reply_promise: Promise = Promise()
        src_ip = from_address.ip if from_address \
            else self._ambient_src_ip(ep)
        when = self._delivery_time(src_ip, ep.address.ip)
        # Peer telemetry: sample the full request->reply RTT
        # into the sender's table.  Self-traffic is exempt (co-hosted
        # roles talk in-process — a process is never its own peer), and
        # the whole plane is gated on PEER_HEALTH_ENABLED.
        from ..core.knobs import server_knobs
        table = None
        peer_key = ""
        t0 = 0.0
        if src_ip != ep.address.ip and server_knobs().PEER_HEALTH_ENABLED:
            table = self.peer_table(src_ip)
            peer_key = str(ep.address)
            table.sample_request(peer_key)
            t0 = loop.now()

        def fail() -> None:
            if not reply_promise.is_set() and \
                    not reply_promise.get_future().is_ready():
                if table is not None:
                    table.sample_disconnect(peer_key)
                reply_promise.send_error(err("broken_promise"))

        if when is None:  # partitioned: connection failure after a delay
            loop.call_at(loop.now() + self._latency(), fail, priority)
            return reply_promise.get_future()

        def route_reply(value: Any, e: Optional[BaseException]) -> None:
            # Reply path: receiver -> sender, re-clogged/partitioned/timed.
            # May fire from the GC (dropped ReplyPromise) AFTER this sim
            # world was torn down — never touch the current world's RNG or
            # loop from a stale one (it would break determinism).
            from ..core.scheduler import current_event_loop_or_none
            if current_event_loop_or_none() is not loop:
                if not reply_promise.is_set() and \
                        not reply_promise.get_future().is_ready():
                    reply_promise.send_error(err("broken_promise"))
                return
            back = self._delivery_time(ep.address.ip, src_ip)

            def deliver_reply() -> None:
                if reply_promise.is_set() or \
                        reply_promise.get_future().is_ready():
                    return
                if table is not None:
                    # An application-level error reply is still a reply:
                    # the link carried it, so it samples as RTT.
                    table.sample_rtt(peer_key, loop.now() - t0, loop.now())
                if e is not None:
                    reply_promise.send_error(e)
                else:
                    reply_promise.send(value)

            if back is None:
                loop.call_at(loop.now() + self._latency(), fail, priority)
            else:
                self._deliver_when_unclogged(ep.address.ip, src_ip, back,
                                             deliver_reply, priority)

        def deliver() -> None:
            entry = self._endpoints.get(ep)
            if entry is None or not self._process_alive(ep.address, entry[1]):
                fail()
                return
            stream, _ = entry
            request.reply = ReplyPromise(route_reply)
            stream.deliver(request)

        self._deliver_when_unclogged(src_ip, ep.address.ip, when, deliver,
                                     priority)
        return reply_promise.get_future()

    def send_one_way(self, ep: Endpoint, message: Any,
                     priority: TaskPriority = TaskPriority.DefaultEndpoint,
                     from_address: Optional[NetworkAddress] = None) -> None:
        """Fire-and-forget delivery (reference sendUnreliable)."""
        self.messages_sent += 1
        src_ip = from_address.ip if from_address \
            else self._ambient_src_ip(ep)
        when = self._delivery_time(src_ip, ep.address.ip)
        if when is None:
            return

        def deliver() -> None:
            entry = self._endpoints.get(ep)
            if entry is None or not self._process_alive(ep.address, entry[1]):
                return
            entry[0].deliver(message)

        self._deliver_when_unclogged(src_ip, ep.address.ip, when, deliver,
                                     priority)


_network: Optional[SimNetwork] = None


def set_network(net: Optional[SimNetwork]) -> None:
    global _network
    _network = net


def get_network() -> SimNetwork:
    if _network is None:
        raise err("internal_error", "no SimNetwork installed (set_network)")
    return _network
