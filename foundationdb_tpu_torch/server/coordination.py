"""Coordinators: generation registers, leader election, coordinated state
(a trimmed copy of foundationdb_tpu/server/coordination.py).

Reference: fdbserver/Coordination.actor.cpp -- each coordinator hosts a
disk-backed generation register (localGenerationReg :106) and a leader
election register (LeaderElectionRegInterface :132); coordinationServer
(:722) serves both.  CoordinatedState (fdbserver/CoordinatedState.actor.cpp)
layers a two-phase read/write of the DBCoreState over a majority of the
generation registers; tryBecomeLeader (fdbserver/LeaderElection.h:40)
elects the cluster controller.

Generation-register protocol (single-decree, per key):
  read(key, gen):  rgen := max(rgen, gen); reply (value, vgen, old_rgen)
  write(key, kv, gen): accept iff gen >= rgen and gen > wgen;
                       then (value, wgen) := (kv, gen), rgen := max(rgen, gen)
A quorum read with a fresh unique gen followed by a quorum write at that
same gen is linearizable: any later reader's quorum intersects ours.

Kept: Generation, the register and election messages, LeaderInfo,
CoordinationServer (:111) over the port's KVStoreMemory (synchronous: a
register's state is committed before the reply that promises it),
CoordinationClientInterface (:405), parse_spec / normalize_spec,
CoordinatedState (:479), try_become_leader (:643), monitor_leader (:711)
and _lead (:760), and the coordinators change: the forward marker
(pack_forward / unpack_forward :445), a forwarded register's replies
(_forward_spec), move_coordinated_state (:562) and _follow_forward
(:629).  Left out: set_forward_hook (:624) and the on_forward arguments,
whose only caller is the cluster-file rewriter of fdbserver.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..core.buggify import buggify
from ..core.error import FdbError, err
from ..core.futures import Future, Promise, swallow, wait_any
from ..core.rng import deterministic_random
from ..core.scheduler import TaskPriority, delay, now
from ..core.trace import Severity, TraceEvent
from ..core.wire import Reader, Writer
from ..rpc.endpoint import RequestStream


# Generation numbers: (battle counter, unique id) ordered lexicographically
# (reference UniqueGeneration, CoordinationInterface.h:65).

@dataclass(frozen=True, order=True)
class Generation:
    battle: int = 0
    uid: int = 0


@dataclass
class GenRegReadRequest:
    key: bytes
    gen: Generation
    reply: Any = None


@dataclass
class GenRegReadReply:
    value: Optional[bytes]
    vgen: Generation     # generation that wrote `value`
    rgen: Generation     # highest read generation seen (before this read)


@dataclass
class GenRegWriteRequest:
    key: bytes
    value: bytes
    gen: Generation
    reply: Any = None


@dataclass
class GenRegWriteReply:
    gen: Generation      # the register's wgen after the attempt


@dataclass
class CandidacyRequest:
    """Announce candidacy; replies when the known leader changes
    (reference CoordinationInterface.h:133)."""

    key: bytes
    my_info: "LeaderInfo"
    known_leader_change_id: int
    reply: Any = None


@dataclass
class LeaderHeartbeatRequest:
    key: bytes
    my_info: "LeaderInfo"
    reply: Any = None


@dataclass
class LeaderGetRequest:
    """Observe the nominee without becoming a candidate (the client side
    of MonitorLeader); replies when the nominee differs from
    known_leader_change_id."""

    key: bytes
    known_leader_change_id: int = -1
    reply: Any = None


@dataclass
class LeaderInfo:
    """A candidate or leader (reference LeaderInfo: the lower change id
    wins)."""

    change_id: int
    serialized_info: Any = None      # the would-be controller's interface
    forward: bool = False


class CoordinationServer:
    """One coordinator: generation registers and leader election.

    With `fs` set, every register change (a read generation's bump
    included: it is a promise to refuse older writers) is committed to a
    KVStoreMemory under coord-<id> before the reply, and a rebooted
    coordinator recovers the registers.  Election state is in memory, as
    the reference's is."""

    def __init__(self, server_id: str = "coord", fs=None) -> None:
        self.id = server_id
        # Per key: (value, vgen, rgen).  The value is the live object for
        # in-memory readers; after a reboot only its packed bytes survive
        # (callers unpack).
        self._reg: Dict[bytes, Tuple[Any, Generation, Generation]] = {}
        self._store = None
        if fs is not None:
            from .kvstore import KVStoreMemory
            self._store = KVStoreMemory(fs, f"coord-{server_id}")
        self._nominee: Dict[bytes, Optional[LeaderInfo]] = {}
        self._nominee_waiters: Dict[bytes, List[Promise]] = {}
        self._candidates: Dict[bytes, Dict[int, LeaderInfo]] = {}
        self._last_heartbeat: Dict[bytes, float] = {}
        # When each candidate last re-sent its candidacy: the liveness of
        # a candidate that is not yet a heartbeating leader.
        self._cand_time: Dict[bytes, Dict[int, float]] = {}
        self.reg_read = RequestStream("coord.read", TaskPriority.Coordination)
        self.reg_write = RequestStream("coord.write",
                                       TaskPriority.Coordination)
        self.candidacy = RequestStream("coord.candidacy",
                                       TaskPriority.Coordination)
        self.heartbeat = RequestStream("coord.heartbeat",
                                       TaskPriority.Coordination)
        self.leader_get = RequestStream("coord.leaderGet",
                                        TaskPriority.Coordination)

    # -- generation register -------------------------------------------------
    def _recover(self) -> None:
        """Recover persisted registers before serving (reference
        OnDemandStore recovery)."""
        if self._store is None:
            return
        self._store.recover()
        for k, blob in self._store.read_range(b"reg/", b"reg0"):
            r = Reader(blob)
            value = r.bytes_() if r.u8() else None
            vgen = Generation(r.i64(), r.i64())
            rgen = Generation(r.i64(), r.i64())
            self._reg[k[len(b"reg/"):]] = (value, vgen, rgen)
        TraceEvent("CoordinationRecovered").detail(
            "Id", self.id).detail("Keys", len(self._reg)).log()

    async def _persist(self, key: bytes) -> None:
        """Commit one register's state before any reply that promises
        it."""
        if self._store is None:
            return
        if buggify("coord.slowDisk"):
            await delay(0.05)
        value, vgen, rgen = self._reg[key]
        if isinstance(value, (bytes, bytearray)):
            packed = bytes(value)
        elif value is not None and hasattr(value, "pack"):
            packed = value.pack()
        else:
            packed = None
        w = Writer().u8(1 if packed is not None else 0)
        if packed is not None:
            w.bytes_(packed)
        w.i64(vgen.battle).i64(vgen.uid).i64(rgen.battle).i64(rgen.uid)
        self._store.set(b"reg/" + key, w.done())
        self._store.commit()

    async def _serve_reads(self) -> None:
        async for req in self.reg_read.queue:
            value, vgen, rgen = self._reg.get(
                req.key, (None, Generation(), Generation()))
            new_rgen = max(rgen, req.gen)
            self._reg[req.key] = (value, vgen, new_rgen)
            if new_rgen != rgen:
                await self._persist(req.key)
            req.reply.send(GenRegReadReply(value=value, vgen=vgen, rgen=rgen))

    async def _serve_writes(self) -> None:
        async for req in self.reg_write.queue:
            value, vgen, rgen = self._reg.get(
                req.key, (None, Generation(), Generation()))
            if req.gen >= rgen and req.gen > vgen:
                self._reg[req.key] = (req.value, req.gen, max(rgen, req.gen))
                await self._persist(req.key)
                req.reply.send(GenRegWriteReply(gen=req.gen))
                # A forward write deposes any elected leader and redirects
                # every waiting candidate and observer at once.
                spec = (unpack_forward(req.value)
                        if req.key == CSTATE_KEY else None)
                if spec is not None:
                    TraceEvent("CoordinatorForwarded").detail(
                        "Id", self.id).detail("NewSpec", spec).log()
                    self._set_nominee(LEADER_KEY, LeaderInfo(
                        change_id=-2, serialized_info=spec, forward=True))
            else:
                # Refused: the winning generation tells the caller it lost.
                req.reply.send(GenRegWriteReply(gen=max(vgen, rgen)))

    def _forward_spec(self) -> Optional[str]:
        """The new connection spec if a quorum change forwarded this
        coordinator's cstate register, else None."""
        value, _, _ = self._reg.get(CSTATE_KEY,
                                    (None, Generation(), Generation()))
        return unpack_forward(value)

    def _forward_reply(self, req) -> bool:
        """Answer `req` with the forward when the register holds one."""
        spec = self._forward_spec()
        if spec is None:
            return False
        req.reply.send(LeaderInfo(change_id=-2, serialized_info=spec,
                                  forward=True))
        return True

    # -- leader election -----------------------------------------------------
    def _best_candidate(self, key: bytes) -> Optional[LeaderInfo]:
        cands = self._candidates.get(key, {})
        if not cands:
            return None
        return min(cands.values(), key=lambda c: c.change_id)

    def _set_nominee(self, key: bytes, nominee: Optional[LeaderInfo]) -> None:
        cur = self._nominee.get(key)
        cur_id = cur.change_id if cur else -1
        new_id = nominee.change_id if nominee else -1
        if cur_id == new_id:
            return
        self._nominee[key] = nominee
        # A fresh nominee gets a heartbeat interval before expiry may
        # evict it.
        self._last_heartbeat[key] = now()
        for p in self._nominee_waiters.pop(key, []):
            p.send(nominee)

    async def _serve_candidacy(self) -> None:
        async for req in self.candidacy.queue:
            self._process.spawn(self._handle_candidacy(req),
                                f"{self.id}.candidacy")

    async def _handle_candidacy(self, req: CandidacyRequest) -> None:
        if self._forward_reply(req):
            return
        self._candidates.setdefault(req.key, {})[
            req.my_info.change_id] = req.my_info
        self._cand_time.setdefault(req.key, {})[
            req.my_info.change_id] = now()
        self._maybe_renominate(req.key)
        nominee = self._nominee.get(req.key)
        # Answer at once when the requester is the standing nominee, even
        # if it already knows that change id: a deposed leader that every
        # register still nominates must learn it now, or the election
        # deadlocks with nobody leading.
        if nominee is not None and \
                (nominee.change_id != req.known_leader_change_id or
                 nominee.change_id == req.my_info.change_id):
            req.reply.send(nominee)
            return
        p: Promise = Promise()
        self._nominee_waiters.setdefault(req.key, []).append(p)
        req.reply.send(await p.get_future())

    def _maybe_renominate(self, key: bytes) -> None:
        if self._forward_spec() is not None:
            return                      # forwarded: never elect again
        cur = self._nominee.get(key)
        best = self._best_candidate(key)
        stale = (cur is not None and
                 now() - self._last_heartbeat.get(key, 0.0) > 2.0)
        if cur is None or stale or (
                best is not None and best.change_id < cur.change_id):
            self._set_nominee(key, best)

    async def _serve_leader_get(self) -> None:
        async for req in self.leader_get.queue:
            self._process.spawn(self._handle_leader_get(req),
                                f"{self.id}.leaderGet")

    async def _handle_leader_get(self, req: LeaderGetRequest) -> None:
        if self._forward_reply(req):
            return
        nominee = self._nominee.get(req.key)
        if nominee is not None and \
                nominee.change_id != req.known_leader_change_id:
            req.reply.send(nominee)
            return
        p: Promise = Promise()
        self._nominee_waiters.setdefault(req.key, []).append(p)
        req.reply.send(await p.get_future())

    async def _serve_heartbeat(self) -> None:
        async for req in self.heartbeat.queue:
            if self._forward_spec() is not None:
                req.reply.send(False)     # forwarded: depose the leader
                continue
            cur = self._nominee.get(req.key)
            if cur is not None and cur.change_id == req.my_info.change_id:
                self._last_heartbeat[req.key] = now()
                req.reply.send(True)
            else:
                req.reply.send(False)    # deposed: stop being leader

    async def _expiry_loop(self) -> None:
        """Drop dead leaders and dead candidates (reference
        leaderRegister's timeouts).  A confirmed leader heartbeats; an
        unconfirmed candidate re-sends its candidacy (the lease)."""
        from ..core.knobs import server_knobs
        while True:
            await delay(1.0)
            if self._forward_spec() is not None:
                continue
            lease = float(server_knobs().COORD_CANDIDACY_LEASE_S)
            for key in list(self._candidates):
                cands = self._candidates.get(key, {})
                times = self._cand_time.setdefault(key, {})
                cur = self._nominee.get(key)
                cur_id = cur.change_id if cur is not None else None
                for cid in [cid for cid in list(cands)
                            if cid != cur_id and
                            now() - times.get(cid, 0.0) > lease]:
                    cands.pop(cid, None)
                    times.pop(cid, None)
                if cur is None:
                    continue
                hb_stale = now() - self._last_heartbeat.get(key, 0.0) > 2.0
                cand_stale = now() - times.get(cur_id, 0.0) > lease
                if hb_stale and cand_stale:
                    cands.pop(cur_id, None)
                    times.pop(cur_id, None)
                    self._set_nominee(key, self._best_candidate(key))

    def streams(self) -> List[RequestStream]:
        return [self.reg_read, self.reg_write, self.candidacy,
                self.heartbeat, self.leader_get]

    def run(self, process) -> None:
        """Recover the registers, register the streams under the
        well-known tokens (reference WLTOKEN_*: a coordinator is reached
        from its address alone) and serve."""
        self._process = process
        self._recover()
        for s, tok in zip(self.streams(), WELL_KNOWN_COORD_TOKENS):
            process.register(s, token=tok)
        process.spawn(self._serve_reads(), f"{self.id}.reads")
        process.spawn(self._serve_writes(), f"{self.id}.writes")
        process.spawn(self._serve_candidacy(), f"{self.id}.candidacy")
        process.spawn(self._serve_leader_get(), f"{self.id}.leaderGet")
        process.spawn(self._serve_heartbeat(), f"{self.id}.heartbeat")
        process.spawn(self._expiry_loop(), f"{self.id}.expiry")


WELL_KNOWN_COORD_TOKENS = (
    "wl:coord.read", "wl:coord.write", "wl:coord.candidacy",
    "wl:coord.heartbeat", "wl:coord.leaderGet")


class CoordinationClientInterface:
    """Client handle to one coordinator's streams."""

    def __init__(self, server: CoordinationServer) -> None:
        self.reg_read = server.reg_read.endpoint
        self.reg_write = server.reg_write.endpoint
        self.candidacy = server.candidacy.endpoint
        self.heartbeat = server.heartbeat.endpoint
        self.leader_get = server.leader_get.endpoint

    @classmethod
    def at_address(cls, address) -> "CoordinationClientInterface":
        """Endpoints from a coordinator's address alone, through the
        well-known tokens (reference ClusterConnectionString)."""
        from ..rpc.endpoint import Endpoint
        self = cls.__new__(cls)
        (self.reg_read, self.reg_write, self.candidacy, self.heartbeat,
         self.leader_get) = (Endpoint(address, t)
                             for t in WELL_KNOWN_COORD_TOKENS)
        return self


def parse_spec(spec: str) -> List[CoordinationClientInterface]:
    """Coordinator handles from a connection spec "ip:port,..."."""
    from ..rpc.endpoint import NetworkAddress
    out = []
    for part in spec.split(","):
        host, port = part.strip().rsplit(":", 1)
        out.append(CoordinationClientInterface.at_address(
            NetworkAddress(host, int(port))))
    return out


def normalize_spec(spec: str) -> str:
    """The canonical "ip:port,ip:port" form of a connection spec."""
    return ",".join(
        f"{c.reg_read.address.ip}:{c.reg_read.address.port}"
        for c in parse_spec(spec))


# ---------------------------------------------------------------------------
# CoordinatedState: quorum read/write over the generation registers
# (reference fdbserver/CoordinatedState.actor.cpp)
# ---------------------------------------------------------------------------

CSTATE_KEY = b"dbCoreState"

# The forward marker a quorum change writes into the old quorum's cstate
# register (reference MovableValue::MovedFrom and LeaderInfo.forward): a
# forwarded coordinator answers every cstate read and election request
# with the new connection spec.
FORWARD_MAGIC = b"\xffMOVEDTO\xff"


def pack_forward(spec: str) -> bytes:
    return FORWARD_MAGIC + spec.encode()


def unpack_forward(value) -> Optional[str]:
    if isinstance(value, (bytes, bytearray)) and \
            bytes(value[:len(FORWARD_MAGIC)]) == FORWARD_MAGIC:
        return bytes(value[len(FORWARD_MAGIC):]).decode()
    return None


class CoordinatedState:
    """Two-phase quorum state machine over the coordinators."""

    def __init__(self, coordinators: List[CoordinationClientInterface]) -> None:
        self.coordinators = coordinators
        self._gen: Optional[Generation] = None
        self._battle = 0

    @property
    def _quorum(self) -> int:
        return len(self.coordinators) // 2 + 1

    async def _quorum_replies(self, futures: List[Future]) -> List[Any]:
        """Wait for a majority of successful replies; timed_out once a
        majority cannot answer."""
        replies: List[Any] = []
        failed = 0
        pending = {i: f for i, f in enumerate(futures)}
        while len(replies) < self._quorum:
            if failed > len(futures) - self._quorum:
                raise err("timed_out", "coordination quorum unreachable")
            idx, _ = await wait_any([swallow(f) for f in pending.values()])
            key = list(pending.keys())[idx]
            f = pending.pop(key)
            if f.is_error():
                failed += 1
            else:
                replies.append(f.get())
        return replies

    async def read(self) -> Optional[bytes]:
        """Phase 1: quorum read; the value with the highest write
        generation.  Retries with a higher battle number until this
        generation tops every rgen the quorum reports (Paxos prepare)."""
        while True:
            self._battle += 1
            gen = Generation(self._battle,  # flowlint: state -- CAS generation snapshot (disk-paxos)
                             deterministic_random().random_int(1, 1 << 30))
            futures = [RequestStream.at(c.reg_read).get_reply(
                GenRegReadRequest(key=CSTATE_KEY, gen=gen))
                for c in self.coordinators]
            replies = await self._quorum_replies(futures)
            best: Optional[GenRegReadReply] = None
            lost = False
            for r in replies:
                if best is None or r.vgen > best.vgen:
                    best = r
                # r.rgen is the register's high-water before our read.
                if r.rgen >= gen:
                    lost = True
                self._battle = max(self._battle, r.rgen.battle)
            if lost:
                continue
            self._gen = gen
            value = best.value if best else None
            spec = unpack_forward(value)
            if spec is not None:
                e = err("coordinators_changed",
                        f"coordinated state moved to {spec}")
                e.new_spec = spec
                raise e
            return value

    async def write(self, value: bytes) -> None:
        """Phase 2: quorum write at the read generation; raises
        coordinated_state_conflict if another writer won."""
        assert self._gen is not None, "read() before write()"
        gen = self._gen  # flowlint: state -- CAS generation snapshot (disk-paxos)
        futures = [RequestStream.at(c.reg_write).get_reply(
            GenRegWriteRequest(key=CSTATE_KEY, value=value, gen=gen))
            for c in self.coordinators]
        replies = await self._quorum_replies(futures)
        if any(r.gen != gen for r in replies):
            raise err("coordinated_state_conflict",
                      "another process wrote the coordinated state")


async def move_coordinated_state(cstate: CoordinatedState,
                                 new_spec: str) -> None:
    """Quorum change (reference changeQuorum + MovableCoordinatedState):
    seed the new quorum with the current DBCoreState, then forward the
    old quorum.  Run by the master when the committed \\xff/coordinators
    differs from the quorum it recovered on; the epoch ends right after.
    Before the forward write the old quorum stays authoritative (the
    seeded copy is inert); once it lands every reader finds the new
    spec."""
    new_coords = parse_spec(new_spec)
    old_addrs = {(c.reg_read.address.ip, c.reg_read.address.port)
                 for c in cstate.coordinators
                 if getattr(c.reg_read, "address", None) is not None}
    new_addrs = {(c.reg_read.address.ip, c.reg_read.address.port)
                 for c in new_coords}
    if old_addrs & new_addrs:
        # A coordinator in both quorums would hold one cstate register for
        # the seeded state and the forward marker at once.
        raise err("client_invalid_operation",
                  "new quorum must not share members with the old one "
                  f"(shared: {sorted(old_addrs & new_addrs)})")
    cur = await cstate.read()     # fresh generation; raises if moved
    packed = (bytes(cur) if isinstance(cur, (bytes, bytearray))
              else cur.pack() if cur is not None else None)
    cs_new = CoordinatedState(new_coords)
    try:
        await cs_new.read()
    except FdbError as e:
        if e.name != "coordinators_changed":
            raise
        raise err("coordinated_state_conflict",
                  f"target quorum {new_spec} is itself forwarded")
    if packed is not None:
        await cs_new.write(packed)
    await cstate.write(pack_forward(new_spec))
    TraceEvent("CoordinatorsMoved").detail("NewSpec", new_spec).log()


# ---------------------------------------------------------------------------
# Leader election client (reference fdbserver/LeaderElection.h:40)
# ---------------------------------------------------------------------------

LEADER_KEY = b"clusterLeader"

def _follow_forward(coordinators: List[CoordinationClientInterface],
                    spec: str) -> None:
    """Redirect to a moved quorum: swap the shared coordinator list in
    place (workers, the master and clients hold the same list object), so
    whichever of a process's loops sees a forward first redirects them
    all."""
    TraceEvent("CoordinatorsForwardFollowed", Severity.Warn).detail(
        "NewSpec", spec).log()
    coordinators[:] = parse_spec(spec)


async def try_become_leader(coordinators: List[CoordinationClientInterface],
                            my_info_payload: Any,
                            out_current_leader,  # AsyncVar[LeaderInfo|None]
                            change_id: Optional[int] = None) -> None:
    """Campaign forever: register candidacy with every coordinator;
    whoever a majority nominates is leader.  If we are, heartbeat until
    deposed; `out_current_leader` follows the majority's leader.  A
    forward reply swaps the coordinator list in place and campaigns on
    the new quorum.  Runs until cancelled."""
    my_info = LeaderInfo(
        change_id=(change_id if change_id is not None
                   else deterministic_random().random_int(0, 1 << 30)),
        serialized_info=my_info_payload)
    known_change_id = -1
    while True:
        futures = [RequestStream.at(c.candidacy).get_reply(
            CandidacyRequest(key=LEADER_KEY, my_info=my_info,
                             known_leader_change_id=known_change_id))
            for c in coordinators]
        elected = await _majority_nominee(futures, len(coordinators))
        if elected is not None and elected.forward:
            _follow_forward(coordinators, elected.serialized_info)
            known_change_id = -1
            continue
        if elected is None:
            await delay(0.5)
            continue
        known_change_id = elected.change_id
        out_current_leader.set(elected)
        if elected.change_id == my_info.change_id:
            TraceEvent("BecameLeader").detail("ChangeId",
                                              my_info.change_id).log()
            await _lead(coordinators, my_info)
            # Deposed: campaign again, forgetting the known leader (it was
            # us, and registers still naming us would park the next
            # round's candidacy replies).
            TraceEvent("LeaderDeposed", Severity.Warn).detail(
                "ChangeId", my_info.change_id).log()
            out_current_leader.set(None)
            known_change_id = -1


async def _majority_nominee(futures: List[Future], n: int,
                            give_up: bool = False) -> Optional[LeaderInfo]:
    """The nominee a majority of the `n` registers answers with, the first
    forward any register answers with, or None when the answers run out
    first (`give_up`: also once too many failed for a majority)."""
    quorum = n // 2 + 1
    votes: Dict[int, int] = {}
    pending = list(futures)
    failed = 0
    while pending:
        if give_up and failed > n - quorum:
            return None
        idx, _ = await wait_any([swallow(f) for f in pending])
        f = pending.pop(idx)
        if f.is_error():
            failed += 1
            continue
        nominee = f.get()
        if nominee is None:
            continue
        if nominee.forward:
            return nominee
        votes[nominee.change_id] = votes.get(nominee.change_id, 0) + 1
        if votes[nominee.change_id] >= quorum:
            return nominee
    return None


async def monitor_leader(coordinators: List[CoordinationClientInterface],
                         out_leader) -> None:
    """Track the elected leader without campaigning (reference
    MonitorLeader): `out_leader` (an AsyncVar) follows the majority's
    nominee; a forward reply swaps the coordinator list in place.  Runs
    until cancelled."""
    known_change_id = -1
    while True:
        futures = [RequestStream.at(c.leader_get).get_reply(
            LeaderGetRequest(key=LEADER_KEY,
                             known_leader_change_id=known_change_id))
            for c in coordinators]
        elected = await _majority_nominee(futures, len(coordinators),
                                          give_up=True)
        if elected is not None and elected.forward:
            _follow_forward(coordinators, elected.serialized_info)
            known_change_id = -1
            continue
        if elected is not None and elected.change_id != known_change_id:
            known_change_id = elected.change_id
            out_leader.set(elected)
        elif elected is None:
            await delay(0.5)


async def _lead(coordinators: List[CoordinationClientInterface],
                my_info: LeaderInfo) -> None:
    """Heartbeat a majority every 0.5 s; return when deposed."""
    while True:
        futures = [RequestStream.at(c.heartbeat).get_reply(
            LeaderHeartbeatRequest(key=LEADER_KEY, my_info=my_info))
            for c in coordinators]
        acks = 0
        pending = list(futures)
        while pending:
            idx, _ = await wait_any([swallow(f) for f in pending])
            f = pending.pop(idx)
            if not f.is_error() and f.get() is True:
                acks += 1
        if acks < len(coordinators) // 2 + 1:
            return
        await delay(0.5)
