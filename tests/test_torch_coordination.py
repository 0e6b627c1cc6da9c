"""The port's coordinators (foundationdb_tpu_torch/server/coordination.py)
and the control plane's messages against the JAX package's.

  * The generation registers: seeded sequences of read and write requests
    (random keys, generations and values) go to one port coordinator and
    one reference coordinator, each in its own package's simulation; the
    replies (value, write generation, read generation) are equal, request
    by request.  A port coordinator over a machine's simulated files,
    killed and started again, serves the registers it had committed.
  * The leader election: seeded scripts of candidacies, heartbeats,
    observations and pauses go to both packages' coordinators; every
    reply (the nominee's change id, a heartbeat's verdict) and the
    simulated time it came back at are equal, the parked long polls and
    the expiry of silent candidates included.
  * CoordinatedState over three coordinators: a read-then-write race
    between two writers ends the same way in both packages at the same
    seed (the loser's write raises coordinated_state_conflict, the
    winner's value is what a third reader gets), and with one coordinator
    killed a majority still answers, with two it times out.
  * try_become_leader and monitor_leader: the lowest change id among
    three campaigners leads, observers see it, and a killed leader is
    replaced by the next.
  * The control plane's messages (registers, election, the worker's and
    the cluster controller's requests and replies, DatabaseConfiguration,
    ServerDBInfo with its interfaces) encode to the reference's bytes and
    decode across packages; connection specs parse and normalize as the
    reference's.

Integer and byte values throughout: tolerance 0.
"""

import numpy as np
import pytest

from foundationdb_tpu.core import scheduler as ref_sched
from foundationdb_tpu.core.rng import DeterministicRandom as RefRandom
from foundationdb_tpu.core.rng import \
    set_deterministic_random as ref_set_random
from foundationdb_tpu.rpc import endpoint as ref_endpoint
from foundationdb_tpu.rpc import serde as ref_serde
from foundationdb_tpu.rpc import sim as ref_sim
from foundationdb_tpu.server import cluster_controller as ref_cc
from foundationdb_tpu.server import coordination as ref_coord
from foundationdb_tpu.server import interfaces as ref_if
from foundationdb_tpu_torch.core import scheduler as port_sched
from foundationdb_tpu_torch.core.error import FdbError
from foundationdb_tpu_torch.core.rng import (DeterministicRandom,
                                             set_deterministic_random)
from foundationdb_tpu_torch.rpc import endpoint as port_endpoint
from foundationdb_tpu_torch.rpc import serde as port_serde
from foundationdb_tpu_torch.rpc import sim as port_sim
from foundationdb_tpu_torch.server import cluster_controller as port_cc
from foundationdb_tpu_torch.server import coordination as port_coord
from foundationdb_tpu_torch.server import interfaces as port_if

REF = dict(sched=ref_sched, sim=ref_sim, coord=ref_coord, ifs=ref_if,
           ep=ref_endpoint, cc=ref_cc, set_random=ref_set_random)
PORT = dict(sched=port_sched, sim=port_sim, coord=port_coord, ifs=port_if,
            ep=port_endpoint, cc=port_cc, set_random=set_deterministic_random)


class Sim:
    """One package's simulation: its loop, simulator and seeded random,
    installed for the test and removed after."""

    def __init__(self, m, seed: int = 5) -> None:
        self.m = m
        m["set_random"]((RefRandom if m is REF else DeterministicRandom)(seed))
        self.loop = m["sched"].EventLoop(sim=True)
        m["sched"].set_event_loop(self.loop)
        self.sim = m["sim"].Simulator()
        m["sim"].set_simulator(self.sim)

    def coordinators(self, n: int, fs: bool = False):
        """n coordination servers, each on a process of its own."""
        out = []
        for i in range(n):
            p = self.sim.new_process(name=f"coord{i}",
                                     machineid=f"mach.coord{i}",
                                     process_class="coordinator")
            kw = {"fs": self.sim.fs_for(p)} if fs else {}
            s = self.m["coord"].CoordinationServer(f"coord{i}", **kw)
            s.run(p)
            out.append((p, s))
        return out

    def run(self, coro, timeout: float = 600.0):
        return self.loop.run_until(self.loop.spawn(coro), timeout)

    def close(self) -> None:
        for p in list(self.sim.processes.values()):
            self.sim.kill_process(p)
        self.loop.run_for(1.0)
        self.m["sim"].set_simulator(None)
        self.m["sched"].set_event_loop(None)


@pytest.fixture()
def sims():
    made = []

    def make(m, seed: int = 5) -> Sim:
        s = Sim(m, seed)
        made.append(s)
        return s
    yield make
    for s in made:
        s.close()


def gen_tuple(g):
    return (g.battle, g.uid)


def register_script(seed: int, n: int = 200) -> list:
    """Seeded register requests: (op, key, battle, uid, value)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        op = "read" if rng.random() < 0.5 else "write"
        out.append((op, b"key%d" % rng.integers(0, 3),
                    int(rng.integers(0, 6)), int(rng.integers(0, 4)),
                    b"v%d" % rng.integers(0, 1000)))
    return out


def run_registers(sim: Sim, script) -> list:
    m = sim.m
    c = m["coord"]
    _p, server = sim.coordinators(1)[0]
    RS = m["ep"].RequestStream

    async def go():
        out = []
        for op, key, battle, uid, value in script:
            gen = c.Generation(battle, uid)
            if op == "read":
                r = await RS.at(server.reg_read.endpoint).get_reply(
                    c.GenRegReadRequest(key=key, gen=gen))
                out.append((op, r.value, gen_tuple(r.vgen),
                            gen_tuple(r.rgen)))
            else:
                r = await RS.at(server.reg_write.endpoint).get_reply(
                    c.GenRegWriteRequest(key=key, value=value, gen=gen))
                out.append((op, gen_tuple(r.gen)))
        return out
    return sim.run(go())


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_generation_registers_match_reference(sims, seed):
    script = register_script(seed)
    want = run_registers(sims(REF), script)
    got = run_registers(sims(PORT), script)
    assert got == want
    assert any(x[0] == "write" and x[1] != (0, 0) for x in got)


def test_registers_survive_a_coordinator_restart(sims):
    """Registers committed to the machine's files come back in a new
    server on the same machine; every promise a read made (its bumped
    read generation) is kept."""
    sim = sims(PORT)
    c = port_coord
    p, server = sim.coordinators(1, fs=True)[0]
    RS = port_endpoint.RequestStream

    async def writes():
        for i in range(5):
            await RS.at(server.reg_write.endpoint).get_reply(
                c.GenRegWriteRequest(key=b"k%d" % i, value=b"v%d" % i,
                                     gen=c.Generation(i + 1, 7)))
        await RS.at(server.reg_read.endpoint).get_reply(
            c.GenRegReadRequest(key=b"k0", gen=c.Generation(9, 9)))
    sim.run(writes())
    before = dict(server._reg)
    sim.sim.kill_process(p)
    p2 = sim.sim.new_process(name="coord0", machineid="mach.coord0",
                             process_class="coordinator", address=p.address)
    again = c.CoordinationServer("coord0", fs=sim.sim.fs_for(p2))
    again.run(p2)
    assert again._reg == before

    async def stale_write():
        return await RS.at(again.reg_write.endpoint).get_reply(
            c.GenRegWriteRequest(key=b"k0", value=b"late",
                                 gen=c.Generation(8, 1)))
    assert gen_tuple(sim.run(stale_write()).gen) == (9, 9)


def election_script(seed: int, n: int = 40) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        r = rng.random()
        cid = int(rng.integers(1, 6))
        if r < 0.35:
            out.append(("candidacy", cid, int(rng.integers(-1, 6))))
        elif r < 0.6:
            out.append(("heartbeat", cid, 0))
        elif r < 0.8:
            out.append(("get", 0, int(rng.integers(-1, 6))))
        else:
            out.append(("pause", 0, float(rng.choice([0.2, 1.1, 2.5,
                                                      4.0]))))
    return out


def run_election(sim: Sim, script) -> list:
    m = sim.m
    c = m["coord"]
    _p, server = sim.coordinators(1)[0]
    RS = m["ep"].RequestStream
    log = []

    def answer(i, f):
        v = f.get() if not f.is_error() else ("error", f.error.name)
        if isinstance(v, c.LeaderInfo):
            v = v.change_id
        log.append((i, v, round(sim.loop.now(), 6)))

    async def go():
        for i, (op, cid, arg) in enumerate(script):
            if op == "pause":
                await m["sched"].delay(arg)
                continue
            info = c.LeaderInfo(change_id=cid, serialized_info=None)
            if op == "candidacy":
                f = RS.at(server.candidacy.endpoint).get_reply(
                    c.CandidacyRequest(key=c.LEADER_KEY, my_info=info,
                                       known_leader_change_id=arg))
            elif op == "heartbeat":
                f = RS.at(server.heartbeat.endpoint).get_reply(
                    c.LeaderHeartbeatRequest(key=c.LEADER_KEY,
                                             my_info=info))
            else:
                f = RS.at(server.leader_get.endpoint).get_reply(
                    c.LeaderGetRequest(key=c.LEADER_KEY,
                                       known_leader_change_id=arg))
            f.on_ready(lambda f, i=i: answer(i, f))
            await m["sched"].delay(0.01)
        await m["sched"].delay(10.0)
    sim.run(go())
    return sorted(log)


@pytest.mark.parametrize("seed", [21, 22, 23, 24])
def test_leader_election_matches_reference(sims, seed):
    script = election_script(seed)
    want = run_election(sims(REF), script)
    got = run_election(sims(PORT), script)
    assert got == want
    assert len(got) >= len([s for s in script if s[0] == "heartbeat"])


def cstate_race(sim: Sim) -> list:
    """Two writers race on three coordinators; a third reads."""
    m = sim.m
    servers = sim.coordinators(3)
    clients = [m["coord"].CoordinationClientInterface(s)
               for _p, s in servers]
    CS = m["coord"].CoordinatedState

    async def go():
        out = []
        a, b = CS(clients), CS(clients)
        out.append(("a_read", await a.read()))
        out.append(("b_read", await b.read()))
        for name, cs, value in (("a_write", a, b"A"), ("b_write", b, b"B")):
            try:
                await cs.write(value)
                out.append((name, "ok"))
            except Exception as e:  # noqa: BLE001 -- either package's
                out.append((name, e.name))
        out.append(("c_read", await CS(clients).read()))
        sim.sim.kill_process(servers[0][0])
        d = CS(clients)
        out.append(("d_read", await d.read()))
        await d.write(b"D")
        out.append(("e_read", await CS(clients).read()))
        sim.sim.kill_process(servers[1][0])
        try:
            await CS(clients).read()
            out.append(("f_read", "ok"))
        except Exception as e:  # noqa: BLE001
            out.append(("f_read", e.name))
        return out
    return sim.run(go())


def test_coordinated_state_conflicts_match_reference(sims):
    want = cstate_race(sims(REF))
    got = cstate_race(sims(PORT))
    assert got == want
    assert ("a_write", "coordinated_state_conflict") in got
    assert ("b_write", "ok") in got and ("c_read", b"B") in got
    assert ("e_read", b"D") in got and ("f_read", "timed_out") in got


def test_election_and_monitor_on_the_port(sims):
    """Three campaigners: the lowest change id leads and heartbeats;
    observers see it; its process killed, the next lowest leads."""
    from foundationdb_tpu_torch.core.futures import AsyncVar
    sim = sims(PORT)
    clients = [port_coord.CoordinationClientInterface(s)
               for _p, s in sim.coordinators(3)]
    procs, vars_ = [], []
    for cid in (4, 2, 9):
        p = sim.sim.new_process(name=f"cand{cid}")
        v = AsyncVar(None)
        p.spawn(port_coord.try_become_leader(clients, f"iface{cid}", v,
                                             change_id=cid))
        procs.append(p)
        vars_.append(v)
    obs = AsyncVar(None)
    watcher = sim.sim.new_process(name="observer")
    watcher.spawn(port_coord.monitor_leader(clients, obs))

    async def go():
        await port_sched.delay(5.0)
        first = (obs.get().change_id, obs.get().serialized_info,
                 [v.get().change_id for v in vars_])
        sim.sim.kill_process(procs[1])
        await port_sched.delay(15.0)
        return first, obs.get().change_id, vars_[0].get().change_id
    first, after, cand4 = sim.run(go())
    assert first == (2, "iface2", [2, 2, 2])
    assert after == 4 and cand4 == 4


def control_messages(m) -> dict:
    """The control plane's messages, built alike in a package, their
    interfaces' streams registered under the same endpoints."""
    c, i, ep, cc = m["coord"], m["ifs"], m["ep"], m["cc"]
    addr = ep.NetworkAddress("10.0.0.9", 4500)

    def reg(iface, name):
        for n, stream in enumerate(iface.streams()):
            stream.set_endpoint(ep.Endpoint(addr, f"{stream.name}:{name}{n}"))
        return iface
    ccif = reg(i.ClusterControllerInterface("cc.worker3.c3"), "cc")
    wif = reg(i.WorkerInterface("worker3"), "w")
    mif = reg(i.MasterInterface(), "m")
    gen = c.Generation(3, 77)
    leader = c.LeaderInfo(change_id=3, serialized_info=ccif)
    info = i.ServerDBInfo(epoch=4, recovery_state="accepting_commits",
                          recovery_version=1234, master=mif,
                          cluster_controller=ccif, log_replication=2,
                          storage_engine="memory",
                          resolver_ranges=[(b"", b"\xff", 0),
                                           (b"\xff", b"\xff\xff", -1)])
    return {
        "read": c.GenRegReadRequest(key=b"dbCoreState", gen=gen),
        "read_reply": c.GenRegReadReply(value=b"state", vgen=gen,
                                        rgen=c.Generation(2, 5)),
        "write": c.GenRegWriteRequest(key=b"dbCoreState", value=b"s",
                                      gen=gen),
        "write_reply": c.GenRegWriteReply(gen=gen),
        "candidacy": c.CandidacyRequest(key=b"clusterLeader",
                                        my_info=leader,
                                        known_leader_change_id=-1),
        "heartbeat": c.LeaderHeartbeatRequest(key=b"clusterLeader",
                                              my_info=leader),
        "leader_get": c.LeaderGetRequest(key=b"clusterLeader",
                                         known_leader_change_id=2),
        "leader": leader,
        "db_info_request": cc.GetServerDBInfoRequest(known_version=7),
        "register": i.RegisterWorkerRequest(
            worker=wif, process_class="stateless",
            storage_versions={1: 99}, locality=("dc0", "z1", "m1")),
        "registration": i.WorkerRegistration(
            worker=wif, process_class="storage", registered_at=2.5),
        "get_workers": i.GetWorkersRequest(),
        "open_database": i.OpenDatabaseRequest(known_epoch=3),
        "client_info": i.ClientDBInfo(epoch=4),
        "server_info": info,
        "configuration": i.DatabaseConfiguration(
            n_tlogs=2, log_replication=2, n_storage=4,
            storage_replication=2, n_resolvers=2, conflict_backend="torch",
            min_workers=5),
        "init_master": i.InitializeMasterRequest(epoch=4, cc=ccif),
        "init_tlog": i.InitializeTLogRequest(
            tlog_id="log0.ab.e4", recovery_version=1234, epoch=4),
        "init_resolver": i.InitializeResolverRequest(
            resolver_id="resolver0.e4", epoch=4, recovery_version=1234,
            proxy_ids=["proxy0.e4"]),
        "init_storage": i.InitializeStorageRequest(ss_id="ss1", tag=1,
                                                   engine="memory"),
        "init_proxy": i.InitializeCommitProxyRequest(
            proxy_id="proxy0.e4", epoch=4, master=mif, resolvers=[],
            tlogs=[], key_resolvers_ranges=[(b"", b"\xff", 0)],
            key_servers_ranges=[(b"", b"\xff\xff", [0, 1])],
            storage_interfaces={}, recovery_version=1234),
        "init_grv": i.InitializeGrvProxyRequest(
            proxy_id="grv0.e4", epoch=4, master=mif, tlogs=[]),
        "master_registration": i.MasterRegistrationRequest(epoch=4,
                                                           db_info=info),
        "worker": wif, "cc": ccif,
    }


def test_control_plane_frames_equal_the_reference():
    ref_serde.bootstrap_registry()
    port_serde.bootstrap_registry()
    ref, port = control_messages(REF), control_messages(PORT)
    assert list(ref) == list(port)
    for name in ref:
        want = ref_serde.encode_message(ref[name])
        got = port_serde.encode_message(port[name])
        assert got == want, name
        # Each decodes the other's frame and encodes it back the same.
        assert port_serde.encode_message(port_serde.decode_message(want)) \
            == want, name
        assert ref_serde.encode_message(ref_serde.decode_message(got)) \
            == got, name


@pytest.mark.parametrize("spec", ["10.0.0.1:4500,10.0.0.2:4500",
                                  " 10.0.0.1:4500 , 10.0.0.3:04501 ",
                                  "127.0.0.1:4600"])
def test_connection_specs_match_reference(spec):
    """parse_spec's handles reach each coordinator by its address and the
    well-known tokens, and normalize_spec's canonical form, as the
    reference's."""
    assert port_coord.normalize_spec(spec) == ref_coord.normalize_spec(spec)
    got = [tuple(tuple(getattr(c, f)) for f in ("reg_read", "reg_write",
                                                "candidacy", "heartbeat",
                                                "leader_get"))
           for c in port_coord.parse_spec(spec)]
    want = [tuple(tuple(getattr(c, f)) for f in ("reg_read", "reg_write",
                                                 "candidacy", "heartbeat",
                                                 "leader_get"))
            for c in ref_coord.parse_spec(spec)]
    assert got == want


def test_error_codes_equal_the_reference():
    """The port's error registry carries the controller's and the
    coordinators' codes at the reference's numbers."""
    from foundationdb_tpu.core.error import ERROR_CODES as REF_CODES
    from foundationdb_tpu_torch.core.error import ERROR_CODES, err
    for name in ("coordinated_state_conflict", "timed_out",
                 "master_recovery_failed", "broken_promise"):
        assert ERROR_CODES[name] == REF_CODES[name]
        assert isinstance(err(name), FdbError)
