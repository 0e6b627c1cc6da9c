"""StaticCluster with every role in a simulated process of its own on the
port's SimNetwork (foundationdb_tpu_torch/server/cluster.py start(),
rpc/sim.py, rpc/network.py) on the CPU.

The seeded workloads through database(): ReadWrite and Cycle, every
acknowledged write read back on both replicas, the ring intact, the
Cycle batches' codes equal an oracle plane's (chip_smoke.client_run at
a small size); phase 25's faults at a small size (chip_smoke.sim_run: a
storage process killed, a resolver's process clogged, every
acknowledged write read back from the surviving replicas, reads failed
over, commits held by the clog answered after it); and, against the
JAX package's SimCluster built the same way (tests/test_torch_client.py's
sides), the client-visible outcome of the same transactions with a
storage process killed or a resolver's process clogged: reads fail over
and every value, error and commit outcome is equal."""

import random

import pytest
import torch

from foundationdb_tpu.core import scheduler as ref_scheduler
from foundationdb_tpu.core.rng import DeterministicRandom
from foundationdb_tpu.core.rng import set_deterministic_random
from foundationdb_tpu.rpc.sim import set_simulator
from foundationdb_tpu.server.cluster import SimCluster
from foundationdb_tpu_torch.core import rng as port_rng
from foundationdb_tpu_torch.core import scheduler as port_scheduler
from foundationdb_tpu_torch.core.error import FdbError as PortError
from foundationdb_tpu_torch.server import StaticCluster

KEYS = sorted(bytes([i * 2]) + b"/%03d" % i for i in range(120))
PROXIES = ["proxy0", "proxy1"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    set_simulator(None)
    ref_scheduler.set_event_loop(None)
    port_scheduler.set_event_loop(None)


def ref_cluster():
    set_deterministic_random(DeterministicRandom(7))
    c = SimCluster(n_resolvers=2, n_storage=4, n_tlogs=2,
                   n_commit_proxies=2, replication=2,
                   conflict_backend="cpu")
    for ss in c.storage:
        for b, e, team in c.key_servers.ranges():
            if ss.tag in team:
                for k in KEYS:
                    if b <= k < e:
                        ss.data.set(k, b"base" + k, 0)
    c.kill = lambda name: c.sim.kill_process(c.processes[name])
    c.clog = lambda name, s: c.sim.clog_process(c.processes[name], s)
    return c, c.loop


def port_cluster(datadir):
    port_rng.set_deterministic_random(port_rng.DeterministicRandom(7))
    loop = port_scheduler.EventLoop()
    c = StaticCluster(2, PROXIES, n_storage=4, n_tlogs=2, replication=2,
                      datadir=str(datadir), device="cpu", clock=loop.now,
                      capacity=1 << 10, delta_capacity=1 << 8)
    c.load(KEYS, [b"base" + k for k in KEYS])
    c.start(loop)
    c.kill = c.kill_process
    c.clog = c.clog_process
    return c, loop


async def reads_and_writes(db, delay, now, fault, seed: int) -> list:
    """Point reads of every key, a range read across every shard, writes
    committed and read back, after `fault()`; each step's value or error
    name, and whether a commit sent under the fault finished after it."""
    r = random.Random(seed)
    out = []
    fault()
    t = db.create_transaction()
    for k in KEYS[::7]:
        out.append(await t.get(k))
    out.append(len(await t.get_range(b"", b"\xff", limit=1000)))
    writes = {k: b"new%d" % r.randrange(1000) for k in r.sample(KEYS, 10)}
    for k, v in writes.items():
        t.set(k, v)
    t0 = now()
    try:
        await t.commit()
        out.append(("committed", now() - t0))
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        out.append(("error", e.name))
    t = db.create_transaction()
    for k in writes:
        out.append(await t.get(k))
    out.append(sorted(await t.get_range(KEYS[0], KEYS[-1] + b"\x00",
                                        limit=1000)))
    return out


def outcomes(tmp_path, fault: str, seed: int):
    runs = []
    for make in (ref_cluster, lambda: port_cluster(tmp_path / "port")):
        c, loop = make()
        db = c.database()
        if fault == "kill":
            act = (lambda c=c: c.kill("ss0"))
        else:
            act = (lambda c=c: c.clog("resolver0", 0.5))

        async def delay(s, loop=loop):
            await loop.delay(s)
        runs.append(c.run_until(loop.spawn(reads_and_writes(
            db, delay, loop.now, act, seed)), timeout=60.0))
        if isinstance(c, StaticCluster):
            c.close()
    return runs


@pytest.mark.parametrize("seed", [1, 2])
def test_storage_kill_fails_over_as_the_reference(tmp_path, seed):
    want, got = outcomes(tmp_path, "kill", seed)
    # Commit latencies differ (the reference's master reads its own
    # clock); the outcomes and every value do not.
    strip = [x if not (isinstance(x, tuple) and x[0] == "committed")
             else "committed" for x in want]
    assert [x if not (isinstance(x, tuple) and x[0] == "committed")
            else "committed" for x in got] == strip
    assert "committed" in strip and b"base" + KEYS[0] in want


@pytest.mark.parametrize("seed", [3])
def test_resolver_clog_delays_commits_as_the_reference(tmp_path, seed):
    want, got = outcomes(tmp_path, "clog", seed)
    commit = [x for x in got if isinstance(x, tuple)][0]
    ref_commit = [x for x in want if isinstance(x, tuple)][0]
    assert commit[0] == ref_commit[0] == "committed"
    # Both wait out the clog: the commit's resolution reaches the clogged
    # resolver only when it ends.
    assert commit[1] >= 0.45 and ref_commit[1] >= 0.45
    assert [x for x in got if not isinstance(x, tuple)] == \
        [x for x in want if not isinstance(x, tuple)]


def test_killed_storage_process_answers_broken_promise(tmp_path):
    """A request to a killed storage process answers broken_promise, the
    roles' processes are the reference's set, and a clog by role name
    reaches the network."""
    c, loop = port_cluster(tmp_path)
    ref, _ = ref_cluster()
    # One process a role, as the reference's (its TLogs are "log<i>",
    # the port's carry their epoch; its GRV proxy is "grv0").
    names = set(c.processes)
    assert len(names) == len(ref.processes) == 12
    assert {"master", "log0.e1", "log1.e1", "resolver0", "resolver1",
            "ss0", "ss1", "ss2", "ss3", "proxy0", "proxy1", "grv"} == names
    ss = c.storage[0]
    c.kill_process(ss.id)
    from foundationdb_tpu_torch.server.interfaces import GetValueRequest
    f = ss.interface.get_value.get_reply(GetValueRequest(KEYS[0], 0))
    loop.run_until(loop.delay(0.01))
    assert f.is_error() and f.error.name == "broken_promise"
    assert not c.processes[ss.id].alive
    c.clog_process("resolver1", 1.0)
    assert c.sim.network._clog_ip_until[
        c.processes["resolver1"].address.ip] == pytest.approx(
            loop.now() + 1.0)
    c.close()


@pytest.mark.parametrize("which", ["Cycle", "ReadWrite"])
def test_workloads_with_a_storage_process_killed(tmp_path, which):
    """The reference's workloads through both clusters with storage
    server 1 killed after setup: both check clean, both make progress."""
    from foundationdb_tpu.testing import workloads as ref_w
    from foundationdb_tpu_torch.testing import workloads as port_w
    config = ({"nodeCount": 50, "actorCount": 8, "testDuration": 0.05,
               "seed": 5} if which == "Cycle" else
              {"nodeCount": 200, "actorCount": 8, "testDuration": 0.05,
               "seed": 6})
    out = []
    for (c, loop), mod in ((ref_cluster(), ref_w),
                           (port_cluster(tmp_path / "p"), port_w)):
        db = c.database()
        w = getattr(mod, which + "Workload")(c, db, dict(config))
        c.run_until(loop.spawn(w.setup()), timeout=60.0)
        c.kill("ss1")
        c.run_until(loop.spawn(w.start()), timeout=60.0)
        out.append((c.run_until(loop.spawn(w.check()), timeout=60.0),
                    dict(w.metrics)))
        if isinstance(c, StaticCluster):
            c.close()
    assert out[0][0] is True and out[1][0] is True
    key = "swaps" if which == "Cycle" else "operations"
    assert out[0][1][key] > 0 and out[1][1][key] > 0


def test_chip_smoke_client_over_the_network_on_cpu(monkeypatch):
    """chip_smoke.py phase 24 at a small size: every check of the phase
    (read-back on both replicas, the ring, the oracle replay) with the
    roles on the SimNetwork, where the two proxies' batches finish out of
    version order (the replay takes them in chain order)."""
    import chip_smoke
    records = []
    record_batches = chip_smoke.record_batches

    def keep(c):
        records.append(record_batches(c))
        return records[-1]
    monkeypatch.setattr(chip_smoke, "record_batches", keep)
    fig = chip_smoke.client_run(
        device="cpu", keyspace=5_000, rw_actors=128, rw_txns=4,
        cycle_nodes=300, cycle_actors=64, cycle_swaps=3,
        capacity=1 << 12, delta_capacity=1 << 10)
    assert fig["rw"]["committed"] == 128 * 4
    assert fig["cycle"]["replayed_batches"] > 0
    versions = [r[2] for r in records[0]]
    assert versions != sorted(versions)


@pytest.mark.parametrize("seed", [2525, 11])
def test_chip_smoke_faults_on_cpu(monkeypatch, seed):
    """chip_smoke.py phase 25 at a small size: its checks (read-back from
    the surviving replicas, failovers, one reply a commit, commits held
    by the clog) hold."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "SIM_SEED", seed)
    fig = chip_smoke.sim_run(device="cpu", keyspace=2_000, rw_actors=48,
                             rw_txns=5, rw_warmup=1, capacity=1 << 12,
                             delta_capacity=1 << 10)
    assert fig["committed"] == 48 * 5
    assert fig["read_failovers"] > 0 and fig["commits_waiting_on_clog"] > 0
    assert fig["broken_promise_replies"] >= fig["read_failovers"]
