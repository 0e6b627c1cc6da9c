"""The port's control plane and recovery (foundationdb_tpu_torch/server/
cluster.py SimFdbCluster, cluster_controller.py, master.py master_server,
worker.py Worker, coordination.py) against the JAX package's tests.

The cases of the reference's tests/test_recovery.py (a cold boot, the
master's, a resolver's and a TLog's worker killed, three recoveries in a
row) and tests/test_control_plane.py::test_better_master_reelection run on
the port's SimFdbCluster with device="cpu", plus a killed cluster
controller, restarted coordinators and workers, and a whole-cluster
power failure.  Each checks what the
reference's checks, and more:

  * every master past the first epoch went through the five recovery
    states in order (a cold boot's skips locking_cstate, as the
    reference's does), and the epochs grow by one a recovery;
  * the core state on the coordinators (read through CoordinatedState)
    names the serving epoch, its recovery version, TLogs, storage tags,
    resolver count and shard map, and packs and unpacks to itself;
  * every committed key reads back, through the client and from every
    replica of its team, equal to a dict model;
  * the server registry (\xff/serverTag/) names each storage tag's
    serving incarnation: the workers' registry commits landed, for the
    servers they recruited and those their boot scans brought back.

Both packages' simulations draw their randomness differently (the
reference's clusters also run status, health, knob and ratekeeper actors
the port does not have), so the runs are held to the dict model, not to
the reference's event order: tolerance 0 on every value.  The last test
runs chip_smoke.py's phase 28 at a small size.
"""

import pytest

from foundationdb_tpu_torch.core.error import FdbError
from foundationdb_tpu_torch.core.rng import (DeterministicRandom,
                                             set_deterministic_random)
from foundationdb_tpu_torch.core.scheduler import delay
from foundationdb_tpu_torch.server.cluster import SimFdbCluster
from foundationdb_tpu_torch.server.coordination import CoordinatedState
from foundationdb_tpu_torch.server.interfaces import (DatabaseConfiguration,
                                                      GetValueRequest, ask)
from foundationdb_tpu_torch.server.master import (RECOVERY_STATES,
                                                  DBCoreState, Master)

SET_KWARGS = dict(capacity=1 << 10, delta_capacity=1 << 8)


_CLUSTERS = []


def stop(c) -> None:
    """Kill every process, so each actor ends and each held request
    breaks now, on the test's loop, not when the interpreter exits."""
    for p in list(c.sim.processes.values()):
        c.sim.kill_process(p)
    c.loop.run_for(1.0)


@pytest.fixture()
def teardown():
    set_deterministic_random(DeterministicRandom(7))
    yield
    from foundationdb_tpu_torch.core.scheduler import set_event_loop
    from foundationdb_tpu_torch.rpc.sim import set_simulator
    while _CLUSTERS:
        stop(_CLUSTERS.pop())
    set_simulator(None)
    set_event_loop(None)


def make_cluster(**cfg):
    n_workers = cfg.pop("n_workers", 5)
    n_storage_workers = cfg.pop("n_storage_workers", 2)
    c = SimFdbCluster(config=DatabaseConfiguration(**cfg),
                      n_workers=n_workers,
                      n_storage_workers=n_storage_workers, device="cpu",
                      **SET_KWARGS)
    _CLUSTERS.append(c)
    return c


async def commit_kv(db, key, value, model=None):
    t = db.create_transaction()
    while True:
        try:
            t.set(key, value)
            await t.commit()
            break
        except FdbError as e:
            await t.on_error(e)
    if model is not None:
        model[key] = value


async def read_key(db, key):
    t = db.create_transaction()
    while True:
        try:
            return await t.get(key)
        except FdbError as e:
            await t.on_error(e)


def masters(c):
    """Every master the workers ran, by epoch."""
    return sorted((r for _p, w, _cc, _lv in c.workers for r in w.roles
                   if isinstance(r, Master)), key=lambda m: m.epoch)


def check_states(c) -> None:
    """Each master that reached accepting_commits went through the five
    states in order (a cold boot through four); the serving epoch's
    master is one of them."""
    served = [m for m in masters(c)
              if getattr(m, "recovery_state", "") == "accepting_commits"]
    assert served
    for m in served:
        states = [s for s, _t, _w in m.recovery_log]
        want = [s for s in RECOVERY_STATES
                if m.epoch > 1 or s != "locking_cstate"]
        assert states == want, (m.epoch, states)
    cc = c.current_cc()
    assert cc.db_info.master.role in served
    assert cc.db_info.epoch == max(m.epoch for m in served)


async def check_core_state(c) -> None:
    """The coordinators' core state is the serving epoch's."""
    info = c.current_cc().db_info
    cs = DBCoreState.coerce(await CoordinatedState(
        c.coordinator_clients).read())
    assert cs.epoch == info.epoch
    assert cs.recovery_version == info.recovery_version == cs.map_version
    assert [t.id for t in cs.tlogs] == [t.id for t in info.tlogs]
    assert sorted(cs.storage_servers) == sorted(info.storage_servers)
    assert cs.n_resolvers == len(info.resolvers)
    assert all(r[2] >= 0 for r in cs.resolver_ranges)
    back = DBCoreState.unpack(cs.pack())
    for f in ("epoch", "recovery_version", "log_replication", "n_resolvers",
              "map_version", "key_servers_ranges", "resolver_ranges"):
        assert getattr(back, f) == getattr(cs, f), f
    assert back.tlog_ids == [t.id for t in info.tlogs]
    assert back.storage_ids == {t: s.id for t, s in
                                cs.storage_servers.items()}


async def check_replicas(c, db, model) -> None:
    """Every model key reads back through the client and from every
    replica of its team at one read version."""
    info = c.current_cc().db_info
    proxy = info.commit_proxies[0].role
    version = await db.create_transaction()._ensure_read_version()
    for k, v in sorted(model.items()):
        assert await read_key(db, k) == v, k
        team = proxy.tags_for_key(k)
        assert team
        for tag in team:
            ss = info.storage_servers[tag].role
            got = ask(ss.get_value, GetValueRequest(k, version)).value
            assert got == v, (k, tag)


async def check_registry(c, db) -> None:
    """The registry's entries, read through a transaction, are the
    serving epoch's storage servers."""
    from foundationdb_tpu_torch.server.interfaces import same_incarnation
    from foundationdb_tpu_torch.server.system_data import (
        SERVER_TAG_END, SERVER_TAG_PREFIX, parse_server_tag_mutation)
    from foundationdb_tpu_torch.txn.types import Mutation, MutationType
    info = c.current_cc().db_info
    for _ in range(100):
        t = db.create_transaction()
        t.access_system_keys = True
        try:
            rows = await t.get_range(SERVER_TAG_PREFIX, SERVER_TAG_END)
        except FdbError as e:
            await t.on_error(e)
            continue
        got = {}
        for k, v in rows:
            [(tag, iface)] = parse_server_tag_mutation(
                Mutation(MutationType.SetValue, k, v))
            got[tag] = iface
        if sorted(got) == sorted(info.storage_servers) and all(
                same_incarnation(got[t], i)
                for t, i in info.storage_servers.items()):
            return
        await delay(0.5)
    raise AssertionError(f"registry {sorted(got)} is not the epoch's "
                         f"{sorted(info.storage_servers)}")


async def full_check(c, db, model) -> None:
    check_states(c)
    await check_core_state(c)
    await check_replicas(c, db, model)
    await check_registry(c, db)


def test_cold_boot_recruits_and_serves(teardown):
    """The reference's case, and the checks above, against a dict model:
    epoch 1 accepts commits after a cold boot."""
    c = make_cluster()
    db = c.database()
    model = {}

    async def go():
        await commit_kv(db, b"boot", b"ok", model)
        assert await read_key(db, b"boot") == b"ok"
        cc = c.current_cc()
        assert cc is not None
        assert cc.db_info.epoch == 1
        assert cc.db_info.recovery_state == "accepting_commits"
        rs = cc.db_info.resolvers[0].role.conflict_set
        assert type(rs).__name__ == "SupervisedConflictSet"
        assert rs.device.device.type == "cpu"
        await full_check(c, db, model)

    c.run_until(c.loop.spawn(go()), timeout=60)


def test_master_worker_kill_triggers_recovery(teardown):
    """The reference's case against a dict model: a killed master's
    epoch is followed by the next, through the five states."""
    c = make_cluster()
    db = c.database()
    model = {}

    async def go():
        await commit_kv(db, b"before", b"1", model)
        cc = c.current_cc()
        epoch1 = cc.db_info.epoch
        master_proc = c.process_of(cc.db_info.master)
        assert master_proc is not None and master_proc.alive
        c.sim.kill_process(master_proc)
        await commit_kv(db, b"after", b"2", model)
        assert await read_key(db, b"before") == b"1"
        assert await read_key(db, b"after") == b"2"
        cc2 = c.current_cc()
        assert cc2.db_info.epoch == epoch1 + 1
        await full_check(c, db, model)

    c.run_until(c.loop.spawn(go()), timeout=300)


def test_resolver_worker_kill_triggers_recovery(teardown):
    """The reference's case against a dict model, the resolver on
    another worker than the master."""
    c = make_cluster(n_workers=6, n_storage_workers=2)
    db = c.database()
    model = {}

    async def go():
        await commit_kv(db, b"k0", b"v0", model)
        cc = c.current_cc()
        resolver_proc = c.process_of(cc.db_info.resolvers[0])
        master_proc = c.process_of(cc.db_info.master)
        assert resolver_proc is not master_proc
        epoch = cc.db_info.epoch
        c.sim.kill_process(resolver_proc)
        await commit_kv(db, b"k1", b"v1", model)
        assert await read_key(db, b"k0") == b"v0"
        assert await read_key(db, b"k1") == b"v1"
        assert c.current_cc().db_info.epoch == epoch + 1
        await full_check(c, db, model)

    c.run_until(c.loop.spawn(go()), timeout=300)


def test_tlog_kill_with_replication_preserves_data(teardown):
    """The reference's case against a dict model: two TLogs replicating
    every tag, one killed; its data comes back from the survivor."""
    c = make_cluster(n_workers=6, n_storage_workers=2,
                     n_tlogs=2, log_replication=2)
    db = c.database()
    model = {}

    async def go():
        for i in range(5):
            await commit_kv(db, b"key%d" % i, b"val%d" % i, model)
        cc = c.current_cc()
        tlog_procs = [c.process_of(t) for t in cc.db_info.tlogs]
        master_proc = c.process_of(cc.db_info.master)
        victim = next(p for p in tlog_procs if p is not master_proc)
        epoch = cc.db_info.epoch
        c.sim.kill_process(victim)
        await commit_kv(db, b"post", b"recovery", model)
        for i in range(5):
            assert await read_key(db, b"key%d" % i) == b"val%d" % i
        assert await read_key(db, b"post") == b"recovery"
        assert c.current_cc().db_info.epoch == epoch + 1
        await full_check(c, db, model)

    c.run_until(c.loop.spawn(go()), timeout=300)


def test_repeated_recoveries(teardown):
    """The reference's case against a dict model: the master killed three
    times; epochs 2, 3 and 4 each recover through the five states."""
    c = make_cluster(n_workers=7, n_storage_workers=2)
    db = c.database()
    model = {}

    async def go():
        for round_num in range(3):
            await commit_kv(db, b"round%d" % round_num, b"x", model)
            cc = c.current_cc()
            if cc is None:
                continue
            mp = c.process_of(cc.db_info.master)
            if mp is not None and mp.alive:
                c.sim.kill_process(mp)
        await commit_kv(db, b"final", b"done", model)
        for round_num in range(3):
            assert await read_key(db, b"round%d" % round_num) == b"x"
        assert c.current_cc().db_info.epoch == 4
        assert [m.epoch for m in masters(c)] == [1, 2, 3, 4]
        await full_check(c, db, model)

    c.run_until(c.loop.spawn(go()), timeout=600)


def test_better_master_reelection(teardown):
    """The reference's test_control_plane.py case against a dict model: a
    master-class worker joining makes the controller recruit the next
    master there, after which the epoch holds still."""
    c = make_cluster()
    db = c.database()
    model = {}

    async def go():
        await commit_kv(db, b"bme", b"v1", model)
        cc = c.current_cc()
        epoch0 = cc.db_info.epoch
        assert c.process_of(cc.db_info.master).process_class == "stateless"
        c.add_worker(pclass="master", name="workerM")
        deadline = 40.0
        while deadline > 0:
            cc = c.current_cc()
            if cc is not None and cc.db_info.epoch > epoch0 and \
                    cc.db_info.recovery_state == "accepting_commits":
                proc = c.process_of(cc.db_info.master)
                if proc is not None and proc.process_class == "master":
                    break
            await delay(0.5)
            deadline -= 0.5
        assert deadline > 0, "master never re-recruited onto better worker"
        epoch1 = c.current_cc().db_info.epoch
        await delay(5.0)
        assert c.current_cc().db_info.epoch == epoch1
        await commit_kv(db, b"bme2", b"v2", model)
        assert await read_key(db, b"bme") == b"v1"
        assert await read_key(db, b"bme2") == b"v2"
        await full_check(c, db, model)

    c.run_until(c.loop.spawn(go()), timeout=120)


def test_cluster_controller_kill_elects_another(teardown):
    """The controller's process killed (it hosts no other role of the
    epoch here or does, as placement falls): another stateless worker is
    elected, recruits the next epoch's master, and every write reads back
    (dict model)."""
    c = make_cluster(n_workers=7)
    db = c.database()
    model = {}

    async def go():
        await commit_kv(db, b"a", b"1", model)
        cc = c.current_cc()
        epoch = cc.db_info.epoch
        proc = next(p for p, _w, x, _lv in c.workers if x is cc)
        c.sim.kill_process(proc)
        await commit_kv(db, b"b", b"2", model)
        cc2 = c.current_cc()
        assert cc2 is not None and cc2 is not cc
        assert cc2.db_info.epoch == epoch + 1
        await full_check(c, db, model)

    c.run_until(c.loop.spawn(go()), timeout=300)


def test_coordinator_and_worker_restarts(teardown):
    """Coordinator 0 rebooted in place and coordinator 1 replaced by a
    new process at its address (its registers come back from its files),
    then the master's worker rebooted (its stack re-run on the same
    process, so the controller recruits the next master): the cluster
    keeps committing, the core state is read and written through the
    restarted coordinators, and every write reads back (dict model)."""
    c = make_cluster(n_workers=6)
    db = c.database()
    model = {}

    async def go():
        await commit_kv(db, b"a", b"1", model)
        c.restart_coordinator(0)
        p1 = c.restart_coordinator(1, hard=True)
        assert p1.alive and c.coordinators[1][0] is p1
        await commit_kv(db, b"b", b"2", model)
        cc = c.current_cc()
        epoch = cc.db_info.epoch
        mp = c.process_of(cc.db_info.master)
        idx = next(i for i, w in enumerate(c.workers) if w[0] is mp)
        assert c.restart_worker(idx) is mp
        await commit_kv(db, b"c", b"3", model)
        assert c.current_cc().db_info.epoch > epoch
        assert c.workers[idx][0] is mp and mp.epoch == 1
        await full_check(c, db, model)

    c.run_until(c.loop.spawn(go()), timeout=300)


def test_power_failure_recovers_from_packed_core_state(teardown):
    """Every process killed and every un-synced write dropped, then a
    fresh boot: the coordinators hand back the packed DBCoreState (ids
    only), the workers' boot scans bring back the TLogs and storage
    engines they synced, and reading_cstate resolves the ids through the
    worker registry.  Every acknowledged write reads back (dict model)."""
    c = make_cluster(n_tlogs=2, log_replication=2)
    db = c.database()
    model = {}

    async def load():
        for i in range(6):
            await commit_kv(db, b"key%d" % i, b"val%d" % i, model)
        await delay(2.0)    # the storage engines' update loop runs

    c.run_until(c.loop.spawn(load()), timeout=120)
    epoch = c.current_cc().db_info.epoch
    c.power_fail_reboot()
    db = c.database()

    async def go():
        await commit_kv(db, b"post", b"1", model)
        for i in range(6):
            assert await read_key(db, b"key%d" % i) == b"val%d" % i
        assert c.current_cc().db_info.epoch == epoch + 1
        await full_check(c, db, model)

    c.run_until(c.loop.spawn(go()), timeout=300)


def test_chip_smoke_recovery_on_cpu():
    """chip_smoke.py's phase 28 at a small size on the CPU: the master's,
    a resolver's, a TLog's and the controller's processes killed in turn
    between rounds of ReadWrite through ClusterConnection; each kill a
    new epoch through the five states at a higher recovery version, every
    acknowledged write read back from every replica, the audit clean,
    every epoch's batches equal to a CPU plane's replay, and the native
    set's codes equal to a TorchConflictSet's (here on the CPU)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke
    with chip_smoke.recovery_cluster(device="cpu", keyspace=4_000,
                                     rw_actors=64, **SET_KWARGS) as run:
        fig = run.figures
    native = chip_smoke.native_against_card("cpu", 2, 2_000, **SET_KWARGS)
    kills = fig["kills"]
    assert [k["victim"] for k in kills] == list(chip_smoke.RECOVERY_KILLS)
    assert [k["new_epoch"] for k in kills] == [2, 3, 4, 5]
    assert fig["epochs"] == [1, 2, 3, 4, 5]
    versions = [k["recovery_version"] for k in kills]
    assert versions == sorted(versions) and versions[0] > 0
    for k in kills:
        assert k["states"] == list(RECOVERY_STATES)
        assert k["after"]["committed"] == 64 == k["before"]["committed"]
    assert fig["readback_rows"] == 2 * 4_000
    assert fig["consistency"]["shards_audited"] >= 4
    assert fig["replayed_batches"] > 0
    assert native["ranges"] > 0
