"""The storage fleet in the port (foundationdb_tpu_torch/server/
data_distribution.py's recruitment, tag allocation, registry scan,
exclusion drain, perpetual wiggle and halt; storage.py's engine
migration; worker.py's engine factory and boot scan; client/
management.py's exclusion) against the JAX package, on the CPU.

  * The reference's cases of tests/test_storage_management.py (a storage
    death recruits a replacement; an exclusion drains a server),
    tests/test_storage_wiggle.py (a rotation with the data intact; no
    wiggle without headroom) and tests/test_engine_config.py (a
    configured engine reaches a replacement; the wiggle migrates every
    server's engine, and a power failure after it finds each store on
    the B-tree; the boot scan drops a stale twin), on the port's
    SimFdbCluster(device="cpu").  The two packages' simulations draw
    their randomness differently (the reference's clusters also run
    status, health, knob and ratekeeper actors the port has not), so
    these runs are held to a dict model of every acknowledged write,
    read back through the client and from every replica of its team
    (tolerance 0), not to the reference's event order.
  * _alloc_tag never issues a retired tag again across a recovery, and
    a deposed distributor halts (_check_removed): dict models.
  * The distributor's candidate ranking with excluded and wiggling tags,
    and MigrateEngineRequest's frame, against the reference's: equal,
    byte for byte.
  * chip_smoke.py's phase 29 at a small size.
"""

import os
import random
import sys

import pytest

from foundationdb_tpu.rpc import serde as ref_serde
from foundationdb_tpu.server import data_distribution as ref_dd
from foundationdb_tpu.server import interfaces as ref_if
from foundationdb_tpu_torch.client.management import (exclude_servers,
                                                      excluded_servers,
                                                      include_servers)
from foundationdb_tpu_torch.core.error import FdbError
from foundationdb_tpu_torch.core.knobs import server_knobs
from foundationdb_tpu_torch.core.scheduler import delay
from foundationdb_tpu_torch.rpc import serde as port_serde
from foundationdb_tpu_torch.server import data_distribution as port_dd
from foundationdb_tpu_torch.server import interfaces as port_if
from foundationdb_tpu_torch.server.interfaces import (GetValueRequest, ask,
                                                      same_incarnation)
from foundationdb_tpu_torch.server.system_data import (MAX_TAG_KEY,
                                                       SERVER_TAG_END,
                                                       SERVER_TAG_PREFIX)
from foundationdb_tpu_torch.testing.workloads import ConsistencyCheckWorkload

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import fleet_dd as current_dd  # noqa: E402
from chip_smoke import fleet_healed as healed  # noqa: E402
from test_torch_master_recovery import (commit_kv, make_cluster,  # noqa: E402
                                        read_key, teardown)  # noqa: F401


@pytest.fixture
def wiggle_knobs():
    k = server_knobs()
    orig = (k.PERPETUAL_STORAGE_WIGGLE, k.STORAGE_WIGGLE_INTERVAL)
    yield k
    k.PERPETUAL_STORAGE_WIGGLE, k.STORAGE_WIGGLE_INTERVAL = orig


def storage_role(c, iface):
    """The live storage server behind `iface` (a registry entry is a
    decoded copy without the role)."""
    for _p, w, _cc, _lv in c.workers:
        for ss in w.storage_roles:
            if same_incarnation(ss.interface, iface):
                return ss
    raise AssertionError(f"no live storage server for {iface.id}")


async def replicas_hold(c, db, model) -> None:
    """Every model key reads back through the client, then from every
    replica of its team at one read version, the value the model's.  A
    replica that answers wrong_shard_server (a move finished between the
    team's lookup and the read) is asked again with the teams looked up
    again, as a client locates a key again."""
    for k, v in sorted(model.items()):
        assert await read_key(db, k) == v, k
    for _ in range(20):
        info = c.current_cc().db_info
        proxy = info.commit_proxies[0].role
        version = await db.create_transaction()._ensure_read_version()
        try:
            for k, v in sorted(model.items()):
                team = proxy.tags_for_key(k)
                assert team, k
                for tag in team:
                    ss = storage_role(c, proxy.storage_interfaces[tag])
                    got = ask(ss.get_value,
                              GetValueRequest(k, version)).value
                    assert got == v, (k, tag)
            return
        except FdbError as e:
            if e.name != "wrong_shard_server":
                raise
            await delay(0.5)
    raise AssertionError("the teams kept moving")


async def full_replication_audit(c, db, replication) -> None:
    """Every shard's team has `replication` healthy members and its
    replicas agree (ConsistencyCheck and the team-size check)."""
    dd = current_dd(c)
    for begin, _end, _t in dd.map.ranges():
        team = dd.map.lookup(begin)
        if team is None:
            continue
        live = [t for t in team if t in dd.healthy]
        assert len(live) >= replication, (begin, team, sorted(dd.healthy))
    w = ConsistencyCheckWorkload(c, db, {})
    assert await w.check()


async def settle(c, pred, deadline: float, step: float = 0.5) -> bool:
    while deadline > 0:
        dd = current_dd(c)
        if dd is not None and pred(dd):
            return True
        await delay(step)
        deadline -= step
    return False


async def read_system(db, key: bytes):
    t = db.create_transaction()
    t.access_system_keys = True
    while True:
        try:
            return await t.get(key)
        except FdbError as e:
            await t.on_error(e)


async def registry_tags(db) -> list:
    while True:
        t = db.create_transaction()
        t.access_system_keys = True
        try:
            rows = await t.get_range(SERVER_TAG_PREFIX, SERVER_TAG_END)
            return sorted(int(k[len(SERVER_TAG_PREFIX):]) for k, _v in rows)
        except FdbError as e:
            await t.on_error(e)


# -- the reference's tests/test_storage_management.py -----------------------
def test_storage_death_recruits_replacement(teardown):  # noqa: F811
    """The reference's case (dict model): with a spare storage worker, a
    killed storage server is replaced under a fresh tag, every shard is
    back at two healthy replicas, the dead tag is retired from the
    registry, and every write reads back from every replica."""
    c = make_cluster(n_storage=3, storage_replication=2, n_workers=7,
                     n_storage_workers=4)
    db = c.database()
    model = {}

    async def go():
        for i in range(30):
            await commit_kv(db, b"rk/%04d" % i, b"val%04d" % i, model)
        await commit_kv(db, b"\x90spread", b"hi", model)
        dd = current_dd(c)
        tags0 = set(dd.storage)
        assert tags0 == {0, 1, 2}
        victim = c.process_of(dd.storage[0])
        c.sim.power_fail_machine(victim.locality.machineid)
        assert await settle(c, lambda d: (set(d.storage) - tags0) and
                            healed(d, 2), 60.0), \
            "no replacement recruited or teams not healed"
        dd = current_dd(c)
        assert dd.stats["recruits"] == 1
        assert set(dd.storage) == {1, 2, 3} == dd.healthy
        await full_replication_audit(c, db, 2)
        await replicas_hold(c, db, model)
        assert await registry_tags(db) == [1, 2, 3]

    c.run_until(c.loop.spawn(go()), timeout=300)


def test_exclude_drains_server(teardown):  # noqa: F811
    """The reference's case (dict model): an excluded server is drained
    empty, no team ever shrinking below two healthy members, and an
    include admits it again."""
    c = make_cluster(n_storage=3, storage_replication=2, n_workers=7,
                     n_storage_workers=4)
    db = c.database()
    model = {}
    smallest = []

    async def go():
        for i in range(30):
            await commit_kv(db, b"ex/%04d" % i, b"v%04d" % i, model)
        await exclude_servers(db, [1])
        assert 1 in await excluded_servers(db)

        def drained(dd):
            teams = [dd.map.lookup(b) for b, _e, _t in dd.map.ranges()]
            smallest.append(min(len(t) for t in teams if t))
            return 1 in dd.excluded and not dd.moves_in_flight and all(
                t is None or 1 not in t for t in teams)
        assert await settle(c, drained, 90.0), "never drained"
        assert min(smallest) >= 2
        dd = current_dd(c)
        ss = storage_role(c, dd.storage[1])
        deadline = 15.0
        while deadline > 0:
            live, _more = ss.data.range_read(b"", b"\xff", ss.version,
                                             1 << 20, 1 << 30)
            if not live:
                break
            await delay(0.25)
            deadline -= 0.25
        assert deadline > 0, f"drained server still holds {len(live)} keys"
        await replicas_hold(c, db, model)
        await full_replication_audit(c, db, 2)
        await include_servers(db, [1])
        assert await settle(c, lambda d: 1 not in d.excluded, 30.0)
        assert await excluded_servers(db) == []

    c.run_until(c.loop.spawn(go()), timeout=300)


# -- the reference's tests/test_storage_wiggle.py ---------------------------
def test_wiggle_rotates_and_data_survives(teardown, wiggle_knobs):  # noqa: F811,E501
    """The reference's case (dict model): a whole rotation, every healthy
    tag wiggled at least once and admitted again, every replica equal."""
    wiggle_knobs.PERPETUAL_STORAGE_WIGGLE = 1
    wiggle_knobs.STORAGE_WIGGLE_INTERVAL = 0.5
    c = make_cluster(n_storage=3, storage_replication=2, n_workers=6,
                     n_storage_workers=3)
    db = c.database()
    model = {}

    async def go():
        for i in range(30):
            await commit_kv(db, b"wg/%03d" % i, b"val%03d" % i, model)
        dd = current_dd(c)
        n_tags = len(dd.healthy)
        assert await settle(c, lambda d: d.stats["wiggles"] >= n_tags,
                            120.0), current_dd(c).stats
        dd = current_dd(c)
        assert not dd.wiggling
        await replicas_hold(c, db, model)
        await full_replication_audit(c, db, 2)

    c.run_until(c.loop.spawn(go()), timeout=300)


def test_wiggle_refuses_without_headroom(teardown, wiggle_knobs):  # noqa: F811,E501
    """The reference's case (dict model): a pool the size of the
    replication factor is never wiggled."""
    wiggle_knobs.PERPETUAL_STORAGE_WIGGLE = 1
    wiggle_knobs.STORAGE_WIGGLE_INTERVAL = 0.2
    c = make_cluster(n_storage=2, storage_replication=2, n_workers=5,
                     n_storage_workers=2)
    db = c.database()
    model = {}

    async def go():
        for i in range(10):
            await commit_kv(db, b"nh/%02d" % i, b"v%02d" % i, model)
        dd = current_dd(c)
        await delay(5.0)
        assert dd.stats["wiggles"] == 0 and dd.stats["moves"] == 0
        await replicas_hold(c, db, model)

    c.run_until(c.loop.spawn(go()), timeout=120)


# -- the reference's tests/test_engine_config.py ----------------------------
def test_configure_engine_reaches_replacement(teardown):  # noqa: F811
    """The reference's case (dict model): after configure
    storage_engine=btree, the replacement of a killed server opens the
    B-tree, and every write reads back."""
    from foundationdb_tpu_torch.client.management import \
        change_configuration
    c = make_cluster(n_storage=2, storage_replication=2, n_workers=6,
                     n_storage_workers=3)
    db = c.database()
    model = {}

    async def go():
        for i in range(20):
            await commit_kv(db, b"ec/%03d" % i, b"v%03d" % i, model)
        await change_configuration(db, storage_engine="btree")
        await commit_kv(db, b"ec/post", b"after-configure", model)
        c.sim.power_fail_machine("mach.worker0")
        dd = None
        deadline = 90.0
        while deadline > 0:
            await delay(0.5)
            deadline -= 0.5
            dd = current_dd(c) or dd
            if dd is not None and dd.stats["rereplications"] > 0 and \
                    dd.moves_in_flight == 0:
                break
        assert dd is not None and dd.stats["rereplications"] > 0
        engines = {t: getattr(ssi, "engine_name", "?")
                   for t, ssi in dd.storage.items() if t in dd.healthy}
        assert engines == {1: "memory", 2: "btree"}, engines
        assert type(storage_role(c, dd.storage[2]).engine).__name__ == \
            "KVStoreBTree"
        await replicas_hold(c, db, model)

    c.run_until(c.loop.spawn(go()), timeout=300)


def test_wiggle_migrates_engines(teardown, wiggle_knobs):  # noqa: F811
    """The reference's case (dict model): configure storage_engine=btree
    with the wiggle on, and every server is re-imaged onto the B-tree as
    the rotation reaches it; a power failure after that finds each store
    on the B-tree, with no memory-engine file left, and every write
    reads back."""
    from foundationdb_tpu_torch.client.management import \
        change_configuration
    wiggle_knobs.PERPETUAL_STORAGE_WIGGLE = 1
    wiggle_knobs.STORAGE_WIGGLE_INTERVAL = 0.5
    c = make_cluster(n_storage=3, storage_replication=2, n_workers=6,
                     n_storage_workers=3)
    db = c.database()
    model = {}

    def engines(dd):
        return {t: getattr(ssi, "engine_name", "")
                for t, ssi in dd.storage.items() if t in dd.healthy}

    async def go():
        for i in range(20):
            await commit_kv(db, b"em/%03d" % i, b"v%03d" % i, model)
        await change_configuration(db, storage_engine="btree")
        await commit_kv(db, b"em/post", b"after", model)
        assert await settle(c, lambda d: engines(d) and all(
            e == "btree" for e in engines(d).values()), 150.0, 1.0), \
            engines(current_dd(c))
        await delay(2.0)        # the update loop makes the tail durable
        await replicas_hold(c, db, model)

    c.run_until(c.loop.spawn(go()), timeout=400)
    c.power_fail_reboot()
    db2 = c.database()

    async def check():
        await commit_kv(db2, b"em/rebooted", b"yes", model)
        await replicas_hold(c, db2, model)
        info = c.current_cc().db_info
        for tag, ssi in info.storage_servers.items():
            ss = storage_role(c, ssi)
            assert ss.engine_name == "btree", tag
            fs = c.sim.fs_for(ss._process)
            assert not fs.exists(f"storage-{tag}.wal"), tag
            assert fs.exists(f"storage-{tag}.btree"), tag

    c.run_until(c.loop.spawn(check()), timeout=200)


def test_boot_scan_drops_stale_engine_twin(teardown):  # noqa: F811
    """The reference's case (dict model): a stale B-tree twin planted
    beside a live memory store (what a kill between a migration's commit
    and its old files' removal leaves) is deleted by the next boot scan,
    the memory store kept, every write read back."""
    from foundationdb_tpu_torch.server.kvstore import open_kv_store
    from foundationdb_tpu_torch.server.storage import _META_KEY
    c = make_cluster(n_storage=2, storage_replication=2, n_workers=5,
                     n_storage_workers=2)
    db = c.database()
    model = {}

    async def seed():
        for i in range(15):
            await commit_kv(db, b"tw/%02d" % i, b"v%02d" % i, model)
        await delay(2.0)
        dd = current_dd(c)
        tag = sorted(dd.healthy)[0]
        ss = storage_role(c, dd.storage[tag])
        fs = c.sim.fs_for(ss._process)
        twin = open_kv_store("btree", fs, f"storage-{tag}")
        twin.set(_META_KEY, ss._meta_blob(0))
        twin.commit()
        return tag, ss._process

    tag, proc = c.run_until(c.loop.spawn(seed()), timeout=120)
    c.power_fail_reboot()
    db2 = c.database()
    c.run_until(c.loop.spawn(replicas_hold(c, db2, model)), timeout=120)
    fs = c.sim.fs_for(proc)
    assert not fs.exists(f"storage-{tag}.btree")
    assert fs.exists(f"storage-{tag}.wal")
    ss = storage_role(c, c.current_cc().db_info.storage_servers[tag])
    assert ss.engine_name == "memory"


# -- the port's own cases ---------------------------------------------------
def test_alloc_tag_never_reissues_across_recovery(teardown):  # noqa: F811
    """Dict model: tag 0 dies and is replaced by tag 3; tag 3 dies with no
    spare left and is retired, so no live server holds the highest tag
    ever issued; a master kill starts a distributor that knows tags 1
    and 2 only; an exclusion then recruits on a new spare, under tag 4
    (the committed \\xff/maxServerTag's floor), not a reissued 3."""
    c = make_cluster(n_storage=3, storage_replication=2, n_workers=8,
                     n_storage_workers=4)
    db = c.database()
    model = {}

    async def go():
        for i in range(20):
            await commit_kv(db, b"at/%03d" % i, b"v%03d" % i, model)
        dd = current_dd(c)
        c.sim.power_fail_machine(c.process_of(dd.storage[0])
                                 .locality.machineid)
        assert await settle(c, lambda d: 3 in d.storage and 0 not in
                            d.storage and healed(d, 2), 60.0)
        dd = current_dd(c)
        c.sim.power_fail_machine(c.process_of(dd.storage[3])
                                 .locality.machineid)
        assert await settle(c, lambda d: 3 not in d.storage and
                            healed(d, 2), 60.0)
        assert await registry_tags(db) == [1, 2]
        old = current_dd(c)
        epoch = c.current_cc().db_info.epoch
        c.sim.kill_process(c.process_of(c.current_cc().db_info.master))
        await commit_kv(db, b"at/after", b"1", model)
        assert c.current_cc().db_info.epoch == epoch + 1
        new = current_dd(c)
        assert new is not old and sorted(new.storage) == [1, 2]
        assert old.halted and not new.halted
        c.add_worker(pclass="storage", name="spare")
        await exclude_servers(db, [1])
        assert await settle(c, lambda d: 4 in d.storage and healed(d, 2)
                            and all(1 not in (d.map.lookup(b) or ())
                                    for b, _e, _t in d.map.ranges()), 90.0)
        dd = current_dd(c)
        assert dd.stats["recruits"] == 1 and 3 not in dd.storage
        assert await read_system(db, MAX_TAG_KEY) == b"4"
        assert await registry_tags(db) == [1, 2, 4]
        await replicas_hold(c, db, model)
        await full_replication_audit(c, db, 2)

    c.run_until(c.loop.spawn(go()), timeout=400)


def test_deposed_distributor_halts(teardown):  # noqa: F811
    """Dict model: each master kill ends an epoch, and its distributor
    halts (its split sweep, registry scan, wiggle loop and failure
    monitors cancelled) once the next epoch's announcement names another
    by endpoint; the serving one never halts, and only it moves shards
    after that."""
    c = make_cluster(n_storage=2, storage_replication=2, n_workers=6,
                     n_storage_workers=2)
    db = c.database()
    model = {}

    async def go():
        dds = []
        for r in range(2):
            await commit_kv(db, b"dh/%d" % r, b"v", model)
            dds.append(current_dd(c))
            c.sim.kill_process(c.process_of(c.current_cc().db_info.master))
        await commit_kv(db, b"dh/last", b"v", model)
        await delay(1.0)
        live = current_dd(c)
        assert live not in dds and not live.halted
        for dd in dds:
            assert dd.halted
            assert all(a.is_ready() for a in dd._actors)
        moves = [dd.stats["moves"] for dd in dds]
        await delay(3.0)
        assert [dd.stats["moves"] for dd in dds] == moves
        await replicas_hold(c, db, model)

    c.run_until(c.loop.spawn(go()), timeout=300)


class _Iface:
    def __init__(self, loc):
        self.locality = loc


@pytest.mark.parametrize("seed", [31, 32])
def test_ordered_candidates_with_exclusion_match_reference(seed):
    """Tolerance 0: the ranking of replacement candidates with excluded
    and wiggling (avoided) tags equals the reference's."""
    rng = random.Random(seed)
    for _ in range(40):
        n = rng.randrange(3, 9)
        ifaces = {t: _Iface((f"dc{rng.randrange(2)}",
                             rng.choice(["", "z1", "z2", "z3"]),
                             f"m{rng.randrange(5)}")) for t in range(n)}
        replication = rng.randrange(1, 4)
        ranges = [(b"", b"\xff\xff", list(range(replication)))]
        ref = ref_dd.DataDistributor("dd", None, ifaces, ranges, replication)
        port = port_dd.DataDistributor("dd", None, ifaces, ranges,
                                       replication)
        excluded = set(rng.sample(range(n), rng.randrange(0, 3)))
        avoid = frozenset(rng.sample(range(n), rng.randrange(0, 2)))
        for d in (ref, port):
            d.excluded = set(excluded)
        team = rng.sample(range(n), min(n, replication))
        kept = [t for t in team if t not in excluded]
        assert port._ordered_candidates(kept, team, avoid=avoid) == \
            ref._ordered_candidates(kept, team, avoid=avoid)


def test_migrate_engine_frames_equal_the_reference():
    """Tolerance 0: MigrateEngineRequest's frame is the reference's byte
    for byte, and each package decodes the other's; the storage
    interface's migrate_engine stream is shipped at its endpoint."""
    ref_serde.bootstrap_registry()
    port_serde.bootstrap_registry()
    for engine in ("memory", "btree", ""):
        r = ref_serde.encode_message(ref_if.MigrateEngineRequest(engine))
        p = port_serde.encode_message(port_if.MigrateEngineRequest(engine))
        assert p == r
        assert port_serde.decode_message(r).engine == engine
        assert ref_serde.decode_message(p).engine == engine
    ssi = port_if.StorageServerInterface("ss4", 4)
    assert ssi.migrate_engine in ssi.streams()
    assert [s.name for s in ssi.streams()] == [
        s.name for s in ref_if.StorageServerInterface("ss4", 4).streams()
        if s.name in {x.name for x in ssi.streams()}]


def test_chip_smoke_fleet_on_cpu():
    """chip_smoke.py's phase 29 at a small size on the CPU, on phase 28's
    cluster after its last kill: configure to 3 resolvers (a new epoch
    through the five states with 3 Resolver roles), a storage process
    killed (a replacement under a new tag, full replication), an
    exclusion drained and included again, and a wiggle step migrating a
    server to the B-tree; every acknowledged write read back from every
    replica after each step, the audit clean, the superseded
    distributors halted, and every epoch's batches equal to a CPU
    plane's replay."""
    import chip_smoke
    from test_torch_master_recovery import SET_KWARGS
    with chip_smoke.recovery_cluster(device="cpu", keyspace=4_000,
                                     rw_actors=64, **SET_KWARGS) as run:
        rec = run.figures
        fleet = chip_smoke.fleet_run(run)
    assert rec["epochs"] == [1, 2, 3, 4, 5]
    steps = fleet["steps"]
    assert [s["step"] for s in steps] == list(chip_smoke.FLEET_STEPS)
    configure, death, exclude, wiggle = steps
    assert configure["epoch"] == 6 and configure["resolvers"] == 3
    assert configure["states"] == list(chip_smoke.RECOVERY_STATES)
    assert death["new_tag"] == 4 and death["recruits"] == 1
    assert exclude["excluded"] not in exclude["final_tags_holding"]
    assert wiggle["engine"] == "btree" and wiggle["engine_migrations"] >= 1
    for s in steps:
        assert s["after"]["committed"] == 64
        assert s["readback_rows"] > 0
    assert fleet["halted_distributors"] >= 1
    assert fleet["replayed_batches"] > 0
