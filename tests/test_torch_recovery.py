"""The port's durability across a restart held against the JAX package's.

The reference's are foundationdb_tpu/server/storage.py (the engine half:
_apply_direct's queue, _update_storage_loop, _meta_blob, from_engine,
set_log_system and its re-image), server/master.py (DBCoreState and the
epoch-end step of master_server, :886-1000, driven here through the
reference's own TLog._lock, LogSystemClient.team_for_tag, _peek and
apply_metadata_mutation) and the static cluster of server/cluster.py
(SimCluster, its resolvers on its oracle, built at a recovery version),
run in its simulated event loop; the port's are foundationdb_tpu_torch/
server/{storage,master,worker,cluster}.py over real files.  Tolerance 0:

  (a) the storage server behind each engine: the same applied mutations
      (atomics included) give the same engine files, contents and meta
      blob after update_storage; from_engine over them the same data and
      version; set_log_system into a newer epoch the same rollback and
      re-imaged engine;
  (b) DBCoreState.pack the same bytes, and unpack them back;
  (c) the epoch end: TLogs fed the same commits (shard splits on TXS_TAG
      among them) and pops give the same lock replies, recovery version,
      tag holders, popped versions and shard map, with one TLog a version
      ahead of its peer and with one TLog gone;
  (d) the slice whole, with the memory engine and with the B-tree: the
      port's StaticCluster (device="cpu", 2 TLogs, replication 2, 4
      storage servers, 2 resolvers, 2 proxies) commits the batches A of
      tests/test_torch_commit_path.py, is killed and reopened by
      StaticCluster.recover: every acknowledged write reads back on both
      replicas equal to SimCluster's rows, a read below the recovery
      version is too old, and the batches B through the port and through
      a SimCluster(recovery_version=...) loaded with those rows give the
      same replies and rows; a second restart loses nothing.  Cases: a
      storage server that pulled but was not durable at the kill; a TLog
      one version ahead of its peer (its push made, the other's write
      failed), which sets the recovery version at the lower one and rolls
      back the replica that ran ahead; a tag's backlog spilled across the
      restart and carried in pages of a lowered peek budget;
  (e) chip_smoke.py's restart phase at a tiny size on the CPU.
"""

import gc
import os
import random
import sys

import pytest
import torch

from foundationdb_tpu.core.futures import Promise
from foundationdb_tpu.core.knobs import server_knobs as ref_knobs
from foundationdb_tpu.rpc.endpoint import RequestStream
from foundationdb_tpu.server import disk_queue as ref_dq
from foundationdb_tpu.server import interfaces as ri
from foundationdb_tpu.server import kvstore as ref_kv
from foundationdb_tpu.server import master as ref_master
from foundationdb_tpu.server import storage as ref_storage
from foundationdb_tpu.server import tlog as ref_tlog
from foundationdb_tpu.server.cluster import SimCluster
from foundationdb_tpu.server.commit_proxy import \
    LogSystemClient as RefLogSystem
from foundationdb_tpu.server.shardmap import RangeMap as RefRangeMap
from foundationdb_tpu.server.sim_fs import SimFileSystem
from foundationdb_tpu.server.system_data import apply_metadata_mutation
from foundationdb_tpu.txn import types as rt
from foundationdb_tpu_torch.core.error import FdbError
from foundationdb_tpu_torch.core.knobs import server_knobs
from foundationdb_tpu_torch.server import interfaces as pi
from foundationdb_tpu_torch.server import master as port_master
from foundationdb_tpu_torch.server import system_data as sd
from foundationdb_tpu_torch.server import tlog as port_tlog
from foundationdb_tpu_torch.server.cluster import StaticCluster
from foundationdb_tpu_torch.server.disk_queue import DiskQueue
from foundationdb_tpu_torch.server.interfaces import (
    CommitTransactionRequest, Reply)
from foundationdb_tpu_torch.server.kvstore import open_kv_store
from foundationdb_tpu_torch.server.real_fs import RealFile, RealFileSystem
from foundationdb_tpu_torch.server.storage import _META_KEY, StorageServer
from foundationdb_tpu_torch.txn import types as pt
from test_torch_commit_path import (KEYS, normalise, outcome,  # noqa: F401
                                    sim, slice_batches, to)
from test_torch_kvstore import real_bytes, sim_bytes
from test_torch_spill import sim_process
from test_torch_tlog import loop, muts, port_file, ref_commit, run  # noqa


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def knobs():
    """Sets TLog knobs in both packages, restored after."""
    regs = [ref_knobs(), server_knobs()]
    names = ("TLOG_SPILL_THRESHOLD", "TLOG_PEEK_DESIRED_BYTES")
    saved = [[getattr(k, n) for n in names] for k in regs]

    def set_(**kw):
        for k in regs:
            for n, v in kw.items():
                setattr(k, n, v)
    yield set_
    for k, vals in zip(regs, saved):
        for n, v in zip(names, vals):
            setattr(k, n, v)


# ------------------------------------------- (a) the storage server
def rand_mutations(rng, types, n_keys=60):
    out = []
    for _ in range(rng.randrange(1, 12)):
        k = b"s/%03d" % rng.randrange(n_keys)
        r = rng.random()
        if r < 0.6:
            out.append(types.Mutation(types.MutationType.SetValue, k,
                                      b"v%d" % rng.randrange(1000)))
        elif r < 0.8:
            out.append(types.Mutation(types.MutationType.AddValue, k,
                                      (rng.randrange(99)).to_bytes(8,
                                                                   "little")))
        else:
            k2 = b"s/%03d" % rng.randrange(n_keys)
            out.append(types.Mutation(types.MutationType.ClearRange,
                                      min(k, k2), max(k, k2)))
    return out


class StuckLog:
    """A log system whose peeks never answer (the reference's pull loop
    parks on it)."""

    async def peek_tag(self, tag, begin):
        await Promise().get_future()


def engine_files(kind):
    return ("storage-0.wal", "storage-0.snap") if kind == "memory" else \
        ("storage-0.btree",)


@pytest.mark.parametrize("kind", ["memory", "btree"])
def test_storage_engine_half_matches_reference(loop, tmp_path,  # noqa: F811
                                              kind):
    rng = random.Random(5)
    sfs, pfs = SimFileSystem(), RealFileSystem(str(tmp_path / "main"))
    ref = ref_storage.StorageServer("ss0", 0, None, engine=ref_kv.
                                    open_kv_store(kind, sfs, "storage-0"))
    port = StorageServer("ss0", 0, None,
                         engine=open_kv_store(kind, pfs, "storage-0"))
    if kind == "memory":
        ref.engine.SNAPSHOT_EVERY_BYTES = 400
        port.engine.SNAPSHOT_EVERY_BYTES = 400
    updater = loop.spawn(ref._update_storage_loop())

    async def ref_update(target):
        await ref.durable_version.when_at_least(target)

    version = 0
    for _ in range(12):
        for _ in range(rng.randrange(1, 4)):
            version += rng.randrange(1, 50)
            seed = rng.random()
            for types, ss in ((rt, ref), (pt, port)):
                for m in rand_mutations(random.Random(seed), types):
                    ss._apply(m, version)
            ref.version.set(version)
            port.version = version
        assert port.update_storage()
        run(loop, ref_update(version))
        assert port.durable_version == ref.durable_version.get() == version
        assert port.engine.read_value(_META_KEY) == \
            ref.engine.read_value(_META_KEY) == port._meta_blob(version)
        assert port.engine.read_range(b"", b"\xff\xff\xff") == \
            ref.engine.read_range(b"", b"\xff\xff\xff")
        for name in engine_files(kind):
            if name in sfs.files:
                assert real_bytes(pfs, name) == sim_bytes(sfs, name), name
    assert not port.update_storage()      # nothing new to make durable
    updater.cancel()
    image = {n: sim_bytes(sfs, n) for n in sfs.files}

    # from_engine over copies of the files.
    sfs2 = SimFileSystem()
    pfs2 = RealFileSystem(str(tmp_path / "copy"))
    for name, data in image.items():
        sfs2.open(name).durable = bytearray(data)
        pfs2.open(name).write(0, data)

    async def ref_boot():
        return await ref_storage.StorageServer.from_engine(
            ref_kv.open_kv_store(kind, sfs2, "storage-0"))

    ref2 = run(loop, ref_boot())
    port2 = StorageServer.from_engine(open_kv_store(kind, pfs2, "storage-0"))
    assert port2.version == ref2.version.get() == version
    assert (port2.id, port2.tag, port2.log_epoch) == \
        (ref2.id, ref2.tag, ref2.log_epoch)
    rows = ref2.data.range_read(b"", b"\xff\xff", version, 1 << 30,
                                1 << 40)
    assert port2.data.range_read(b"", b"\xff\xff", version, 1 << 30,
                                 1 << 40) == rows

    # Applied past a recovery version, then re-targeted into a newer
    # epoch: the same rollback and the same re-imaged engine.
    rv = version + 10
    for v in (version + 5, version + 12, version + 20):
        seed = rng.random()
        for types, ss in ((rt, ref2), (pt, port2)):
            for m in rand_mutations(random.Random(seed), types):
                ss._apply(m, v)
        ref2.version.set(v)
        port2.version = v
    ref2._process = sim_process("ss0")
    ref2.set_log_system(StuckLog(), rv, epoch=2)
    port2.set_log_system(None, rv, epoch=2)

    async def rebuilt():
        await ref2._rebuild_f

    run(loop, rebuilt())
    ref2._pull_actor.cancel()
    assert port2.version == ref2.version.get() == rv
    assert port2.durable_version == ref2.durable_version.get() == rv
    assert port2.log_epoch == ref2.log_epoch == 2
    assert port2._durable_pending == ref2._durable_pending
    assert port2._fetch_from == rv + 1
    assert port2.data.range_read(b"", b"\xff\xff", rv, 1 << 30, 1 << 40) \
        == ref2.data.range_read(b"", b"\xff\xff", rv, 1 << 30, 1 << 40)
    assert port2.engine.read_range(b"", b"\xff\xff\xff") == \
        ref2.engine.read_range(b"", b"\xff\xff\xff")
    for name in engine_files(kind):
        if name in sfs2.files:
            assert real_bytes(pfs2, name) == sim_bytes(sfs2, name), name


def test_memory_only_server_pops_at_once():
    """With no engine the server behaves as before: applied is durable
    and the pull pops the log at the applied version."""
    pops = []

    class Log:
        def peek_tag(self, tag, begin):
            return pi.TLogPeekReply(messages=[(7, [pt.Mutation(
                pt.MutationType.SetValue, b"a", b"1")])], end=8,
                max_known_version=7)

        def pop(self, tag, to):
            pops.append((tag, to))

    ss = StorageServer("ss0", 3, Log())
    assert ss.pull_step()
    assert (ss.version, ss.durable_version, pops) == (7, 7, [(3, 7)])
    assert not ss.update_storage() and not ss._durable_pending


# ----------------------------------------------------- (b) DBCoreState
@pytest.mark.parametrize("seed", range(3))
def test_core_state_pack_matches_reference(seed):
    rng = random.Random(seed)
    fields = dict(
        epoch=rng.randrange(1, 1000), recovery_version=rng.randrange(1 << 40),
        log_replication=rng.randrange(1, 4),
        key_servers_ranges=[(b"", b"\x40", [0, 1]), (b"\x40", b"\xff\xff",
                                                     [1, 2])],
        n_resolvers=rng.randrange(1, 5), map_version=rng.randrange(1 << 30),
        tlog_ids=["log%d.e%d" % (i, seed) for i in range(rng.randrange(4))],
        storage_ids={t: "ss%d" % t for t in range(rng.randrange(5))},
        resolver_ranges=[(b"", b"\x80", 0), (b"\x80", b"\xff", 1)])
    want = ref_master.DBCoreState(**fields)
    got = port_master.DBCoreState(**fields)
    blob = got.pack()
    assert blob == want.pack()
    back = port_master.DBCoreState.coerce(blob)
    assert back.pack() == blob
    assert (back.epoch, back.tlog_ids, back.storage_ids,
            back.key_servers_ranges, back.resolver_ranges) == \
        (fields["epoch"], fields["tlog_ids"], fields["storage_ids"],
         fields["key_servers_ranges"], fields["resolver_ranges"])
    assert port_master.DBCoreState.coerce(None) is None


# ------------------------------------------------------ (c) the epoch end
def epoch_stream(seed: int, n: int = 30):
    """Per version: {tag: [(type, p1, p2)]}: storage tags 0-3 and, now and
    then, a keyServers split on TXS_TAG."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        msgs = {}
        for tag in rng.sample(range(4), rng.randrange(1, 4)):
            msgs[tag] = [(0, b"%c/%d" % (65 + tag, i), b"x" * 20)]
        if rng.random() < 0.25:
            split = bytes([rng.randrange(1, 255)])
            team = sorted(rng.sample(range(4), 2))
            msgs[pi.TXS_TAG] = [(0, sd.key_servers_key(split),
                                 sd.key_servers_value(team))]
        out.append(msgs)
    return out


async def ref_epoch_end(prev, tlogs):
    """The reference master_server's epoch end (:886-1000) over its own
    TLogs: lock, holders and popped versions by team, the least end
    version, the TXS_TAG replay through apply_metadata_mutation."""
    locked = {}
    for i, t in enumerate(tlogs):
        if t is not None:
            p = Promise()
            await t._lock(ri.TLogLockRequest(epoch=prev.epoch + 1, reply=p))
            locked[i] = await p.get_future()
    old_ls = RefLogSystem([t and t.interface for t in tlogs],
                          prev.log_replication)
    holders, popped = {}, {}
    for tag in sorted(prev.storage_ids):
        h = next(i for i in old_ls.team_for_tag(tag) if i in locked)
        holders[tag] = h
        popped[tag] = locked[h].tags.get(tag, 0)
    rv = min(r.end_version for r in locked.values())
    rm = RefRangeMap(default=None)
    for b, e, team in prev.key_servers_ranges:
        rm.set_range(b, e, team)
    h = next(i for i in old_ls.team_for_tag(ri.TXS_TAG) if i in locked)
    txs = await RequestStream.at(tlogs[h].interface.peek.endpoint).get_reply(
        ri.TLogPeekRequest(tag=ri.TXS_TAG, begin=prev.map_version + 1))
    for v, msgs in txs.messages:
        if prev.map_version < v <= rv:
            for m in msgs:
                apply_metadata_mutation(rm, m)
    return locked, holders, popped, rv, [
        (b, e, team) for b, e, team in rm.ranges() if team is not None]


@pytest.mark.parametrize("case", ["even", "one_ahead", "one_gone"])
def test_epoch_end_matches_reference(loop, tmp_path, case):  # noqa: F811
    stream = epoch_stream(7)
    fs = SimFileSystem()
    refs, ports = [], []
    for i in range(2):
        r = ref_tlog.TLog(f"log{i}", disk_queue=ref_dq.DiskQueue(
            fs.open(f"log{i}.wal")))
        r.run(sim_process(f"log{i}"))
        refs.append(r)
        ports.append(port_tlog.TLog(f"log{i}", disk_queue=DiskQueue(
            port_file(tmp_path, f"log{i}.wal"))))
    ranges = [(b"", b"\x80", [0, 1]), (b"\x80", b"\xff\xff", [2, 3])]
    fields = dict(epoch=3, recovery_version=0, log_replication=2,
                  key_servers_ranges=ranges, n_resolvers=2, map_version=4,
                  tlog_ids=["log0", "log1"],
                  storage_ids={t: "ss%d" % t for t in range(4)})
    rng = random.Random(3)

    async def feed():
        for v, msgs in enumerate(stream, 1):
            last = v == len(stream)
            for i, (r, p) in enumerate(zip(refs, ports)):
                if last and case == "one_ahead" and i == 1:
                    continue        # its push never reached log1
                team_msgs = {t: m for t, m in msgs.items()
                             if i in RefLogSystem([0, 1], 2).team_for_tag(t)}
                await ref_commit(r, v, v - 1, v - 1,
                                 {t: muts(rt, m) for t, m in
                                  team_msgs.items()})
                pi.ask(p.commit, pi.TLogCommitRequest(
                    v - 1, v, v - 1,
                    {t: muts(pt, m) for t, m in team_msgs.items()}))
            if v % 5 == 0:
                tag, to = rng.randrange(4), rng.randrange(v)
                for r, p in zip(refs, ports):
                    r._pop(ri.TLogPopRequest(tag=tag, to=to, reply=False))
                    p.pop(pi.TLogPopRequest(tag=tag, to=to))
        gone = [None, refs[1]] if case == "one_gone" else refs
        return await ref_epoch_end(ref_master.DBCoreState(**fields), gone)

    locked, holders, popped, rv, shard_map = run(loop, feed())
    old = {"log0": ports[0], "log1": ports[1]}
    if case == "one_gone":
        del old["log0"]
    end = port_master.epoch_end(port_master.DBCoreState(**fields), old)
    assert end.epoch == 4 and end.master.epoch == 4
    assert {i: (r.end_version, r.known_committed_version, r.tags)
            for i, r in end.locked.items()} == \
        {i: (r.end_version, r.known_committed_version, r.tags)
         for i, r in locked.items()}
    assert end.recovery_version == rv == len(stream) - (case == "one_ahead")
    assert {t: h.id for t, h in end.tag_holders.items()} == \
        {t: f"log{h}" for t, h in holders.items()}
    assert end.popped == popped
    assert end.key_servers_ranges == shard_map
    assert end.txs_deltas > 0
    assert end.master.version == end.master.last_epoch_end == rv
    assert all(p.stopped for p in old.values())


def test_epoch_end_refuses_without_a_holder(tmp_path):
    prev = port_master.DBCoreState(
        epoch=1, recovery_version=0, log_replication=1,
        tlog_ids=["log0", "log1"], storage_ids={0: "ss0", 1: "ss1"})
    t = port_tlog.TLog("log1", disk_queue=DiskQueue(port_file(tmp_path)))
    with pytest.raises(FdbError) as e:
        port_master.epoch_end(prev, {"log1": t})
    assert e.value.name == "master_recovery_failed"
    with pytest.raises(FdbError):
        port_master.epoch_end(prev, {})


# ------------------------------------------------------- (d) the slice
class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.013
        return self.t


def port_cluster(datadir, engine, clock):
    return StaticCluster(n_resolvers=2, proxy_ids=["proxy0", "proxy1"],
                         n_storage=4, n_tlogs=2, replication=2,
                         datadir=datadir, storage_engine=engine,
                         device="cpu", clock=clock, capacity=1 << 10)


def port_recover(datadir, clock):
    return StaticCluster.recover(datadir, ["proxy0", "proxy1"], device="cpu",
                                 clock=clock, capacity=1 << 10)


def port_commit(c, batches, on_batch=None):
    """The batches through the port's cluster, each batch's read versions
    from its own side; outcomes and versions."""
    versions, outcomes = [], []
    for i, batch in enumerate(batches):
        live = c.read_version()
        snaps = [live, versions[-2] if len(versions) > 1 else 0]
        reqs = [CommitTransactionRequest(
            to(pt, (reads, writes, muts_, snaps[lag])), reply=Reply())
            for reads, writes, muts_, lag in batch]
        [(_prev, v)] = c.commit("proxy%d" % (i % 2), reqs)
        versions.append(v)
        outcomes.append([outcome(r.reply.value, r.reply.error)
                         for r in reqs])
        if on_batch is not None:
            on_batch(c, i)
    return outcomes, versions


def port_rows(c, version):
    """Both replicas' rows of the whole keyspace at `version` (they must
    agree), point reads agreeing with them."""
    per = c.get_range(b"", b"\xff\xff", version)
    assert len(per) == 2 and per[0] == per[1]
    for k, v in per[0][:40]:
        assert c.get(k, version) == [v, v]
    return per[0]


def ref_run(batches, recovery_version=0, preload=None):
    """The batches through SimCluster built at `recovery_version`, each
    storage server loaded with `preload` ({key: value}; the keys of KEYS
    with base values by default) at that version: outcomes, versions and
    the rows of both replicas at the last version."""
    c = SimCluster(n_resolvers=2, n_storage=4, n_tlogs=2,
                   n_commit_proxies=2, replication=2,
                   conflict_backend="cpu", recovery_version=recovery_version)
    if preload is None:
        preload = {k: b"base" + k for k in KEYS}
    for ss in c.storage:
        for b, e, team in c.key_servers.ranges():
            if ss.tag in team:
                for k, v in preload.items():
                    if b <= k < e:
                        ss.data.set(k, v, recovery_version)

    async def go():
        versions, outcomes = [], []
        for i, batch in enumerate(batches):
            p = c.commit_proxies[i % 2]
            live = c.master.live_committed_version
            snaps = [live, versions[-2] if len(versions) > 1 else 0]
            reqs = []
            for reads, writes, muts_, lag in batch:
                req = ri.CommitTransactionRequest(
                    to(rt, (reads, writes, muts_, snaps[lag])))
                req.reply = Promise()
                reqs.append(req)
            p.local_batch_number += 1
            await p._commit_batch(reqs, p.local_batch_number)
            versions.append(c.master.version)
            got = []
            for req in reqs:
                try:
                    cid = await req.reply.get_future()
                    got.append(("ok", cid.txn_batch_index))
                except Exception as e:   # noqa: BLE001 - the verdicts
                    got.append(("err", e.name))
            outcomes.append(got)
        top = versions[-1]
        for ss in c.storage:
            await ss.version.when_at_least(top)
        per = []
        for j in range(2):
            replica = []
            for b, e, team in c.commit_proxies[0].key_servers.ranges():
                rep = await RequestStream.at(
                    c.storage[team[j]].interface.get_key_values.endpoint
                ).get_reply(ri.GetKeyValuesRequest(
                    b, e, top, limit=10**9, limit_bytes=1 << 40))
                replica += rep.data
            per.append(replica)
        return outcomes, versions, per

    return c.run_until(c.loop.spawn(go()), timeout=600)


A = slice_batches(17)
B = slice_batches(29, n_batches=4)


def kill(c):
    c.kill()
    del c
    gc.collect()


def check_read_back(c, versions_a, want_rows, label):
    """The recovered cluster's rows at its recovery version equal the
    reference's (versionstamps read as batches), and below it reads are
    too old."""
    rv = c.recovery["recovery_version"]
    got = port_rows(c, rv)
    assert normalise(got, versions_a) == want_rows, label
    with pytest.raises(FdbError) as e:
        c.get(KEYS[0], rv - 1)
    assert e.value.name == "transaction_too_old"
    return got


@pytest.fixture(scope="module")
def ref_a():
    """SimCluster over the batches A: (outcomes, versions, rows), rows
    normalised by its own versions."""
    from foundationdb_tpu.core import (DeterministicRandom,
                                       set_deterministic_random,
                                       set_event_loop)
    from foundationdb_tpu.rpc.sim import set_simulator
    set_deterministic_random(DeterministicRandom(7))
    out, versions, per = ref_run(A)
    set_simulator(None)
    set_event_loop(None)
    assert per[0] == per[1]
    return out, versions, normalise(per[0], versions)


@pytest.mark.parametrize("engine", ["memory", "btree"])
def test_slice_survives_restarts(sim, tmp_path, ref_a, engine):
    want_out, _want_v, want_rows = ref_a
    clock = Clock()
    datadir = str(tmp_path / "data")
    c = port_cluster(datadir, engine, clock)
    c.load(KEYS, [b"base" + k for k in KEYS])

    def every_other(c, i):
        c.pull()
        if i % 2:
            c.update_storage()

    got_out, versions_a = port_commit(c, A, every_other)
    assert got_out == want_out
    kill(c)

    c = port_recover(datadir, clock)
    assert c.recovery["epoch"] == 2 and c.storage_engine == engine
    assert c.recovery["recovery_version"] >= versions_a[-1]
    rows = check_read_back(c, versions_a, want_rows, "first restart")

    # Batches B after the restart, against a SimCluster at the recovery
    # version loaded with the recovered rows.
    rv = c.recovery["recovery_version"]
    got_b, versions_b = port_commit(c, B)
    c.pull()
    c.update_storage()
    want_b, ref_versions_b, ref_per = ref_run(B, rv, dict(rows))
    assert got_b == want_b
    assert {o[0] for b in got_b for o in b} == {"ok", "err"}
    top = versions_b[-1]
    assert normalise(port_rows(c, top), versions_a + versions_b) == \
        normalise(ref_per[0], versions_a + ref_versions_b) == \
        normalise(ref_per[1], versions_a + ref_versions_b)
    rows_b = port_rows(c, top)
    kill(c)

    # A second restart in a row loses nothing either.
    c = port_recover(datadir, clock)
    assert c.recovery["epoch"] == 3
    assert c.recovery["recovery_version"] >= top
    assert port_rows(c, c.recovery["recovery_version"]) == rows_b
    files = sorted(os.listdir(datadir))
    assert [f for f in files if f.startswith("tlog-")] == \
        ["tlog-log0.e3.wal", "tlog-log1.e3.wal"]
    c.close()


def test_pulled_but_not_durable_at_the_kill(sim, tmp_path, ref_a):
    """Storage server 1 pulls every batch but never commits its engine
    after the load: the logs keep its tag from the load on, and the
    recovered server pulls it all back from the new generation."""
    _o, _v, want_rows = ref_a
    clock = Clock()
    datadir = str(tmp_path / "data")
    c = port_cluster(datadir, "memory", clock)
    c.load(KEYS, [b"base" + k for k in KEYS])

    def durable_but_ss1(c, i):
        c.pull()
        for ss in c.storage:
            if ss.tag != 1:
                ss.update_storage()

    _out, versions_a = port_commit(c, A, durable_but_ss1)
    held = c.storage[1]
    assert held.durable_version == 0 < held.version == versions_a[-1]
    assert all(t.poppedtags.get(1, 0) == 0 for t in c.tlogs)
    kill(c)
    c = port_recover(datadir, clock)
    assert c.storage[1].version == 0 < c.storage[1].oldest_version + 1
    check_read_back(c, versions_a, want_rows, "not durable")
    c.close()


class FailingWrite(RealFile):
    """A real file whose writes fail: the record never reaches it."""

    def write(self, offset, data):
        raise OSError(5, "injected write failure")


def test_tlog_one_version_ahead(sim, tmp_path, ref_a):
    """The last batch's push reaches log0 (durable) but log1's write
    fails: commit() raises and nothing is acknowledged.  Storage server
    0 (which peeks log0 first) applies it, but its engine stops at the
    version durable on both logs.  The recovery version is log1's end,
    the last acknowledged version; nothing past it survives the restart
    and the rows equal SimCluster's after the batches A, twice."""
    _o, _v, want_rows = ref_a
    clock = Clock()
    datadir = str(tmp_path / "data")
    c = port_cluster(datadir, "btree", clock)
    c.load(KEYS, [b"base" + k for k in KEYS])

    def durable(c, i):
        c.pull()
        c.update_storage()

    _out, versions_a = port_commit(c, A, durable)
    dq = c.tlogs[1].disk_queue
    good = dq.file
    dq.file = FailingWrite(good._path, good.name)
    extra = [CommitTransactionRequest(to(pt, ([], [(k, k + b"\x00")],
                                              [(0, k, b"lost")],
                                              versions_a[-1])),
                                      reply=Reply())
             for k in KEYS[:5]]
    with pytest.raises(OSError, match="injected"):
        c.commit("proxy0", extra)
    assert not any(r.reply.sent for r in extra)
    ahead = c.tlogs[0].durable_version
    assert ahead > c.tlogs[1].durable_version == versions_a[-1]
    ss0 = c.storage[0]
    assert ss0.pull() and ss0.version == ahead
    assert c.get(KEYS[0], ahead)[0] == b"lost"
    assert not ss0.update_storage()
    assert ss0.durable_version == versions_a[-1]
    assert ss0._durable_pending
    dq.file.close()
    kill(c)
    c = port_recover(datadir, clock)
    assert c.recovery["recovery_version"] == versions_a[-1]
    assert c.storage[0].version == versions_a[-1]
    check_read_back(c, versions_a, want_rows, "one ahead")
    rows = port_rows(c, versions_a[-1])
    kill(c)
    c = port_recover(datadir, clock)
    assert port_rows(c, c.recovery["recovery_version"]) == rows
    c.close()


def test_reference_rollback_below_a_durable_image(loop, tmp_path):  # noqa
    """Observation on the reference: its storage server makes its engine
    durable at the applied version, which a push that one log lost can
    pass.  Rebuilt by from_engine (every key at that one version) and
    re-targeted below it, its rollback drops every key and re-images an
    empty engine.  The port's update_storage stops at the version durable
    on every TLog, below which no recovery ends."""
    sfs = SimFileSystem()
    ref = ref_storage.StorageServer("ss0", 0, None, engine=ref_kv.
                                    open_kv_store("memory", sfs, "storage-0"))
    updater = loop.spawn(ref._update_storage_loop())
    for v in (10, 20):
        ref._apply(rt.Mutation(rt.MutationType.SetValue, b"k%d" % v, b"x"),
                   v)
    ref.version.set(20)

    async def durable():
        await ref.durable_version.when_at_least(20)
        return await ref_storage.StorageServer.from_engine(
            ref_kv.open_kv_store("memory", sfs, "storage-0"))

    ref2 = run(loop, durable())
    updater.cancel()
    assert len(ref2.data) == 2
    ref2._process = sim_process("ss0")
    ref2.set_log_system(StuckLog(), 10, epoch=2)

    async def rebuilt():
        await ref2._rebuild_f

    run(loop, rebuilt())
    ref2._pull_actor.cancel()
    assert len(ref2.data) == 0          # k10, written at 10, is gone too
    assert ref2.engine.read_range(b"", b"\xff\xff") == []


def test_spilled_backlog_across_the_restart(sim, tmp_path, ref_a, knobs):
    """Storage server 3 is held back for the last batches: its tag's
    backlog spills on both TLogs, is recovered from their queue files,
    carried to the new generation in pages of a lowered peek budget (the
    reference's one peek would drop all but the first), and read back."""
    _o, _v, want_rows = ref_a
    knobs(TLOG_SPILL_THRESHOLD=1_500, TLOG_PEEK_DESIRED_BYTES=300)
    clock = Clock()
    datadir = str(tmp_path / "data")
    c = port_cluster(datadir, "memory", clock)
    c.load(KEYS, [b"base" + k for k in KEYS])

    def hold_ss3(c, i):
        for ss in c.storage:
            if ss.tag != 3 or i < 2:
                ss.pull()
                ss.update_storage()

    _out, versions_a = port_commit(c, A, hold_ss3)
    assert all(t.spilled.get(3) for t in c.tlogs)
    backlog = sum(nb for t in c.tlogs for _v, _s, nb in t.spilled[3])
    assert backlog > 2 * 300
    kill(c)
    c = port_recover(datadir, clock)
    assert c.storage[3].version < versions_a[-1]
    check_read_back(c, versions_a, want_rows, "spilled")
    c.close()


def test_recover_needs_a_card_unless_told(monkeypatch, tmp_path):
    datadir = str(tmp_path / "data")
    c = StaticCluster(n_resolvers=1, proxy_ids=["p0"], device="cpu",
                      datadir=datadir, storage_engine="memory",
                      capacity=1 << 10)
    kill(c)
    before = {f: open(os.path.join(datadir, f), "rb").read()
              for f in os.listdir(datadir)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StaticCluster.recover(datadir, ["p0"])
    assert {f: open(os.path.join(datadir, f), "rb").read()
            for f in os.listdir(datadir)} == before
    c = StaticCluster.recover(datadir, ["p0"], device="cpu",
                              capacity=1 << 10)
    assert c.recovery["epoch"] == 2
    c.close()


# ---------------------------------------------------- (e) chip_smoke.py
def test_chip_smoke_restart_on_cpu():
    """chip_smoke.py's restart phase at a tiny size on the CPU: every
    check of its run (acknowledged keys on both replicas after each of
    two restarts, equal to the dict model; too-old reads below the
    recovery version; the spilled backlog read back; the batches after
    the restart equal to a CPU plane's verdicts) with each engine."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    for engine in ("memory", "btree"):
        _launches, figures = chip_smoke.restart_run(
            engine=engine, device="cpu", keyspace=3_000, txns=300,
            batches=(2, 2), after=2, capacity=1 << 12,
            delta_capacity=1 << 11, spill_threshold=4_000)
        assert figures["restarts"] == 2
        assert figures["mb_spilled"] > 0
        assert all(r["keys_read_back"] > 0 for r in figures["recoveries"])
