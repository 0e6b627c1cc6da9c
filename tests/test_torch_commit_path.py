"""The port's write path held against the JAX package's: the commit
proxy's mutation-to-tag routing and the slice as a whole.

The reference's are foundationdb_tpu/server/commit_proxy.py
(_assign_mutations_to_tags, both of its builders) and the static cluster
of server/cluster.py (SimCluster, its resolvers on its oracle, each batch
handed to a proxy's _commit_batch, run in its simulated event loop); the
port's are foundationdb_tpu_torch/server/{commit_proxy,cluster}.py, the
port's resolvers on the CPU (supervised TorchConflictSet, capacity 2^10).
Tolerance 0:

  (a) the tag assignment: the port's one builder against each of the
      reference's two (PROXY_VECTORIZED_ASSEMBLY off and on) on seeded
      batches with verdicts of every kind -- sets, atomics, clears across
      shards, versionstamped keys and values (stamped at the batch
      index), \\xff/keyServers/ splits that keep or grow a team (routed
      to TXS_TAG, moving the map before later mutations), a clear across
      \\xff -- the same messages tag for tag and the same shard map after;
  (b) the whole slice: the same seeded batches through SimCluster and
      through the port's StaticCluster (2 resolvers, 2 proxies in turn, 2
      TLogs and 4 storage servers with teams of 2, the same loaded keys),
      each batch's read versions from its own side's read version: the
      same verdicts and batch indices, each CommitID at its own side's
      batch version, and the same contents read back from every replica
      at each batch's version once the versionstamps in them are read as
      (batch, index) -- every stamp decoding to its transaction's
      CommitID on its own side;

and the write path's guarantees on the port: no reply before every
TLog's durable version and the master's live committed version reach the
commit version; a repair batch takes its own version from the master; a
disk queue whose fsync fails makes commit() raise with no reply sent and
the master's live committed version short of its version; reads
outside the window raise; and a cluster with no device named and no card
raises at construction.
"""

import random

import pytest
import torch

from foundationdb_tpu.core.futures import Promise
from foundationdb_tpu.core.knobs import server_knobs as ref_knobs
from foundationdb_tpu.rpc.endpoint import RequestStream
from foundationdb_tpu.server import interfaces as ri
from foundationdb_tpu.server import system_data as ref_sd
from foundationdb_tpu.server.cluster import SimCluster
from foundationdb_tpu.server.shardmap import RangeMap as RefRangeMap
from foundationdb_tpu.txn import types as rt
from foundationdb_tpu_torch.core.error import FdbError
from foundationdb_tpu_torch.core.knobs import server_knobs
from foundationdb_tpu_torch.server import system_data as sd
from foundationdb_tpu_torch.server.cluster import StaticCluster
from foundationdb_tpu_torch.server.commit_proxy import (
    COMMIT_TRANSACTION_BATCH_COUNT_MAX, CommitProxy)
from foundationdb_tpu_torch.server.interfaces import (
    TXS_TAG, CommitTransactionRequest, GetValueRequest, Reply, ask)
from foundationdb_tpu_torch.server.real_fs import RealFile
from foundationdb_tpu_torch.server.shardmap import RangeMap
from foundationdb_tpu_torch.txn import types as pt

COUNTER = b"\xf0/counter"
BOUNDS = [b"", b"\x40", b"\x80", b"\xc0"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def sim():
    """The reference's simulator globals, reset after the test."""
    from foundationdb_tpu.core import (DeterministicRandom,
                                       set_deterministic_random,
                                       set_event_loop)
    from foundationdb_tpu.rpc.sim import set_simulator
    set_deterministic_random(DeterministicRandom(7))
    yield
    set_simulator(None)
    set_event_loop(None)


def run(c, coro):
    return c.run_until(c.loop.spawn(coro), timeout=600)


# --------------------------------------------------------- conversions
def to(types, spec):
    """A transaction from its plain spec (reads, writes, mutations as
    (type, p1, p2), snapshot) in `types`' classes."""
    reads, writes, mutations, snap = spec
    return types.CommitTransactionRef(
        read_conflict_ranges=[types.KeyRange(a, b) for a, b in reads],
        write_conflict_ranges=[types.KeyRange(a, b) for a, b in writes],
        mutations=[types.Mutation(types.MutationType(t), a, b)
                   for t, a, b in mutations],
        read_snapshot=snap)


def as_tuples(msgs):
    return [(int(m.type), m.param1, m.param2) for m in msgs]


def stamped(prefix: bytes, suffix: bytes) -> bytes:
    """A versionstamped key or value: prefix, the 10-byte slot, suffix,
    then the slot's offset as the trailing 4 bytes."""
    return prefix + b"\x00" * 10 + suffix + len(prefix).to_bytes(4, "little")


def point(k):
    return (k, k + b"\x00")


# ------------------------------------------------- (a) tag assignment
def teams_map(types_map, triples):
    m = types_map(default=None)
    for b, e, team in triples:
        m.set_range(b, e, team)
    return m


SHARDS = [(b"", b"\x40", [0, 1]), (b"\x40", b"\x80", [1, 2]),
          (b"\x80", b"\xc0", [2, 3]), (b"\xc0", b"\xff\xff", [3, 0])]


def assign_specs(seed: int, n: int = 60) -> list:
    rng = random.Random(seed)

    def key():
        return bytes([rng.randrange(0xf0)]) + b"/%d" % rng.randrange(99)

    verdicts = [rng.choice([0, 1, 2, 2, 2, 2]) for _ in range(n)]
    # The map as the committed splits so far leave it: a split's team is
    # its shard's current team, or that grown by a tag (a team that
    # shrinks is fenced: test_shard_team_change_is_refused holds that).
    cur = teams_map(RangeMap, SHARDS)
    specs = []
    for t in range(n):
        muts = []
        for _ in range(rng.randrange(0, 5)):
            r = rng.random()
            if r < 0.35:
                muts.append((0, key(), b"v%d" % t))
            elif r < 0.45:
                muts.append((2, COUNTER, b"\x01"))
            elif r < 0.6:
                a, b = sorted((key(), key()))
                muts.append((1, a, b + b"\x00"))
            elif r < 0.7:
                muts.append((14, stamped(b"vs/", b"/%d" % t), b"x"))
            elif r < 0.78:
                muts.append((15, key(), stamped(b"val:", b"")))
            elif r < 0.86:
                # A split: the new shard keeps its team, or grows it.
                split = key()
                team = list(cur.lookup(split))
                extra = [x for x in range(4) if x not in team]
                if extra and rng.random() < 0.5:
                    team.append(rng.choice(extra))
                muts.append((0, sd.key_servers_key(split),
                             sd.key_servers_value(team)))
                if verdicts[t] == 2:
                    sd.apply_key_servers_mutation(cur, pt.Mutation(
                        pt.MutationType.SetValue, *muts[-1][1:]))
            elif r < 0.9:
                muts.append((1, b"\xfe", b"\xff\x01"))
            else:
                muts.append((6, key(), b"\x0f"))
        specs.append(([], [], muts, 0))
    return specs, verdicts


@pytest.mark.parametrize("vec", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_assign_mutations_matches_reference(sim, monkeypatch, seed, vec):
    monkeypatch.setattr(ref_knobs(), "PROXY_VECTORIZED_ASSEMBLY", vec)
    ref = SimCluster(n_storage=4, replication=2).commit_proxies[0]
    ref.key_servers = teams_map(RefRangeMap, SHARDS)
    port = CommitProxy("p0", [None], [(b"", b"\xff\xff", 0)],
                       key_servers=teams_map(RangeMap, SHARDS))
    specs, verdicts = assign_specs(seed)
    version = 1_000_003 + seed
    want = ref._assign_mutations_to_tags(
        [ri.CommitTransactionRequest(to(rt, s)) for s in specs],
        [rt.CommitResult(v) for v in verdicts], version)
    got = port._assign_mutations_to_tags(
        [CommitTransactionRequest(to(pt, s)) for s in specs],
        [pt.CommitResult(v) for v in verdicts], version)
    assert {t: as_tuples(m) for t, m in got.items()} == \
        {t: as_tuples(m) for t, m in want.items()}
    assert TXS_TAG in got
    assert list(port.key_servers.ranges()) == list(ref.key_servers.ranges())
    # Every stamp is this version and its transaction's batch index.
    stamps = [(m.param1[3:13], i) for i, (s, v) in enumerate(
        zip(specs, verdicts)) if v == 2 for t, a, b in s[2] if t == 14
        for m in [pt.Mutation(pt.MutationType.SetValue,
                              a[:3] + pt.make_versionstamp(version, i) +
                              a[13:-4], b)]]
    routed = {m.param1 for msgs in got.values() for m in msgs}
    assert stamps and all(
        m_key[:13] == b"vs/" + stamp and m_key in routed
        for stamp, i in stamps for m_key in
        [b"vs/" + stamp + b"/%d" % i])


def test_key_servers_mutations_match_reference():
    """apply_key_servers_mutation over seeded splits and boundary clears,
    and the team values' encoding, against the reference's."""
    rng = random.Random(9)
    port, ref = teams_map(RangeMap, SHARDS), teams_map(RefRangeMap, SHARDS)
    for _ in range(60):
        k = bytes([rng.randrange(256)])
        if rng.random() < 0.6:
            team = rng.sample(range(4), 2)
            assert sd.key_servers_value(team) == \
                ref_sd.key_servers_value(team)
            assert sd.decode_key_servers_value(
                sd.key_servers_value(team)) == team
            m = (0, sd.key_servers_key(k), sd.key_servers_value(team))
        else:
            k2 = bytes([rng.randrange(256)])
            a, b = sorted((k, k2))
            m = (1, sd.key_servers_key(a), sd.key_servers_key(b))
        got = sd.apply_key_servers_mutation(port, pt.Mutation(
            pt.MutationType(m[0]), m[1], m[2]))
        want, _flag = ref_sd.apply_metadata_mutation(ref, rt.Mutation(
            rt.MutationType(m[0]), m[1], m[2]))
        assert got == want
        assert list(port.ranges()) == list(ref.ranges())
    assert not sd.apply_key_servers_mutation(port, pt.Mutation.set_value(
        b"\xff/other", b"x"))


# ------------------------------------------------------ (b) the slice
KEYS = sorted(bytes([i * 240 // 120]) + b"/%03d" % i for i in range(120))


def slice_batches(seed: int, n_batches: int = 6, txns: int = 30):
    """Per batch, per txn: (reads, writes, mutations, lag) with lag the
    number of batches its read version trails (0 or 1); a keyServers
    split keeping its team in batch 2."""
    rng = random.Random(seed)
    out = []
    for b in range(n_batches):
        batch = []
        for t in range(txns):
            reads = [point(rng.choice(KEYS)) for _ in range(2)]
            w = rng.choice(KEYS)
            writes, muts = [point(w)], [(0, w, b"b%d.%d" % (b, t))]
            r = rng.random()
            if r < 0.1:
                muts.append((2, COUNTER, (1).to_bytes(8, "little")))
                writes.append(point(COUNTER))
            elif r < 0.2:
                muts.append((14, stamped(b"vs/", b"/%d.%d" % (b, t)),
                             b"i%d.%d" % (b, t)))
            elif r < 0.3:
                i = rng.randrange(len(KEYS) - 3)
                muts.append((1, KEYS[i], KEYS[i + 3]))
                writes.append((KEYS[i], KEYS[i + 3]))
            if b == 2 and t == 0:
                muts.append((0, sd.key_servers_key(b"\x50"),
                             sd.key_servers_value([1, 2])))
                writes.append(point(sd.key_servers_key(b"\x50")))
            batch.append((reads, writes, muts, rng.choice([0, 0, 1])))
        out.append(batch)
    return out


def outcome(reply_value, reply_error):
    if reply_error is not None:
        return ("err", reply_error.name)
    return ("ok", reply_value.txn_batch_index)


def normalise(rows, version_of_batch):
    """Rows with every versionstamp in a vs/ key read as (batch, index)."""
    batch_of = {v: b for b, v in enumerate(version_of_batch)}
    out = []
    for k, v in rows:
        if k.startswith(b"vs/"):
            ver = int.from_bytes(k[3:11], "big")
            k = (b"vs/", batch_of[ver], int.from_bytes(k[11:13], "big"),
                 k[13:])
        out.append((k, v))
    return out


def ref_slice(batches, reads_at):
    """The batches through SimCluster: outcomes per batch, each batch's
    version, and the rows of every replica at each read version."""
    c = SimCluster(n_resolvers=2, n_storage=4, n_tlogs=2,
                   n_commit_proxies=2, replication=2,
                   conflict_backend="cpu")
    for ss in c.storage:
        for b, e, team in c.key_servers.ranges():
            if ss.tag in team:
                for k in KEYS:
                    if b <= k < e:
                        ss.data.set(k, b"base" + k, 0)

    async def go():
        versions, outcomes = [], []
        for i, batch in enumerate(batches):
            p = c.commit_proxies[i % 2]
            live = c.master.live_committed_version
            snaps = [live, versions[-2] if len(versions) > 1 else 0]
            reqs = []
            for reads, writes, muts, lag in batch:
                spec = (reads, writes, muts, snaps[lag])
                req = ri.CommitTransactionRequest(to(rt, spec))
                req.reply = Promise()
                reqs.append(req)
            p.local_batch_number += 1
            await p._commit_batch(reqs, p.local_batch_number)
            versions.append(c.master.version)
            got = []
            for req in reqs:
                try:
                    cid = await req.reply.get_future()
                    assert cid.version == versions[-1]
                    got.append(("ok", cid.txn_batch_index))
                except Exception as e:   # noqa: BLE001 - the verdicts
                    got.append(("err", e.name))
            outcomes.append(got)
        top = versions[-1]
        for ss in c.storage:
            await ss.version.when_at_least(top)
        rows = {}
        for v in reads_at(versions):
            per = []
            for j in range(2):
                replica = []
                for b, e, team in c.commit_proxies[0].key_servers.ranges():
                    ss = c.storage[team[j]]
                    rep = await RequestStream.at(
                        ss.interface.get_key_values.endpoint).get_reply(
                        ri.GetKeyValuesRequest(b, e, v, limit=10**9,
                                               limit_bytes=1 << 40))
                    replica += rep.data
                per.append(normalise(replica, versions))
            rows[versions.index(v)] = per
        return outcomes, versions, rows

    return run(c, go())


def port_slice(batches, reads_at, tmp_path):
    t = [0.0]

    def clock():
        t[0] += 0.013
        return t[0]

    c = StaticCluster(n_resolvers=2, proxy_ids=["proxy0", "proxy1"],
                      n_storage=4, n_tlogs=2, replication=2,
                      datadir=str(tmp_path), device="cpu", clock=clock,
                      capacity=1 << 10)
    c.load(KEYS, [b"base" + k for k in KEYS])
    versions, outcomes = [], []
    for i, batch in enumerate(batches):
        live = c.read_version()
        snaps = [live, versions[-2] if len(versions) > 1 else 0]
        reqs = [CommitTransactionRequest(
            to(pt, (reads, writes, muts, snaps[lag])), reply=Reply())
            for reads, writes, muts, lag in batch]
        [(_prev, v)] = c.commit("proxy%d" % (i % 2), reqs)
        versions.append(v)
        got = []
        for req in reqs:
            assert req.reply.sent
            if req.reply.error is None:
                assert req.reply.value.version == v
            got.append(outcome(req.reply.value, req.reply.error))
        outcomes.append(got)
    c.pull()
    rows = {}
    for v in reads_at(versions):
        per = c.get_range(b"", b"\xff\xff", v)
        assert len(per) == 2
        rows[versions.index(v)] = [normalise(r, versions) for r in per]
        # Point reads agree with the range reads on both replicas.
        for k, val in per[0]:
            assert c.get(k, v) == [val, val]
    c.close()
    return outcomes, versions, rows


def test_slice_matches_simcluster(sim, tmp_path):
    batches = slice_batches(17)
    reads_at = lambda versions: versions[-3:]   # noqa: E731
    want_out, want_v, want_rows = ref_slice(batches, reads_at)
    got_out, got_v, got_rows = port_slice(batches, reads_at, tmp_path)
    assert got_out == want_out
    kinds = {o[0] for b in got_out for o in b}
    assert kinds == {"ok", "err"}
    assert got_rows.keys() == want_rows.keys()
    for b, per in got_rows.items():
        assert per[0] == per[1] == want_rows[b][0] == want_rows[b][1]
    # The counter holds the committed adds; every stamp names its txn.
    last = got_rows[len(batches) - 1][0]
    adds = sum(1 for batch, outs in zip(batches, got_out)
               for (_r, _w, muts, _l), o in zip(batch, outs)
               if o[0] == "ok" and any(m[0] == 2 for m in muts))
    assert adds and dict(last)[COUNTER] == adds.to_bytes(8, "little")
    stamps = [k for k, _v in last if isinstance(k, tuple)]
    assert stamps and all(
        got_out[b][i] == ("ok", i) and k[3] == b"/%d.%d" % (b, i)
        for k in stamps for b, i in [k[1:3]])


# --------------------------------------------------- the guarantees
def small_cluster(tmp_path, **kw):
    t = [0.0]

    def clock():
        t[0] += 0.5
        return t[0]

    c = StaticCluster(n_resolvers=1, proxy_ids=["p0"], n_storage=2,
                      n_tlogs=2, replication=2, datadir=str(tmp_path),
                      device="cpu", clock=clock, capacity=1 << 10, **kw)
    c.load(KEYS, [b"base"] * len(KEYS))
    return c


def set_req(key, value, snap, reads=(), reply=None):
    return CommitTransactionRequest(to(pt, (
        [point(k) for k in reads], [point(key)], [(0, key, value)], snap)),
        reply=reply or Reply())


def test_no_reply_before_durable_and_reported(tmp_path):
    c = small_cluster(tmp_path)
    seen = []

    class Checked(Reply):
        def send(self, value=None):
            seen.append((value.version,
                         [t.durable_version for t in c.tlogs],
                         c.master.live_committed_version))
            super().send(value)

    for i in range(3):
        rv = c.read_version()
        c.commit("p0", [set_req(KEYS[i], b"x", rv, reply=Checked())])
    assert len(seen) == 3
    assert all(min(durable) >= v and live >= v for v, durable, live in seen)
    assert c.read_version() == seen[-1][0]


def test_moves_reach_the_proxy_with_its_version(tmp_path):
    """A boundary move the balancer made rides the master's version reply
    to the proxy that commits next, which adopts it before it resolves."""
    c = StaticCluster(n_resolvers=2, proxy_ids=["p0", "p1"], n_storage=2,
                      datadir=str(tmp_path), device="cpu", capacity=1 << 10)
    rv = c.read_version()
    c.commit("p0", [set_req(b"\x15", b"a", rv)])
    v = c.master.version + 1
    c.plane.balancer.resolution_changes = [(pt.KeyRange(b"\x10", b"\x20"),
                                            1, v)]
    c.plane.balancer.resolution_changes_version = v
    for pid in ("p1", "p0"):
        c.commit(pid, [set_req(b"\x16", b"b", c.read_version())])
        proxy = c.plane.proxies[pid]
        assert proxy._resolver_changes_hwm == v
        assert proxy.key_resolvers.lookup(b"\x15")[0] == (v, 1)
    c.commit("p1", [set_req(b"\x17", b"c", c.read_version())])
    assert c.plane.balancer.resolution_changes == []
    c.close()


def test_repair_batch_takes_its_own_version(tmp_path, monkeypatch):
    knobs = server_knobs()
    monkeypatch.setattr(knobs, "SCHED_REPAIR_ENABLED", True)
    c = small_cluster(tmp_path)
    rv0 = c.read_version()
    c.commit("p0", [set_req(KEYS[0], b"w", rv0)])
    stale = set_req(KEYS[1], b"blind", rv0, reads=[KEYS[0]])
    # Repair takes a reporter whose culprit is exact (sched/repair.py).
    stale.transaction.report_conflicting_keys = True
    stale.repair_eligible = True
    versions = c.commit("p0", [stale])
    assert len(versions) == 2 and versions[0][1] == versions[1][0]
    assert stale.reply.value.version == versions[1][1]
    assert all(t.version == versions[1][1] for t in c.tlogs)
    c.pull()
    assert c.get(KEYS[1], versions[1][1]) == [b"blind", b"blind"]
    assert c.get(KEYS[1], versions[0][1]) == [b"base", b"base"]


class FailingFile(RealFile):
    fail = False

    def sync(self):
        if self.fail:
            raise OSError(5, "injected fsync failure")
        super().sync()


def test_failed_fsync_raises_with_no_reply(tmp_path):
    """A TLog whose fsync fails: commit() raises, no request of the batch
    is answered, and the master never learns the version, so no read
    version covers it; the stopped TLog then fails the GRV's confirm and
    every later commit."""
    c = small_cluster(tmp_path)
    dq = c.tlogs[1].disk_queue
    dq.file = FailingFile(dq.file._path, dq.file.name)
    rv = c.read_version()
    [(_p, v1)] = c.commit("p0", [set_req(KEYS[0], b"ok", rv)])
    dq.file.fail = True
    reqs = [set_req(KEYS[1], b"lost", v1), set_req(KEYS[2], b"lost", v1)]
    with pytest.raises(OSError, match="injected"):
        c.commit("p0", reqs)
    assert not any(r.reply.sent for r in reqs)
    assert c.master.live_committed_version == v1 < c.master.version
    assert c.tlogs[1].durable_version == v1
    c.pull()
    assert c.get(KEYS[0], v1) == [b"ok", b"ok"]
    assert c.get(KEYS[1], v1) == [b"base", b"base"]
    for call in (c.read_version,
                 lambda: c.commit("p0", [set_req(KEYS[3], b"x", v1)])):
        with pytest.raises(FdbError) as e:
            call()
        assert e.value.name == "broken_promise"


def test_reads_outside_the_window_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(server_knobs(), "MAX_READ_TRANSACTION_LIFE_VERSIONS",
                        1_000_000)
    c = small_cluster(tmp_path)
    v = []
    for i in range(4):
        rv = c.read_version()
        [(_p, ver)] = c.commit("p0", [set_req(KEYS[i], b"x", rv)])
        v.append(ver)
    for version, name in ((v[-1] + 1, "future_version"),
                          (v[0], "transaction_too_old")):
        for call in (lambda: c.get(KEYS[0], version),
                     lambda: c.get_range(b"", b"\xff", version)):
            with pytest.raises(FdbError) as e:
                call()
            assert e.value.name == name
    assert c.get(KEYS[3], v[-1]) == [b"x", b"x"]


def untouched(c, reqs, version):
    """Nothing of a refused batch happened: no reply, no version asked
    for, nothing logged."""
    assert not any(r.reply.sent for r in reqs)
    assert c.master.version == version
    assert all(t.version == version for t in c.tlogs)


def test_batch_over_the_cap_is_refused_and_cut(tmp_path):
    """A logged batch over the batcher's cap of 32,768 txns is refused
    before the master is asked for a version; StaticCluster.commit cuts
    the same requests into batches at the cap, so a versionstamp past it
    names its own batch's index, and the cluster commits on."""
    cap = COMMIT_TRANSACTION_BATCH_COUNT_MAX
    assert cap == ref_knobs().COMMIT_TRANSACTION_BATCH_COUNT_MAX == 32768
    c = StaticCluster(n_resolvers=1, proxy_ids=["p0"], n_storage=2,
                      datadir=str(tmp_path), device="cpu", backend="cpu")
    rv = c.read_version()
    n, at = cap + 7_233, cap + 7_232
    reqs = [set_req(b"a%06d" % i, b"x", rv) for i in range(n)]
    reqs[at] = CommitTransactionRequest(to(pt, (
        [], [], [(14, stamped(b"vs/", b""), b"late")], rv)), reply=Reply())
    v0 = c.master.version
    with pytest.raises(ValueError, match="32768"):
        c.plane.proxies["p0"].commit(reqs)
    untouched(c, reqs, v0)
    versions = c.commit("p0", reqs)
    assert len(versions) == 2 and versions[0][1] == versions[1][0]
    assert all(r.reply.value.version == versions[i >= cap][1] and
               r.reply.value.txn_batch_index == i % cap
               for i, r in enumerate(reqs))
    v = versions[1][1]
    c.pull()
    stamp = pt.make_versionstamp(v, at - cap)
    assert c.get_range(b"vs/", b"vs0", v) == [[(b"vs/" + stamp, b"late")]]
    [(_p, v2)] = c.commit("p0", [set_req(b"b", b"y", v)])
    c.pull()
    assert c.get(b"b", v2) == [b"y"]
    c.close()


def test_shard_team_change_is_refused(sim, tmp_path):
    """Shard moves are ported: a \\xff/keyServers/ set or clear that hands
    a key to other storage servers is no longer refused.  The same
    batches commit, and the proxy's tag messages, the disownment fences
    of the tags each change drops included, equal the reference's
    _assign_mutations_to_tags on the same batch at the same version; so
    do the shard maps after.  A server a fence reached answers
    wrong_shard_server for the span, and a new member that fetched
    nothing (a bare metadata commit, not a move) answers the same."""
    c = StaticCluster(n_resolvers=1, proxy_ids=["p0"], n_storage=4,
                      n_tlogs=2, replication=2, datadir=str(tmp_path),
                      device="cpu", capacity=1 << 10)
    proxy = c.plane.proxies["p0"]
    ref = SimCluster(n_storage=4, replication=2).commit_proxies[0]
    ref.key_servers = teams_map(
        RefRangeMap, [(b, e, list(t)) for b, e, t in
                      proxy.key_servers.ranges()])
    ks = sd.key_servers_key
    seen = []
    assign = proxy._assign_mutations_to_tags

    def recorded(batch, verdicts, version):
        out = assign(batch, verdicts, version)
        seen.append(([int(x) for x in verdicts], version, out))
        return out
    proxy._assign_mutations_to_tags = recorded

    def meta(*muts):
        return CommitTransactionRequest(to(pt, ([], [], list(muts),
                                                c.read_version())),
                                        reply=Reply())

    fences = []
    for muts in (
            # A team that loses tag 2 over [\x50, \x80) and gains 3.
            [(0, ks(b"\x50"), sd.key_servers_value([1, 3]))],
            # A boundary cleared: [\x40, \x50) joins [0, 1], tag 2 out.
            [(1, ks(b"\x40"), ks(b"\x41"))],
            # The same servers in another order, then the split merged
            # back, with a write in the same transaction.
            [(0, ks(b"\x50"), sd.key_servers_value([2, 1]))],
            [(1, ks(b"\x50"), ks(b"\x51")), (0, b"\x50", b"y")]):
        spec = ([], [], muts, 0)
        reqs = [set_req(b"\x10", b"x", c.read_version()), meta(*muts)]
        [(_p, v)] = c.commit("p0", reqs)
        assert all(r.reply.value.version == v for r in reqs)
        verdicts, version, got = seen[-1]
        assert version == v and verdicts == [2, 2]
        want = ref._assign_mutations_to_tags(
            [ri.CommitTransactionRequest(to(rt, s)) for s in (
                ([], [point(b"\x10")], [(0, b"\x10", b"x")], 0), spec)],
            [rt.CommitResult(x) for x in verdicts], v)
        assert {t: as_tuples(m) for t, m in got.items()} == \
            {t: as_tuples(m) for t, m in want.items()}
        fences.append(sorted(
            (t, m.param1[len(sd.DISOWN_SHARD_PREFIX):], m.param2)
            for t, msgs in got.items() for m in msgs
            if m.param1.startswith(sd.DISOWN_SHARD_PREFIX)))
        assert list(proxy.key_servers.ranges()) == \
            list(ref.key_servers.ranges())
    # The fences: tag 2 leaves [\x50, \x80), then [\x40, \x50); tag 3
    # leaves [\x50, \x80) when [2, 1] replaces [1, 3]; tag 2 again where
    # the split's clear merges the span it held into [0, 1].
    assert fences == [[(2, b"\x50", b"\x80")], [(2, b"\x40", b"\x50")],
                      [(3, b"\x50", b"\x80")], [(2, b"\x50", b"\x80")]]
    assert [set(t) for _b, _e, t in proxy.key_servers.ranges()] == \
        [{0, 1}, {2, 3}, {3, 0}]
    c.pull()
    ss = c.storage
    assert ask(ss[1].get_value, GetValueRequest(b"\x50", v)).value == b"y"
    for server, key in ((ss[0], b"\x50"), (ss[2], b"\x60")):
        with pytest.raises(FdbError) as e:
            ask(server.get_value, GetValueRequest(key, v))
        assert e.value.name == "wrong_shard_server"
    c.close()


def test_chip_smoke_write_path_on_cpu():
    """chip_smoke.py phase 22 at a small size on the CPU: every check of
    its main run (replies, durability, read-back on both replicas at two
    versions, counter, versionstamps, queue files, every batch's replies
    replayed through a CPU plane) and its small verdict replay against
    the oracle plane."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    _launches, figures = chip_smoke.commit_run(
        device="cpu", keyspace=20_000, txns=1_500, batches=(1, 4),
        capacity=1 << 14, delta_capacity=1 << 13)
    assert figures["committed"] > 0 and figures["conflicts"] > 0
    assert figures["counter_adds"] > 0 and figures["versionstamps"] > 0
    assert all(q["records"] >= 1 for q in figures["queues"].values())
    assert figures["cpu_replay"]["txns"] == 5 * 1_500
    replay = chip_smoke.commit_small(device="cpu")
    assert set(replay) == {"batch0", "batch1"}


def test_cluster_needs_a_card_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StaticCluster(n_resolvers=2, proxy_ids=["p0"],
                      datadir=str(tmp_path))
    StaticCluster(n_resolvers=1, proxy_ids=["p0"], device="cpu",
                  datadir=str(tmp_path), capacity=1 << 10).close()
