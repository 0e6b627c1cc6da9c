"""Data distribution in the port (foundationdb_tpu_torch/server/
data_distribution.py, policy.py, system_data.py, the commit proxy's
disownment fence and rpc/serde.py's new messages) held against the JAX
package's on the CPU, then the slice as a whole.  Tolerance 0: all of it
is bytes and integers.

  * disowned_spans and apply_key_servers_mutation on seeded shard maps
    and keyServers mutations (team sets that grow, shrink or swap,
    boundary clears): the same spans and maps;
  * BoundaryMap over seeded operation sequences: the same lookups, ends,
    boundaries and ranges;
  * policy.py's validate and select over seeded candidates, and the
    distributor's _ordered_candidates for the same healthy set, team and
    localities: the same picks;
  * the commit proxy's tag messages for batches that change teams,
    fences included, against the reference's _assign_mutations_to_tags
    (its plain and vectorised builders);
  * the frames of the data distribution messages, byte for byte;
  * a StaticCluster with the data distributor on (2 proxies, 2 TLogs, 4
    storage servers in teams of 2 over memory engines): a move, splits,
    a merge, and a storage process killed and its shards re-replicated;
    every acknowledged write read back from every replica of its final
    team, the consistency check clean, the same after
    StaticCluster.recover and a move there;
  * chip_smoke.py phase 27 at a small size.
"""

import os
import random
import sys
import tempfile

import pytest
import torch

from foundationdb_tpu.core.knobs import server_knobs as ref_knobs
from foundationdb_tpu.rpc import serde as ref_serde
from foundationdb_tpu.server import data_distribution as ref_dd
from foundationdb_tpu.server import interfaces as ref_if
from foundationdb_tpu.server import policy as ref_policy
from foundationdb_tpu.server import system_data as ref_sd
from foundationdb_tpu.server.cluster import SimCluster
from foundationdb_tpu.server.shardmap import RangeMap as RefRangeMap
from foundationdb_tpu.txn import types as rt
from foundationdb_tpu_torch.core import rng as port_rng
from foundationdb_tpu_torch.core import scheduler as port_sched
from foundationdb_tpu_torch.core.error import FdbError
from foundationdb_tpu_torch.core.knobs import server_knobs
from foundationdb_tpu_torch.rpc import serde as port_serde
from foundationdb_tpu_torch.server import data_distribution as port_dd
from foundationdb_tpu_torch.server import interfaces as port_if
from foundationdb_tpu_torch.server import policy as port_policy
from foundationdb_tpu_torch.server import system_data as port_sd
from foundationdb_tpu_torch.server.cluster import StaticCluster
from foundationdb_tpu_torch.server.commit_proxy import CommitProxy
from foundationdb_tpu_torch.server.shardmap import RangeMap
from foundationdb_tpu_torch.testing.workloads import ConsistencyCheckWorkload
from foundationdb_tpu_torch.txn import types as pt

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SHARDS = [(b"", b"\x40", [0, 1]), (b"\x40", b"\x80", [1, 2]),
          (b"\x80", b"\xc0", [2, 3]), (b"\xc0", b"\xff\xff", [3, 0])]


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    from foundationdb_tpu.core import set_event_loop
    from foundationdb_tpu.rpc.sim import set_simulator
    set_simulator(None)
    set_event_loop(None)
    port_sched.set_event_loop(None)


def teams_map(cls, triples):
    m = cls(default=None)
    for b, e, team in triples:
        m.set_range(b, e, list(team))
    return m


def key_servers_mutations(rng, n: int):
    """Seeded keyServers sets (a random team of 1-3 of 4 tags) and
    boundary clears, as (type, p1, p2)."""
    out = []
    for _ in range(n):
        k = bytes([rng.randrange(256)])
        if rng.random() < 0.65:
            team = rng.sample(range(4), rng.randrange(1, 4))
            out.append((0, port_sd.key_servers_key(k),
                        port_sd.key_servers_value(team)))
        else:
            k2 = bytes([rng.randrange(256)])
            a, b = sorted((k, k2))
            out.append((1, port_sd.key_servers_key(a),
                        port_sd.key_servers_key(b)))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_disowned_spans_and_map_match_reference(seed):
    rng = random.Random(seed)
    port, ref = teams_map(RangeMap, SHARDS), teams_map(RefRangeMap, SHARDS)
    fenced = 0
    for typ, a, b in key_servers_mutations(rng, 80):
        pm = pt.Mutation(pt.MutationType(typ), a, b)
        rm = rt.Mutation(rt.MutationType(typ), a, b)
        got = port_sd.disowned_spans(port, pm)
        assert got == ref_sd.disowned_spans(ref, rm)
        fenced += len(got)
        assert port_sd.apply_key_servers_mutation(port, pm) == \
            ref_sd.apply_metadata_mutation(ref, rm)[0]
        assert list(port.ranges()) == list(ref.ranges())
    assert fenced > 0
    assert port_sd.disowned_spans(port, pt.Mutation.set_value(
        b"\xff/other", b"x")) == []
    for tag in (0, 7, 123456):
        assert port_sd.server_tag_key(tag) == ref_sd.server_tag_key(tag)
        assert port_sd.excluded_key(tag) == ref_sd.excluded_key(tag)
    assert port_sd.DISOWN_SHARD_PREFIX == ref_sd.DISOWN_SHARD_PREFIX


@pytest.mark.parametrize("seed", [4, 5])
def test_boundary_map_matches_reference(seed):
    rng = random.Random(seed)
    port, ref = port_dd.BoundaryMap(), ref_dd.BoundaryMap()
    for _ in range(300):
        k = bytes([rng.randrange(64)])
        r = rng.random()
        if r < 0.45:
            team = rng.sample(range(5), 2)
            port.set_boundary(k, list(team))
            ref.set_boundary(k, list(team))
        elif r < 0.7:
            port.remove_boundary(k)
            ref.remove_boundary(k)
        assert port.lookup(k) == ref.lookup(k)
        assert port.shard_end(k) == ref.shard_end(k)
        assert port.is_boundary(k) == ref.is_boundary(k)
        assert list(port.ranges()) == list(ref.ranges())
        assert len(port) == len(ref)


def candidates(rng, n: int):
    """Seeded (id, locality) candidates over a few zones and halls, some
    with the attribute unset."""
    out = []
    for i in range(n):
        loc = {"dcid": "dc%d" % rng.randrange(2),
               "machineid": "m%d" % rng.randrange(6)}
        if rng.random() < 0.8:
            loc["zoneid"] = "z%d" % rng.randrange(4)
        if rng.random() < 0.7:
            loc["data_hall"] = "h%d" % rng.randrange(3)
        out.append((i, loc))
    return out


@pytest.mark.parametrize("seed", [6, 7, 8])
def test_policy_selections_match_reference(seed):
    rng = random.Random(seed)
    for pol in (ref_policy, port_policy):
        assert pol.policy_from_config(1).name() == "One"
    made = []
    for mod in (ref_policy, port_policy):
        made.append([mod.PolicyOne(), mod.PolicyAcross(2, "zoneid"),
                     mod.PolicyAcross(3, "zoneid", mod.PolicyOne()),
                     mod.PolicyAnd(mod.PolicyAcross(2, "zoneid"),
                                   mod.PolicyAcross(2, "data_hall")),
                     mod.three_data_hall(), mod.policy_from_config(3)])
    picked = 0
    for _ in range(40):
        cands = candidates(rng, rng.randrange(0, 9))
        team = rng.sample(cands, min(len(cands), rng.randrange(1, 4)))
        for r, p in zip(*made):
            assert p.name() == r.name()
            assert p.n_required() == r.n_required()
            assert p.validate(team) == r.validate(team)
            got = p.select(cands)
            assert got == r.select(cands)
            picked += got is not None
    assert picked > 0


class _Iface:
    """A storage interface's locality alone (what _candidate reads)."""

    def __init__(self, locality):
        self.locality = locality


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_ordered_candidates_match_reference(seed):
    rng = random.Random(seed)
    for _ in range(30):
        n = rng.randrange(3, 9)
        ifaces = {t: _Iface((f"dc{rng.randrange(2)}",
                             rng.choice(["", "z1", "z2", "z3"]),
                             f"m{rng.randrange(5)}")) for t in range(n)}
        replication = rng.randrange(1, 4)
        ranges = [(b"", b"\xff\xff", list(range(replication)))]
        ref = ref_dd.DataDistributor("dd", None, ifaces, ranges, replication)
        port = port_dd.DataDistributor("dd", None, ifaces, ranges,
                                       replication)
        dead = rng.sample(range(n), rng.randrange(0, 2))
        for d in (ref, port):
            d.healthy -= set(dead)
        team = rng.sample(range(n), min(n, replication))
        kept = [t for t in team if t not in dead]
        assert port._ordered_candidates(kept, team) == \
            ref._ordered_candidates(kept, team)
        for t in range(n):
            assert port._candidate(t) == ref._candidate(t)


def stamped(prefix: bytes) -> bytes:
    return prefix + b"\x00" * 10 + len(prefix).to_bytes(4, "little")


def team_change_specs(seed: int, n: int = 50):
    """Seeded transactions whose mutations change teams (sets that
    shrink, swap or grow a shard's team, boundary clears) among writes,
    clears across shards and versionstamped keys; seeded verdicts."""
    rng = random.Random(seed)
    ks = key_servers_mutations(rng, n)
    specs, verdicts = [], []
    for t in range(n):
        muts = []
        for _ in range(rng.randrange(1, 5)):
            r = rng.random()
            k = bytes([rng.randrange(0xf0)]) + b"/%d" % rng.randrange(50)
            if r < 0.35:
                muts.append((0, k, b"v%d" % t))
            elif r < 0.5:
                a = bytes([rng.randrange(0xf0)])
                muts.append((1, min(a, k), max(a, k) + b"\x00"))
            elif r < 0.6:
                muts.append((14, stamped(b"vs/"), b"x"))
            else:
                muts.append(ks[t])
        specs.append(muts)
        verdicts.append(rng.choice([0, 1, 2, 2, 2]))
    return specs, verdicts


@pytest.mark.parametrize("vec", [False, True])
@pytest.mark.parametrize("seed", [12, 13])
def test_fences_match_reference(sim, monkeypatch, seed, vec):
    monkeypatch.setattr(ref_knobs(), "PROXY_VECTORIZED_ASSEMBLY", vec)
    ref = SimCluster(n_storage=4, replication=2).commit_proxies[0]
    ref.key_servers = teams_map(RefRangeMap, SHARDS)
    port = CommitProxy("p0", [None], [(b"", b"\xff\xff", 0)],
                       key_servers=teams_map(RangeMap, SHARDS))
    specs, verdicts = team_change_specs(seed)

    def txn(types, muts):
        return types.CommitTransactionRef(mutations=[
            types.Mutation(types.MutationType(t), a, b) for t, a, b in muts])
    version = 2_000_011 + seed
    want = ref._assign_mutations_to_tags(
        [ref_if.CommitTransactionRequest(txn(rt, s)) for s in specs],
        [rt.CommitResult(v) for v in verdicts], version)
    got = port._assign_mutations_to_tags(
        [port_if.CommitTransactionRequest(txn(pt, s)) for s in specs],
        [pt.CommitResult(v) for v in verdicts], version)

    def plain(msgs):
        return {t: [(int(m.type), m.param1, m.param2) for m in ms]
                for t, ms in msgs.items()}
    assert plain(got) == plain(want)
    fences = [m for ms in got.values() for m in ms
              if m.param1.startswith(port_sd.DISOWN_SHARD_PREFIX)]
    assert fences
    assert list(port.key_servers.ranges()) == list(ref.key_servers.ranges())


@pytest.fixture()
def sim():
    from foundationdb_tpu.core import (DeterministicRandom,
                                       set_deterministic_random)
    set_deterministic_random(DeterministicRandom(7))
    yield


def test_data_distribution_frames_equal_the_reference():
    ref_serde.bootstrap_registry()
    port_serde.bootstrap_registry()
    ssis = {}
    for name, mod in (("ref", ref_if), ("port", port_if)):
        ssis[name] = mod.StorageServerInterface("ss3", 3)
    for name, mod in (("ref", ref_if), ("port", port_if)):
        msgs = [mod.FetchKeysRequest(begin=b"a", end=b"b", sources=[],
                                     min_version=77),
                mod.FetchShardRequest(begin=b"a", end=b"\xff",
                                      min_version=1 << 40),
                mod.FetchShardReply(data=[(b"a", b"1"), (b"b", b"")],
                                    version=12),
                mod.GetShardMetricsRequest(begin=b"", end=b"\xff\xff",
                                           split_threshold=1 << 20),
                mod.RemoveShardRequest(begin=b"k", end=b"l"),
                mod.DataDistributorInterface("dd")]
        ssis[name + "_msgs"] = msgs
    for r, p in zip(ssis["ref_msgs"], ssis["port_msgs"]):
        if isinstance(r, ref_if.DataDistributorInterface):
            continue                     # streams unregistered: checked below
        assert port_serde.encode_message(p) == ref_serde.encode_message(r)
        back = ref_serde.decode_message(port_serde.encode_message(p))
        assert type(back).__name__ == type(r).__name__
    # The port's storage interface carries the reference's data
    # distribution streams under the same names, in the same order.
    ref_names = [k for k in vars(ssis["ref"])]
    port_names = [k for k in vars(ssis["port"])]
    assert [k for k in ref_names if k in port_names] == port_names
    for k in ("fetch_keys", "fetch_shard", "shard_metrics", "remove_shard",
              "locality"):
        assert k in port_names


# ------------------------------------------------------------ the slice
KEYS = [b"k%05d" % i for i in range(400)]


def dd_cluster(datadir, loop):
    return StaticCluster(2, ["p0", "p1"], n_storage=4, n_tlogs=2,
                         replication=2, datadir=datadir, device="cpu",
                         clock=loop.now, data_distribution=True,
                         storage_boundaries=[b"k00100", b"k00200",
                                             b"k00300"],
                         storage_engine="memory", capacity=1 << 12,
                         delta_capacity=1 << 10)


async def committed(db, fn) -> None:
    t = db.create_transaction()
    while True:
        try:
            fn(t)
            await t.commit()
            return
        except FdbError as e:
            await t.on_error(e)


def read_back(c, model, version) -> int:
    """Every key of the model (and no other) from every replica of its
    final team, at `version`."""
    from foundationdb_tpu_torch.server.interfaces import (
        GetKeyValuesRequest, ask)
    n = 0
    proxy = c.plane.proxies["p0"]
    for b, e, team in proxy.key_servers.intersecting(b"", b"\xff"):
        want = [(k, v) for k, v in sorted(model.items()) if b <= k < e]
        for tag in team:
            rows = ask(c.storage[tag].get_key_values, GetKeyValuesRequest(
                b, e, version, limit=1 << 30, limit_bytes=1 << 40)).data
            assert rows == want, (b, e, tag)
            n += len(rows)
    return n


def stop(c, loop) -> None:
    """Kill every process of a started cluster (its actors end, their
    held replies break while the loop still runs)."""
    for proc in list(c.processes.values()):
        c.sim.kill_process(proc)
    loop.run_until(port_sched.delay(0.01))


def test_cluster_moves_splits_merges_and_rereplicates():
    knobs = server_knobs()
    saved = (knobs.DD_SHARD_SPLIT_BYTES, knobs.DD_SHARD_MERGE_BYTES)
    knobs.DD_SHARD_SPLIT_BYTES, knobs.DD_SHARD_MERGE_BYTES = 2000, 800
    port_rng.set_deterministic_random(port_rng.DeterministicRandom(7))
    rng = random.Random(23)
    datadir = tempfile.mkdtemp(prefix="dd_slice_")
    try:
        loop = port_sched.EventLoop()
        c = dd_cluster(datadir, loop)
        c.load(KEYS, [b"v" * 20] * len(KEYS))
        c.start(loop)
        db = c.database()
        model = dict.fromkeys(KEYS, b"v" * 20)

        async def put(k, v):
            await committed(db, lambda t: t.set(k, v))
            model[k] = v

        async def drive():
            dd = c.dd
            await dd.move_shard(b"k00300", b"\xff\xff", [3, 2])
            for i in range(40):
                await put(rng.choice(KEYS), b"w%03d" % i * 5)
            while dd.stats["splits"] < 3:
                await port_sched.delay(0.5)
            c.kill_process("ss1")
            for i in range(40):
                await put(rng.choice(KEYS), b"x%03d" % i * 5)
            while dd.moves_in_flight or any(
                    1 in team for _b, _e, team in dd.map.ranges()):
                await port_sched.delay(0.5)
            await committed(db, lambda t: t.clear(b"k00000", b"k00100"))
            for k in [k for k in model if k < b"k00100"]:
                del model[k]
            while dd.stats["merges"] < 1:
                await port_sched.delay(0.5)
            w = ConsistencyCheckWorkload(c, db, {})
            assert await w.check()
            return dict(dd.stats), w.metrics
        stats, audit = c.run_until(loop.spawn(drive()), timeout=300)
        assert stats["moves"] >= 2 and stats["rereplications"] >= 2
        assert stats["splits"] >= 3 and stats["merges"] >= 1
        assert audit["shards_audited"] >= 3
        teams = [t for _b, _e, t in c.plane.proxies["p0"].key_servers.ranges()]
        assert all(len(t) == 2 and 1 not in t for t in teams)
        assert teams == [t for _b, _e, t in
                         c.plane.proxies["p1"].key_servers.ranges()]
        top = c.read_version()
        live = [ss for ss in c.storage if ss.id != "ss1"]
        for ss in live:
            ss.pull()
        assert read_back(c, model, top) == 2 * len(model)
        for ss in live:
            ss.update_storage()
        before = list(c.plane.proxies["p0"].key_servers.ranges())
        stop(c, loop)
        end = loop.now()
        c.kill()

        # The moved teams come back from the core state and the TXS_TAG
        # replay; every replica reads back and a move runs there.
        loop2 = port_sched.EventLoop(start_time=end)
        c2 = StaticCluster.recover(
            datadir, ["p0", "p1"], device="cpu", clock=loop2.now,
            data_distribution=True, capacity=1 << 12, delta_capacity=1 << 10)
        assert list(c2.key_servers.ranges()) == before
        assert read_back(c2, model, c2.read_version()) == 2 * len(model)
        c2.start(loop2)
        db2 = c2.database()

        async def after():
            await c2.dd.move_shard(b"", b"k00100", [0, 1])
            await committed(db2, lambda t: t.set(b"k00001", b"back"))
            model[b"k00001"] = b"back"
            w = ConsistencyCheckWorkload(c2, db2, {})
            assert await w.check()
            t = db2.create_transaction()
            while True:
                try:
                    return dict(await t.get_range(b"", b"\xff",
                                                  limit=1 << 20))
                except FdbError as e:
                    await t.on_error(e)
        assert c2.run_until(loop2.spawn(after()), timeout=300) == model
        stop(c2, loop2)
        c2.close()
    finally:
        knobs.DD_SHARD_SPLIT_BYTES, knobs.DD_SHARD_MERGE_BYTES = saved
        import shutil
        shutil.rmtree(datadir, ignore_errors=True)


def test_chip_smoke_shard_moves_on_cpu():
    """chip_smoke.py phase 27 at a small size: every check of the phase
    (read-back from every replica of the final teams, the consistency
    check, two healthy replicas a shard and the dead tag in no team, the
    vacated replicas' fences, failovers and wrong_shard_server answers
    counted, one reply a commit, the CPU plane's replay)."""
    import chip_smoke
    fig = chip_smoke.dd_run(device="cpu", keyspace=4_000, rw_actors=64,
                            rw_txns=5, rw_warmup=1, rw_before=1,
                            split_bytes=40_000, capacity=1 << 12,
                            delta_capacity=1 << 10)
    assert fig["before"]["committed"] == 64
    assert fig["during"]["committed"] == 3 * 64
    assert fig["move"]["fetch_rows"] >= 1_000 and fig["fence_checks"] > 0
    assert fig["splits"] > 0 and fig["rereplications"] >= 2
    assert fig["read_failovers"] > 0 and \
        fig["wrong_shard_server_replies"] > 0
    assert fig["consistency"]["shards_audited"] >= 4
    assert fig["readback_rows"] == 2 * 4_000
