"""The port's resolution plane held against the JAX package's.

The reference's plane is the commit proxy's resolution stage
(foundationdb_tpu/server/commit_proxy.py), the master's resolver
boundaries and resolution_balancing (server/master.py) and the resolver
wiring of SimCluster (server/cluster.py); the port's is
foundationdb_tpu_torch/server/{shardmap,commit_proxy,master,cluster}.py.
Each case feeds both the same seeded inputs, built once as plain data and
then in each package's types, with tolerance 0 (everything is bytes,
ints and enums):

  (a) RangeMap under random set_range / intersecting / ranges / lookup
      sequences: the same answers and the same bounds and values;
  (b) the resolution requests: the port's one builder against each of
      the reference's two (PROXY_VECTORIZED_ASSEMBLY off and on, which
      give the same requests); the
      reference proxy of SimCluster(n_resolvers=N), its ownership map
      carried across as (begin, end, history) triples, before and after
      boundary moves that trim at the floor; straddling ranges, \\xff
      state txns, a ClearRange across \\xff, empty ranges, txns with no
      ranges, reporters, tenants and tags; every request field for field
      and the index maps;
  (c) the reply merge over synthesised replies: _determine_committed,
      the foreign-state AND with its high-water mark (the reference's
      _apply_foreign_state, its _apply_metadata recording), and the
      reporters' range union and exactness AND (the reference computes
      these inline in _commit_batch_impl, :430-450: held against a
      transcription of those lines);
  (d) seed_resolver_boundaries (equi-depth, and its static byte splits
      on maps too coarse to cut N ways), _valid_resolver_ranges and
      _key_resolver_ranges;
  (e) the balancer step against the reference's resolution_balancing
      loop, run on the simulator against fake resolvers that answer the
      same loads and split keys as the port's fakes; the changes each
      proxy is handed against the reference master's version replies;
  (f) the whole plane over port roles on device="cpu" (the supervised
      TorchConflictSet, capacity 2^10): on the reference's aligned parity
      stream its verdicts equal _resolve_stream(N)'s for N = 1, 2, 4; on
      chip_smoke's straddling stream, with a boundary move after wave 5
      and old-snapshot reads across it, they equal the reference plane's
      (SimCluster's proxies and oracle resolvers, the same move handed
      to its proxies) batch for batch; and chip_smoke's small exact case
      (the plane against one over the port's oracle) on the CPU.

One torch thread, as tests/test_torch_cluster.py runs the port.
"""

import os
import random
import sys
import zlib

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from foundationdb_tpu.core.futures import wait_all
from foundationdb_tpu.core.knobs import server_knobs as ref_knobs
from foundationdb_tpu.rpc.endpoint import RequestStream
from foundationdb_tpu.server import master as ref_master
from foundationdb_tpu.server.cluster import SimCluster
from foundationdb_tpu.server.interfaces import (
    GetCommitVersionRequest, ResolverInterface,
    ResolveTransactionBatchReply as RefReply)
from foundationdb_tpu.server.shardmap import RangeMap as RefRangeMap
from foundationdb_tpu.txn import types as rt
from foundationdb_tpu_torch.core.knobs import server_knobs
from foundationdb_tpu_torch.server import master as port_master
from foundationdb_tpu_torch.server.cluster import ResolutionPlane
from foundationdb_tpu_torch.server.commit_proxy import CommitProxy
from foundationdb_tpu_torch.server.interfaces import (
    RESOLVER_ALL, ResolveTransactionBatchReply as PortReply)
from foundationdb_tpu_torch.server.shardmap import RangeMap
from foundationdb_tpu_torch.txn import types as pt

from test_resolution_plane import _parity_stream, _reqs, _resolve_stream

NS = [1, 2, 4]
LIFE = 3_000      # a lowered MAX_WRITE_TRANSACTION_LIFE_VERSIONS


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def knobs():
    """Both packages' server knobs, set together (or the reference's
    alone) and restored after."""
    regs = [ref_knobs(), server_knobs()]
    saved = [dict(k.__dict__) for k in regs]

    class Both:
        @staticmethod
        def set(name, value):
            for k in regs:
                setattr(k, name, value)

        @staticmethod
        def ref(name, value):
            setattr(regs[0], name, value)

    yield Both
    for k, s in zip(regs, saved):
        for name, value in s.items():
            setattr(k, name, value)


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


# ------------------------------------------------------------ conversions
def ref_txn(t):
    return rt.CommitTransactionRef(
        read_conflict_ranges=[rt.KeyRange(r.begin, r.end)
                              for r in t.read_conflict_ranges],
        write_conflict_ranges=[rt.KeyRange(r.begin, r.end)
                               for r in t.write_conflict_ranges],
        mutations=[rt.Mutation(rt.MutationType(int(m.type)), m.param1,
                               m.param2) for m in t.mutations],
        read_snapshot=t.read_snapshot,
        report_conflicting_keys=t.report_conflicting_keys,
        tenant_id=t.tenant_id, tag=t.tag)


def txn_fields(t) -> tuple:
    return ([(r.begin, r.end) for r in t.read_conflict_ranges],
            [(r.begin, r.end) for r in t.write_conflict_ranges],
            [(int(m.type), m.param1, m.param2) for m in t.mutations],
            t.read_snapshot, t.report_conflicting_keys, t.tenant_id, t.tag)


def request_fields(req) -> tuple:
    return (req.prev_version, req.version, req.last_received_version,
            req.proxy_id, list(req.txn_state_transactions),
            [txn_fields(t) for t in req.transactions])


def change_pair(b, e, idx, v):
    return ((rt.KeyRange(b, e), idx, v), (pt.KeyRange(b, e), idx, v))


# ------------------------------------------------------------ (a) RangeMap
KEYS = [b"", b"\x10", b"\x40", b"\x40\x00", b"\x7f", b"\x80", b"\x80a",
        b"\xaa", b"\xc0", b"\xfe", b"\xff", b"\xff/x", b"\xff\xff"]


@pytest.mark.parametrize("seed", range(4))
def test_range_map_matches_reference(seed):
    rng = random.Random(seed)
    ref, port = RefRangeMap(default=0), RangeMap(default=0)
    for step in range(300):
        b, e = rng.choice(KEYS), rng.choice(KEYS)
        op = rng.randrange(5)
        if op < 2:
            v = rng.choice([0, 1, 2, ((5, 1), (0, 0))])
            ref.set_range(b, e, v)
            port.set_range(b, e, v)
        elif op == 2:
            assert list(ref.intersecting(b, e)) == \
                list(port.intersecting(b, e))
        elif op == 3:
            assert ref.lookup(b) == port.lookup(b)
            assert ref.range_containing(b) == port.range_containing(b)
            assert ref.range_before(e) == port.range_before(e)
        else:
            assert list(ref.ranges()) == list(port.ranges())
            assert len(ref) == len(port)
        assert (ref._bounds, ref._values) == (port._bounds, port._values)
    copy = port.copy()
    copy.set_range(b"\x01", b"\x02", 9)
    assert list(ref.ranges()) == list(port.ranges())


# ----------------------------------------------------- (b) the requests
def txn_specs(seed: int, n: int = 80) -> list:
    """Seeded txns as plain data: ranges over KEYS and random 1-2 byte
    keys (straddling every boundary, some empty), state txns, a
    ClearRange across \\xff, user mutations, no-range txns, reporters,
    tenants and tags."""
    rng = random.Random(seed)

    def key():
        if rng.random() < 0.4:
            return rng.choice(KEYS[:-1])
        return bytes(rng.randrange(256) for _ in range(rng.randint(1, 2)))

    def rng_range():
        a, b = key(), key()
        return (min(a, b), max(a, b))

    out = []
    for i in range(n):
        kind = rng.random()
        reads = [rng_range() for _ in range(rng.randrange(3))]
        writes = [rng_range() for _ in range(rng.randrange(3))]
        muts = []
        if kind < 0.1:
            reads, writes = [], []
        elif kind < 0.2:
            k = b"\xff/conf/%d" % i
            muts = [(int(rt.MutationType.SetValue), k, b"v")]
        elif kind < 0.25:
            muts = [(int(rt.MutationType.ClearRange), b"\xf0", b"\xff/a")]
            writes.append((b"\xf0", b"\xff/a"))
        elif kind < 0.5:
            k = key()
            muts = [(int(rt.MutationType.SetValue), k, b"x"),
                    (int(rt.MutationType.ClearRange), b"a", b"b")]
        out.append({"reads": reads, "writes": writes, "muts": muts,
                    "snap": rng.randrange(20_000),
                    "report": rng.random() < 0.3,
                    "tenant": rng.randrange(-1, 3),
                    "tag": rng.choice(["", "t/a", "t/b"])})
    return out


def port_txn(s):
    return pt.CommitTransactionRef(
        read_conflict_ranges=[pt.KeyRange(b, e) for b, e in s["reads"]],
        write_conflict_ranges=[pt.KeyRange(b, e) for b, e in s["writes"]],
        mutations=[pt.Mutation(pt.MutationType(t), a, b)
                   for t, a, b in s["muts"]],
        read_snapshot=s["snap"], report_conflicting_keys=s["report"],
        tenant_id=s["tenant"], tag=s["tag"])


def moves(n: int) -> list:
    """Boundary moves (reference-typed, port-typed) in three deliveries:
    overlapping ranges, an unsorted list, a repeated version, and
    versions far enough apart that LIFE trims the histories."""
    if n == 1:
        return [[change_pair(b"\x20", b"\x60", 0, 1_000)]]
    last = n - 1
    return [
        [change_pair(b"\x20", b"\x60", last, 1_000),
         change_pair(b"\x30", b"\x90", 0, 2_500)],
        [change_pair(b"\x50", b"\xa0", 1 % n, 8_000),
         change_pair(b"\x00", b"\x25", last, 4_000),
         change_pair(b"\x51", b"\x52", 0, 4_000)],
        [change_pair(b"\x10", b"\xfe", 0, 12_000),
         change_pair(b"\x28", b"\x29", last, 12_500)]]


@pytest.mark.parametrize("history", ["fresh", "moved"])
@pytest.mark.parametrize("vec", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_resolution_requests_match_reference(knobs, sim, n, vec, history):
    knobs.ref("PROXY_VECTORIZED_ASSEMBLY", vec)
    knobs.set("MAX_WRITE_TRANSACTION_LIFE_VERSIONS", LIFE)
    ref = SimCluster(n_resolvers=n).commit_proxies[0]
    port = CommitProxy(ref.id, [None] * n, list(ref.key_resolvers.ranges()))
    # The recruitment shape: a RangeMap of resolver indices.
    ints = RangeMap(default=0)
    for b, e, idx in port_master._key_resolver_ranges(n):
        ints.set_range(b, e, idx)
    assert list(CommitProxy("p", [None] * n, ints).key_resolvers.ranges()) \
        == list(ref.key_resolvers.ranges())
    specs = txn_specs(7 * n + vec)
    rtx = [ref_txn(port_txn(s)) for s in specs]
    ptx = [port_txn(s) for s in specs]
    deliveries = moves(n) if history == "moved" else [[]]
    for delivery in deliveries:
        if delivery:
            ref._apply_resolver_changes([c[0] for c in delivery])
            port._apply_resolver_changes([c[1] for c in delivery])
        assert list(port.key_resolvers.ranges()) == \
            list(ref.key_resolvers.ranges())
        assert port._resolver_changes_hwm == ref._resolver_changes_hwm
        for version in (3_500, 9_000, 13_000, 20_000):
            ref.last_resolved_version = port.last_resolved_version = \
                version - 1_000
            _b, want, want_maps = _reqs(ref, rtx, version - 500, version)
            got, got_maps = port._build_resolution_requests(
                ptx, version - 500, version)
            assert got_maps == want_maps
            assert [request_fields(r) for r in got] == \
                [request_fields(r) for r in want]


# ------------------------------------------------------ (c) reply merging
def ref_merge_conflicts(index_maps, resolutions):
    """commit_proxy.py:430-450, transcribed (inline in the reference's
    _commit_batch_impl)."""
    conflict_ranges = {}
    for r_idx, reply in enumerate(resolutions):
        for local_i, ranges in getattr(reply, "conflicting_ranges",
                                       {}).items():
            if local_i < len(index_maps[r_idx]):
                t_idx = index_maps[r_idx][local_i]
                conflict_ranges.setdefault(t_idx, []).extend(ranges)
    conflict_exact = {}
    for r_idx, reply in enumerate(resolutions):
        for local_i, exact in getattr(reply, "attribution_exact",
                                      {}).items():
            if local_i < len(index_maps[r_idx]):
                t_idx = index_maps[r_idx][local_i]
                conflict_exact[t_idx] = \
                    conflict_exact.get(t_idx, True) and bool(exact)
    return conflict_ranges, conflict_exact


@pytest.mark.parametrize("seed", range(4))
def test_reply_merge_matches_reference(sim, seed):
    rng = random.Random(seed)
    n, n_txns = 3, 24
    ref = SimCluster(n_resolvers=n).commit_proxies[0]
    port = CommitProxy(ref.id, [None] * n, list(ref.key_resolvers.ranges()))
    applied = []
    ref._apply_metadata = lambda m: applied.append(m.param1)
    origins = [ref.id, "proxy1", "proxy2"]
    pool = [(1_000 * rng.randrange(1, 12), rng.choice(origins),
             rng.randrange(3)) for _ in range(40)]
    for round_ in range(6):
        index_maps = [[] for _ in range(n)]
        for t in range(n_txns):
            for r in rng.sample(range(n), rng.randint(1, n)):
                index_maps[r].append(t)
        replies = []
        for r in range(n):
            k = len(index_maps[r])
            committed = [rng.choice(list(rt.CommitResult)) for _ in range(k)]
            state = []
            for key in rng.sample(pool, rng.randrange(8)):
                state.append((*key, [rt.Mutation(
                    rt.MutationType.SetValue, b"\xff/e/%d/%s/%d" % (
                        key[0], key[1].encode(), key[2]), b"")],
                    rng.choice(list(rt.CommitResult))))
            ranges = {i: [(b"r%d" % r, b"s%d" % i)]
                      for i in rng.sample(range(k + 2), min(k + 2, 3))}
            exact = {i: rng.random() < 0.7
                     for i in rng.sample(range(k + 2), min(k + 2, 4))}
            replies.append((committed, state, ranges, exact))
        ref_res = [RefReply(committed=c, state_transactions=s,
                            conflicting_ranges=g, attribution_exact=x)
                   for c, s, g, x in replies]
        port_res = [PortReply(
            committed=[pt.CommitResult(int(v)) for v in c],
            state_transactions=[(*e[:4], pt.CommitResult(int(e[4])))
                                for e in s],
            conflicting_ranges=g, attribution_exact=x)
            for c, s, g, x in replies]
        batch = [None] * n_txns
        assert [int(v) for v in port._determine_committed(
            batch, index_maps, port_res)] == [int(v) for v in
                                              ref._determine_committed(
                                                  batch, index_maps,
                                                  ref_res)]
        del applied[:]
        got = port._apply_foreign_state(port_res)
        ref._apply_foreign_state(ref_res)
        assert [m.param1 for e in got for m in e[3]] == applied
        assert all(e[4] == pt.CommitResult.COMMITTED and e[1] != port.id
                   for e in got)
        assert port._state_hwm == ref._state_hwm
        assert port._merge_conflicts(index_maps, port_res) == \
            ref_merge_conflicts(index_maps, ref_res)


# --------------------------------------------------------- (d) boundaries
SHARD_MAPS = {
    "prefix": [(b"", b"k1", [0])] + [(b"k%d" % i, b"k%d" % (i + 1), [0])
                                     for i in range(1, 8)],
    "coarse": [(b"", b"\xff", [0])],
    "even_ids": [(b, e, [0]) for b, e in zip(
        [b""] + [b"k%014d" % (62_500 * i) for i in range(1, 16)],
        [b"k%014d" % (62_500 * i) for i in range(1, 16)] + [b"\xff"])],
    "with_system": [(b"", b"a", [0]), (b"a", b"b", [1]), (b"b", b"\xff", [0]),
                    (b"\xff", b"\xff/z", [1]), (b"\xff/z", b"\xff\xff", [0])],
}


@pytest.mark.parametrize("n", range(1, 7))
@pytest.mark.parametrize("shards", sorted(SHARD_MAPS))
def test_boundaries_match_reference(shards, n):
    shard_map = SHARD_MAPS[shards]
    cuts = port_master.seed_resolver_boundaries(shard_map, n)
    assert cuts == ref_master.seed_resolver_boundaries(shard_map, n)
    if shards == "coarse" and n > 1:
        assert cuts == port_master._split_points(n)
    for args in ((n,), (n, None, cuts), (n, [(b"", b"\xff", 0)])):
        assert port_master._key_resolver_ranges(*args) == \
            ref_master._key_resolver_ranges(*args)
    user = port_master._key_resolver_ranges(n, boundaries=cuts)[:-1]
    bad = [user[:-1], user[1:], [(b, e, i + 1) for b, e, i in user],
           user + [(b"\xff", b"\xff\xff", 0)], [],
           [(b"", b"\xff", 0)] * 2]
    for ranges in [user] + bad:
        for m in (n - 1, n, n + 1):
            assert port_master._valid_resolver_ranges(ranges, m) == \
                ref_master._valid_resolver_ranges(ranges, m)
    assert port_master._split_points(5) == ref_master._split_points(5)
    assert RESOLVER_ALL == ref_master.RESOLVER_ALL


# ------------------------------------------------------- (e) the balancer
class Answers:
    """The loads and split keys both packages' fakes answer: a seeded
    script of loads a step, and a split key for (step, resolver, begin,
    end) drawn from a crc of its arguments (inside the range, at its
    begin, past its end, or none)."""

    def __init__(self, n: int, seed: int) -> None:
        rng = random.Random(seed)
        self.steps = []
        for _ in range(14):
            kind = rng.random()
            if kind < 0.15:
                loads = [rng.randrange(40) for _ in range(n)]   # min load
            elif kind < 0.3:
                loads = [100 + rng.randrange(40) for _ in range(n)]
            else:
                loads = [rng.choice([0, 10, 60, 500, 2_000])
                         for _ in range(n)]
            self.steps.append((rng.choice([0, 0, 1_000, 5_000]), loads))
        self.step = 0

    def split(self, r: int, begin: bytes, end: bytes):
        h = zlib.crc32(b"%d|%d|" % (self.step, r) + begin + b"|" + end)
        kind = h % 5
        if kind == 0:
            return None
        if kind == 1:
            return begin
        if kind == 2:
            return end + b"\x01"
        return begin + bytes([h >> 8 & 0xff])


class PortFake:
    def __init__(self, answers: Answers, r: int) -> None:
        self.answers, self.r, self.load = answers, r, 0

    def serve_metrics(self, req):
        req.reply.send(self.load)

    def serve_split(self, req):
        req.reply.send(self.answers.split(self.r, req.begin, req.end))


class RefFake:
    """A resolver of the reference's simulator answering the metrics and
    split streams from the script."""

    def __init__(self, sim_, answers: Answers, r: int) -> None:
        self.answers, self.r, self.load, self.polls = answers, r, 0, 0
        self.interface = ResolverInterface(f"fake{r}")
        proc = sim_.new_process(name=f"fake{r}")
        for s in self.interface.streams():
            proc.register(s)
        proc.spawn(self._metrics(), "metrics")
        proc.spawn(self._split(), "split")

    async def _metrics(self):
        async for req in self.interface.metrics.queue:
            self.polls += 1
            req.reply.send(self.load)

    async def _split(self):
        async for req in self.interface.split.queue:
            req.reply.send(self.answers.split(self.r, req.begin, req.end))


class LogReply:
    def __init__(self):
        self.value = None

    def send(self, value):
        self.value = value


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_balancer_matches_reference(knobs, sim, n, seed):
    from foundationdb_tpu.core.scheduler import EventLoop, set_event_loop
    from foundationdb_tpu.rpc.sim import Simulator, set_simulator
    loop = EventLoop(sim=True)
    set_event_loop(loop)
    sim_ = Simulator()
    set_simulator(sim_)
    interval = float(ref_knobs().RESOLUTION_BALANCING_INTERVAL)
    answers = Answers(n, seed)
    ref_fakes = [RefFake(sim_, answers, r) for r in range(n)]
    port_fakes = [PortFake(answers, r) for r in range(n)]
    master = ref_master.Master()
    proxies = ["proxy0", "proxy1", "proxy2"][:1 + seed]
    master.expected_proxies = list(proxies) if seed else []
    loop.spawn(ref_master.resolution_balancing(
        master, [f.interface for f in ref_fakes],
        ref_master._key_resolver_ranges(n)))
    bal = port_master.ResolutionBalancer(
        port_master._key_resolver_ranges(n),
        expected_proxies=proxies if seed else ())
    rng = random.Random(seed)
    version, request_num = 0, {p: 0 for p in proxies}
    moved = 0
    for step, (advance, loads) in enumerate(answers.steps):
        version += advance
        master.version = version
        answers.step = step
        for f, load in zip(ref_fakes + port_fakes, loads + loads):
            f.load = load
        polls = sum(f.polls for f in ref_fakes)
        while sum(f.polls for f in ref_fakes) < polls + n:
            loop.run_for(interval / 50)
        loop.run_for(interval / 2)      # the loop body's split requests
        change = bal.step(port_fakes, version)
        moved += change is not None
        want = [(c[0].begin, c[0].end, c[1], c[2])
                for c in master.resolution_changes]
        got = [(c[0].begin, c[0].end, c[1], c[2])
               for c in bal.resolution_changes]
        assert got == want
        assert bal.resolution_changes_version == \
            master.resolution_changes_version
        assert all(c[1] != RESOLVER_ALL and c[0].begin < b"\xff"
                   for c in bal.resolution_changes)
        # Some proxies ask for a version: the changes they are handed,
        # after the master's GC.
        for p in rng.sample(proxies, rng.randint(0, len(proxies))):
            request_num[p] += 1
            req = GetCommitVersionRequest(request_num=request_num[p],
                                          proxy_id=p, reply=LogReply())
            st = master.proxy_states.setdefault(
                p, ref_master._ProxyVersionState())
            master._reply_version(st, req)
            master.version = version
            want = [(c[0].begin, c[0].end, c[1], c[2])
                    for c in req.reply.value.resolver_changes]
            got = [(c[0].begin, c[0].end, c[1], c[2])
                   for c in bal.changes_for(p)]
            assert got == want
    assert (moved > 0) == (n > 1)


# ------------------------------------------------------ (f) the whole plane
def port_parity_stream():
    stream = chip_smoke.parity_stream()
    ref = _parity_stream()
    assert [(p, v, [txn_fields(t) for t in txns])
            for _, p, v, txns in stream] == \
        [(p, v, [txn_fields(t) for t in txns]) for p, v, txns in ref]
    return stream, ref


@pytest.mark.parametrize("n", NS)
def test_plane_aligned_parity(sim, n):
    stream, ref_stream = port_parity_stream()
    want = _resolve_stream(n, ref_stream)
    plane = ResolutionPlane(n, ["proxy0"], device="cpu", capacity=1 << 10)
    got = [[int(c) for c in plane.resolve("proxy0", txns, prev,
                                          version).committed]
           for _, prev, version, txns in stream]
    assert got == want
    flat = [c for wave in got for c in wave]
    assert flat.count(int(rt.CommitResult.CONFLICT)) > 5


def ref_plane_verdicts(n, stream, changes_after):
    """The reference's plane on the straddling stream: SimCluster's two
    proxies and oracle resolvers through the proxies' requests, the
    resolvers' RPC and _determine_committed; `changes_after` = (wave,
    reference-typed changes) handed to both proxies after that wave."""
    c = SimCluster(n_resolvers=n, n_commit_proxies=2)
    wave_moved, changes = changes_after

    async def go():
        out = []
        for w, (p, prev, version, txns) in enumerate(stream):
            proxy = c.commit_proxies[p]
            if w > wave_moved:
                proxy._apply_resolver_changes(changes)
            batch, requests, index_maps = _reqs(
                proxy, [ref_txn(t) for t in txns], prev, version)
            resolutions = await wait_all([
                RequestStream.at(r.resolve.endpoint).get_reply(req)
                for r, req in zip(proxy.resolvers, requests)])
            proxy.last_resolved_version = version
            out.append([int(v) for v in proxy._determine_committed(
                batch, index_maps, resolutions)])
        return out

    return c.run_until(c.loop.spawn(go()), timeout=60)


@pytest.mark.parametrize("n", [2, 4])
def test_plane_straddling_matches_reference(knobs, sim, n):
    knobs.set("MAX_WRITE_TRANSACTION_LIFE_VERSIONS", chip_smoke.STRADDLE_LIFE)
    stream = chip_smoke.straddle_stream()
    plane = ResolutionPlane(n, ["proxy0", "proxy1"], device="cpu",
                            capacity=1 << 10)
    got, moves = chip_smoke.drive_small_plane(
        plane, stream, ("proxy0", "proxy1"), chip_smoke.STRADDLE_MOVE_AFTER)
    (kr, idx, v), = [m for m in moves if m]
    assert all(p._resolver_changes_hwm == v for p in plane.proxies.values())
    want = ref_plane_verdicts(n, stream, (chip_smoke.STRADDLE_MOVE_AFTER, [
        (rt.KeyRange(kr.begin, kr.end), idx, v)]))
    assert [b[0] for b in got] == want
    old = [want[w][i] for w, i in chip_smoke.old_snapshot_reads(stream)]
    assert old and all(c == int(rt.CommitResult.CONFLICT) for c in old)
    flat = [c for wave in want for c in wave]
    assert all(flat.count(int(c)) > 5 for c in rt.CommitResult)


def test_plane_small_case_on_cpu():
    """chip_smoke's small exact case with the roles' sets on the CPU: the
    plane equals the plane over the port's oracle at N = 1, 2, 4."""
    out = chip_smoke.plane_small("cpu", device="cpu")
    assert out["straddle_4"]["moved"] and out["straddle_2"]["moved"]
    assert out["straddle_4"]["state_received"] > 0
    assert out["straddle_4"]["reported"] > 0


@pytest.mark.parametrize("n, boundaries", [
    (2, []), (3, [b"a"]), (2, [b"a", b"b"]), (3, [b"b", b"a"]),
    (2, [b"\xff"]), (2, [b""]), (0, None)])
def test_plane_rejects_bad_boundaries(n, boundaries):
    """Cut keys that leave a resolver without user keyspace, or that do
    not cut [b"", \\xff) in order, are refused before any role is built."""
    with pytest.raises(ValueError):
        ResolutionPlane(n, ["p0"], boundaries=boundaries, device="cpu")
