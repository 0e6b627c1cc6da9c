"""The port's scheduling plane held against the JAX package's.

The reference's plane is foundationdb_tpu/sched/ (predictor.py,
reorder.py, repair.py), the ratekeeper's heat fold
(server/ratekeeper.py _fold_conflict_heat) and the commit proxy's stages
(server/commit_proxy.py: the reorder at batch assembly, :328-343;
_collect_repairs, :543-609, and the reply loop's repair bookkeeping,
:510-580; scheduler_status); the port's is foundationdb_tpu_torch/sched/,
server/ratekeeper.py, server/grv_proxy.py and CommitProxy.commit().  Each
case feeds both the same seeded inputs with tolerance 0 (bytes, ints,
enums, and floats computed in the same order):

  (a) ConflictPredictor: the table, the doom maps and status() after
      every update, over feeds with ties, decay drop-out and table_max
      overflow, and its queries;
  (b) reorder_batch and moved_count over point and range batches, cycles
      and hot cliques, on the greedy path and past exact_max;
  (c) repair_eligible and RepairLadder over seeded failure and success
      sequences;
  (d) the ratekeeper's fold;
  (e) the proxy stages: the plane at N = 1, 2 and 4 over the port's
      oracle, every stage on, driven by chip_smoke.drive_sched on
      chip_smoke's parity and straddling streams and its small case's
      zipf stream (where the ladder backs ranges off); each call's reorder
      against the reference's reorder_batch, each repair collection
      against a SimCluster proxy's _collect_repairs on the same verdicts,
      ranges and exactness (the repair requests, which reply each carries
      and the ladder's state), and the reply loop's counters transcribed
      onto that proxy: scheduler_status equal;
  (f) with every knob off, commit() gives resolve()'s verdicts (after the
      reference's test_knobs_off_abort_set_parity) and no stage acts;
  (g) the GRV admission and the ratekeeper's poll, and chip_smoke's small
      exact case on the CPU (tests/test_torch_kernels.py runs it on the
      card).
"""

import dataclasses
import os
import random
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from foundationdb_tpu.core.knobs import server_knobs as ref_knobs
from foundationdb_tpu.sched import predictor as ref_predictor
from foundationdb_tpu.sched import reorder as ref_reorder
from foundationdb_tpu.sched import repair as ref_repair
from foundationdb_tpu.server.cluster import SimCluster
from foundationdb_tpu.server.interfaces import \
    CommitTransactionRequest as RefRequest
from foundationdb_tpu.server.interfaces import \
    ResolveTransactionBatchReply as RefResolveReply
from foundationdb_tpu.server.ratekeeper import Ratekeeper as RefRatekeeper
from foundationdb_tpu.txn import types as rt
from foundationdb_tpu_torch.core.knobs import server_knobs
from foundationdb_tpu_torch.sched import predictor, reorder, repair
from foundationdb_tpu_torch.server import (CommitTransactionRequest,
                                           GrvProxy, Ratekeeper, Reply,
                                           ResolutionPlane)
from foundationdb_tpu_torch.server import commit_proxy as port_commit_proxy
from foundationdb_tpu_torch.server import grv_proxy
from foundationdb_tpu_torch.txn import types as pt

from test_torch_resolution_plane import request_fields, ref_txn, txn_fields

SCHED_KNOBS = ("SCHED_PREDICTOR_ENABLED", "SCHED_REORDER_ENABLED",
               "SCHED_REPAIR_ENABLED")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def knobs():
    """Both packages' server knobs, set together, restored after."""
    regs = [ref_knobs(), server_knobs()]
    saved = [dict(k.__dict__) for k in regs]

    class Both:
        @staticmethod
        def set(name, value):
            for k in regs:
                setattr(k, name, value)

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


def point(k):
    return pt.KeyRange(k, k + b"\x00")


# --------------------------------------------------------- (a) predictor
TAGS = ["", "hot", "t/a", "t/b", "t/c"]
TENANTS = [-1, 0, 1, 2, 7]


def feed(rng, keys, width):
    """One feed snapshot: `width` rows over `keys`, counts from a few
    values (ties), tag and tenant breakdowns, some rows trimmed to four
    or five members, now and then a range twice."""
    rows = []
    for _ in range(width):
        k = rng.choice(keys)
        conflicts = rng.choice([0, 1, 2, 4, 4, 8, 16, 2.5])
        load = rng.choice([0, 0, 1, 2, 8])
        tags = {t: rng.randrange(1, 9) for t in rng.sample(TAGS, 2)}
        tenants = {t: rng.randrange(1, 9) for t in rng.sample(TENANTS, 2)}
        row = (k, k + b"\x00", conflicts, load, tags, tenants)
        rows.append(row[:rng.choice([4, 5, 6, 6])])
    return rows


def predictor_state(p):
    return (list(p.ranges.items()), list(p.doomed_tags.items()),
            list(p.doomed_tenants.items()), p.updates, p.status(),
            p.hot_ranges(20), p.alpha, p.abort_p, p.min_conflicts,
            p.table_max)


@pytest.mark.parametrize("seed, params", [
    (0, {}), (1, {"alpha": 0.3, "abort_p": 0.3, "min_conflicts": 2.0}),
    (2, {"alpha": 1.0, "table_max": 16}), (3, {"alpha": 0.005}),
    (4, {"abort_p": 0.1, "min_conflicts": 0.5, "table_max": 3}),
    (5, {"alpha": 0.7, "abort_p": 0.6, "table_max": 20})])
def test_predictor_matches_reference(seed, params):
    """The table, the doom maps, status() and the queries after every
    update: ties (equal counts on many keys), decay drop-out (keys absent
    from a feed, empty feeds) and table_max overflow (40 keys)."""
    rng = random.Random(seed)
    keys = [b"r%02d" % i for i in range(40)]
    got = predictor.ConflictPredictor(**params)
    want = ref_predictor.ConflictPredictor(**params)
    dropped = doomed = 0
    for step in range(60):
        rows = [] if step % 11 == 10 else feed(
            rng, keys[:rng.choice([5, 12, 40])], rng.randrange(1, 30))
        before = len(want.ranges)
        got.update(rows)
        want.update(rows)
        dropped += before > len(want.ranges)
        doomed += bool(want.doomed_tags) and bool(want.doomed_tenants)
        assert predictor_state(got) == predictor_state(want), step
        for t in TAGS:
            assert got.is_doomed((t,)) == want.is_doomed((t,))
            assert got.doomed_range_for((t,)) == want.doomed_range_for((t,))
        for t in TENANTS:
            assert got.is_doomed((), t) == want.is_doomed((), t)
            assert got.doomed_range_for((), t) == \
                want.doomed_range_for((), t)
        for k in keys[:6]:
            assert got.range_prob(k, k + b"\x00") == \
                want.range_prob(k, k + b"\x00")
    assert dropped > 0 and doomed > 0


def test_predictor_from_knobs_matches_reference():
    """A GRV proxy's table: the port's constants are the reference's
    knob defaults."""
    got = predictor.ConflictPredictor.default()
    want = ref_predictor.ConflictPredictor.from_knobs(ref_knobs())
    assert predictor_state(got) == predictor_state(want)


# ----------------------------------------------------------- (b) reorder
def batch_of(kind, rng, n):
    keys = [b"k%02d" % i for i in range(30)]
    txns = []
    for t in range(n):
        if kind == "point":
            reads = [point(rng.choice(keys))
                     for _ in range(rng.randint(0, 3))]
            writes = [point(rng.choice(keys))
                      for _ in range(rng.randint(0, 2))]
        elif kind == "range":
            def rng_range():
                a, b = sorted((rng.choice(keys),
                               rng.choice(keys + [b"k05\x00"])))
                return pt.KeyRange(a, b)    # some empty
            reads = [rng_range() for _ in range(rng.randint(0, 3))]
            writes = [rng_range() if rng.random() < 0.4 else
                      point(rng.choice(keys))
                      for _ in range(rng.randint(0, 2))]
        elif kind == "cycle":
            m = max(2, n // 3)
            reads = [point(keys[t % m])]
            writes = [point(keys[(t + 1) % m])]
        else:   # a hot clique: read-modify-write of a few keys
            hot = keys[:3]
            reads = [point(rng.choice(hot))]
            writes = [point(rng.choice(hot))]
        txns.append(pt.CommitTransactionRef(read_conflict_ranges=reads,
                                            write_conflict_ranges=writes))
    return txns


@pytest.mark.parametrize("kind", ["point", "range", "cycle", "clique"])
@pytest.mark.parametrize("exact_max", [1024, 16])
@pytest.mark.parametrize("seed", range(3))
def test_reorder_matches_reference(kind, exact_max, seed):
    """The new order and moved_count, on the greedy path (exact_max 1024)
    and the static in-degree path (exact_max 16 < the batch)."""
    rng = random.Random(seed * 31 + len(kind))
    for n in (0, 1, 2, 7, 40):
        txns = batch_of(kind, rng, n)
        got = reorder.reorder_batch(txns, exact_max=exact_max)
        want = ref_reorder.reorder_batch([ref_txn(t) for t in txns],
                                         exact_max=exact_max)
        assert got == want, (kind, n)
        assert sorted(got) == list(range(n))
        assert reorder.moved_count(got) == ref_reorder.moved_count(want)


# ------------------------------------------------------------ (c) repair
def test_repair_eligible_matches_reference():
    rng = random.Random(5)
    keys = [b"a", b"b", b"c", b"d", b"e", b"f"]
    for _ in range(600):
        reads = []
        for _ in range(rng.randint(0, 3)):
            a, b = sorted(rng.sample(keys, 2))
            reads.append(pt.KeyRange(a, b))
        txn = pt.CommitTransactionRef(read_conflict_ranges=reads)
        culprits = []
        for _ in range(rng.randint(0, 3)):
            a, b = sorted(rng.sample(keys + [b"bb", b"cc"], 2))
            culprits.append((a, b))
        exact, attempt = rng.random() < 0.7, rng.randint(0, 3)
        max_attempts = rng.randint(0, 3)
        assert repair.repair_eligible(txn, culprits, exact, attempt,
                                      max_attempts) == \
            ref_repair.repair_eligible(ref_txn(txn), culprits, exact,
                                       attempt, max_attempts)
        assert repair.culprits_in_read_set(reads, culprits) == \
            ref_repair.culprits_in_read_set(
                ref_txn(txn).read_conflict_ranges, culprits)


@pytest.mark.parametrize("seed, backoff, table_max",
                         [(0, 250, 1024), (1, 1, 4), (2, 100, 2),
                          (3, 0, 8)])
def test_repair_ladder_matches_reference(seed, backoff, table_max):
    """Seeded note_failure / should_attempt / note_success / blocked_count
    sequences on a rising version clock: the entries (order included)
    after every step, and every answer."""
    rng = random.Random(seed)
    spans = [(b"k%d" % i, b"k%d\x00" % i) for i in range(12)]
    wide = [(b"k1", b"k5"), (b"k0", b"k9"), (b"", b"\xff")]
    got = repair.RepairLadder(backoff, table_max)
    want = ref_repair.RepairLadder(backoff, table_max)
    version = 0
    for step in range(300):
        version += rng.choice([0, 1, 50, 300, 2000])
        culprits = rng.sample(spans, rng.randint(0, 3))
        op = rng.random()
        if op < 0.45:
            got.note_failure(culprits, version)
            want.note_failure(culprits, version)
        elif op < 0.75:
            assert got.should_attempt(culprits, version) == \
                want.should_attempt(culprits, version)
        elif op < 0.9:
            succ = rng.sample(spans + wide, rng.randint(0, 2))
            got.note_success(iter(succ))
            want.note_success(iter(succ))
        else:
            assert got.blocked_count(version) == want.blocked_count(version)
        assert list(got._entries.items()) == list(want._entries.items()), \
            step
    assert (got.backoff_versions, got.table_max) == \
        (want.backoff_versions, want.table_max)


# -------------------------------------------------------- (d) ratekeeper
@pytest.mark.parametrize("seed", range(4))
def test_ratekeeper_fold_matches_reference(seed):
    rng = random.Random(seed)
    keys = [b"f%d" % i for i in range(10)]
    for _ in range(20):
        per_resolver = [feed(rng, keys, rng.randrange(0, 12))
                        for _ in range(rng.randint(0, 4))]
        if rng.random() < 0.2:
            per_resolver.append(None)
        top_k = rng.choice([1, 3, 8, 64])
        assert Ratekeeper._fold_conflict_heat(per_resolver, top_k) == \
            RefRatekeeper._fold_conflict_heat(per_resolver, top_k)


def test_poll_conflict_heat_idle_when_predictor_off(knobs):
    """Off: no request reaches a role and the fold is empty.  On: one heat
    request a role with top_k from the table bound (the reference's
    default), folded."""
    asked = []

    class Role:
        def __init__(self, rows):
            self.rows = rows

        def serve_heat(self, req):
            asked.append(req.top_k)
            req.reply.send(self.rows)

    roles = [Role([(b"a", b"b", 3, 1, {"x": 3}, {})]),
             Role([(b"a", b"b", 2, 1, {"x": 1}, {5: 2})])]
    rk = Ratekeeper()
    assert rk.poll_conflict_heat(roles) == [] and asked == []
    knobs.set("SCHED_PREDICTOR_ENABLED", True)
    assert rk.poll_conflict_heat(roles) == \
        [(b"a", b"b", 5, 2, {"x": 4}, {5: 2})]
    assert asked == [max(8, ref_knobs().SCHED_PREDICTOR_TABLE_MAX // 8)] * 2
    assert asked == [64, 64]


# -------------------------------------------------- (e) the proxy stages
def sched_stream(stream):
    """A small stream as drive_sched takes it, every txn reporting its
    conflicting keys and declaring a tag (its own, else its first key's
    first byte)."""
    out = []
    for _p, prev, version, txns in stream:
        batch = []
        for t in txns:
            keys = t.read_conflict_ranges + t.write_conflict_ranges
            tag = t.tag or (b"c%02x" % keys[0].begin[0]).decode() \
                if keys else t.tag
            batch.append(dataclasses.replace(t, report_conflicting_keys=True,
                                             tag=tag))
        out.append((prev, version, batch))
    return out


def record_stages(plane):
    """Each proxy's reorder and repair-collection calls, by proxy id."""
    calls = []
    for proxy in plane.proxies.values():
        for name in ("_reorder", "_collect_repairs"):
            def call(*args, name=name, proxy=proxy,
                     fn=getattr(proxy, name)):
                calls.append((name, proxy.id))
                return fn(*args)
            setattr(proxy, name, call)
    return calls


def record_commits(plane):
    """Each commit() call of the plane's proxies, in order: (proxy id,
    the input batch as (request, transaction) pairs as they stood, prev,
    version, resolver changes, the proxy's batch number, each role's
    (request, reply), the repair requests returned, and after the call
    the proxy's ladder entries and scheduler_status)."""
    calls, exchanges = [], []
    for role in plane.resolvers:
        def resolve_batch(req, fn=role.resolve_batch):
            fn(req)
            exchanges.append((req, req.reply.value))
        role.resolve_batch = resolve_batch
    for proxy in plane.proxies.values():
        def commit(batch, prev, version, changes=(), proxy=proxy,
                   fn=proxy.commit):
            exchanges.clear()
            frozen = [(r, r.transaction) for r in batch]
            out = fn(batch, prev, version, changes)
            ladder = proxy._repair_ladder
            calls.append((proxy.id, frozen, prev, version, list(changes),
                          proxy.local_batch_number, list(exchanges),
                          list(out),
                          {k: list(v) for k, v in ladder._entries.items()}
                          if ladder else {}, proxy.scheduler_status()))
            return out
        proxy.commit = commit
    return calls


def ref_reply(rep):
    """A port role's reply in the reference's types."""
    return RefResolveReply(
        committed=[rt.CommitResult(int(c)) for c in rep.committed],
        state_transactions=[
            (v, origin, seq, [rt.Mutation(rt.MutationType(int(m.type)),
                                          m.param1, m.param2)
                              for m in muts], rt.CommitResult(int(c)))
            for v, origin, seq, muts, c in rep.state_transactions],
        conflicting_ranges={k: list(v) for k, v in
                            rep.conflicting_ranges.items()},
        attribution_exact=dict(rep.attribution_exact))


def ref_outcome(promise):
    """A reference reply promise's answer, as chip_smoke.reply_of gives
    the port's."""
    f = promise.get_future()
    assert f.is_ready()
    if not f.is_error():
        v = f.get()
        return ("ok", v.version, v.txn_batch_id, v.txn_batch_index)
    e = f.error
    return ("err", e.name, [tuple(x) for x in
                            getattr(e, "details", None) or ()])


def ref_replay(monkeypatch, cluster, plane, calls):
    """Replay the port's commit() calls through the reference's own
    CommitProxy._commit_batch_impl on SimCluster's proxies, each batch at
    the port's versions and batch number.  The reference's RPC answers at
    once: its master with the port's versions and resolver changes, each
    resolver with the port role's reply (its request first held equal to
    the port's), the log system with an ack.  Stubbed on the reference's
    side, as the port leaves them out: the tenant fence (no tenants) and
    the repair batch's spawn (the port's caller commits it next, which the
    replay then feeds the reference).  After each call: the reference's
    repair requests equal the port's (carrying the same replies), its
    ladder and scheduler_status equal the port's.  Returns each port
    reply's id mapped to the reference's promise."""
    from foundationdb_tpu.core.futures import Promise, ready_future
    from foundationdb_tpu.server import commit_proxy as ref_cp
    from foundationdb_tpu.server.interfaces import GetCommitVersionReply
    answers = []

    class Stream:
        @staticmethod
        def at(endpoint):
            fn, = [f for ep, f in answers if ep is endpoint]

            class Client:
                @staticmethod
                def get_reply(req):
                    return ready_future(fn(req))
            return Client

    class LogSystem:
        @staticmethod
        def push(*args, **kwargs):
            return ready_future(None)

    monkeypatch.setattr(ref_cp, "RequestStream", Stream)
    ref = {p.id: p for p in cluster.commit_proxies}
    collected, spawned = [], []
    for pid, proxy in ref.items():
        port = plane.proxies[pid]
        for b, e, v in port.key_resolvers.ranges():
            proxy.key_resolvers.set_range(b, e, v)
        assert list(proxy.key_resolvers.ranges()) == \
            list(port.key_resolvers.ranges())
        proxy.log_system = LogSystem()
        proxy._validate_tenants = lambda batch, verdicts: {}

        def collect(*args, fn=proxy._collect_repairs):
            out = fn(*args)
            collected.append(out)
            return out
        proxy._collect_repairs = collect

        def spawn(coro, name):
            spawned.append(name)
            coro.close()
        proxy._spawn = spawn
    promises = {}
    for (pid, frozen, prev, version, changes, batch_num, exchanges,
         repairs, port_ladder, port_status) in calls:
        proxy = ref[pid]
        master = proxy.master
        ref_changes = [(rt.KeyRange(kr.begin, kr.end), idx, v)
                       for kr, idx, v in changes]
        answers[:] = [
            (master.get_commit_version.endpoint,
             lambda req: GetCommitVersionReply(
                 version=version, prev_version=prev,
                 resolver_changes=ref_changes)),
            (master.report_live_committed_version.endpoint,
             lambda req: None)]
        for r, (port_req, rep) in zip(proxy.resolvers, exchanges):
            def answer(req, port_req=port_req, rep=rep):
                assert request_fields(req) == request_fields(port_req)
                return ref_reply(rep)
            answers.append((r.resolve.endpoint, answer))
        assert len(exchanges) == len(proxy.resolvers)
        batch = [RefRequest(transaction=ref_txn(t), debug_id=r.debug_id,
                            repair_eligible=r.repair_eligible,
                            repair_attempt=r.repair_attempt,
                            reply=promises.setdefault(id(r.reply),
                                                      Promise()))
                 for r, t in frozen]
        proxy.local_batch_number = batch_num
        collected.clear()
        spawned.clear()
        coro = proxy._commit_batch_impl(batch, batch_num)
        with pytest.raises(StopIteration):
            coro.send(None)     # every await is answered: no suspension
        ref_repairs = collected[0] if collected else []
        assert [(txn_fields(o.transaction), o.debug_id, o.repair_eligible,
                 o.repair_attempt, o.reply) for o in ref_repairs] == \
            [(txn_fields(o.transaction), o.debug_id, o.repair_eligible,
              o.repair_attempt, promises[id(o.reply)]) for o in repairs]
        assert len(spawned) == bool(repairs)
        assert proxy.local_batch_number == batch_num + bool(repairs)
        ladder = getattr(proxy, "_repair_ladder", None)
        assert (dict(ladder._entries) if ladder else {}) == port_ladder
        assert proxy.scheduler_status() == port_status
    return promises


def zipf_stream():
    """chip_smoke's small-case stream (256 txns a batch, two reads, zipf
    over 4,096 ids), in the small streams' shape."""
    return [(i % 2, prev, v, txns) for i, (prev, v, txns) in enumerate(
        chip_smoke.sched_stream(chip_smoke.SCHED_SEED + 2,
                                chip_smoke.SCHED_SMALL_BATCHES,
                                chip_smoke.SCHED_SMALL_TXNS,
                                chip_smoke.SCHED_SMALL_KEYS))]


def zipf_cuts(n):
    return [b"k%014d" % (chip_smoke.SCHED_SMALL_KEYS * i // n)
            for i in range(1, n)]


# name: (stream, commit proxies, boundaries for N)
STREAMS = {"parity": (chip_smoke.parity_stream, 1, lambda n: None),
           "straddle": (chip_smoke.straddle_stream, 2, lambda n: None),
           "zipf": (zipf_stream, 2, zipf_cuts)}


@pytest.mark.parametrize("attempts", [1, 3])
@pytest.mark.parametrize("stream_name", sorted(STREAMS))
@pytest.mark.parametrize("n", [1, 2, 4])
def test_proxy_stages_match_reference(knobs, sim, monkeypatch, n,
                                      stream_name, attempts):
    """Every stage on, the plane over the port's oracle at N resolvers,
    each commit() replayed through the reference's _commit_batch_impl
    (ref_replay): its reorder, repair collection, ladder, counters and
    reply fan-out.  Every original request's answer (a CommitID with its
    version, batch and index, or the error with its conflicting ranges)
    equals the reference's, including the repaired txns' answers from
    their repair batches."""
    for name in SCHED_KNOBS:
        knobs.set(name, True)
    knobs.set("TXN_REPAIR_MAX_ATTEMPTS", attempts)
    knobs.set("SCHED_REORDER_EXACT_MAX", 16)
    monkeypatch.setattr(port_commit_proxy, "REORDER_EXACT_MAX", 16)
    knobs.set("MAX_WRITE_TRANSACTION_LIFE_VERSIONS", chip_smoke.STRADDLE_LIFE)
    make, n_proxies, cuts = STREAMS[stream_name]
    stream = sched_stream(make())
    c = SimCluster(n_resolvers=n, n_commit_proxies=n_proxies)
    proxies = tuple(p.id for p in c.commit_proxies)
    plane = ResolutionPlane(n, list(proxies), boundaries=cuts(n),
                            backend="cpu")
    calls = record_commits(plane)
    run = chip_smoke.drive_sched(plane, stream, proxies, warmup=0)
    out = chip_smoke.sched_outcome(plane, run)
    promises = ref_replay(monkeypatch, c, plane, calls)
    got = [chip_smoke.reply_of(r) for r in run["originals"]]
    assert got == [ref_outcome(promises[id(r.reply)])
                   for r in run["originals"]]
    assert out["reorder_moved"] > 0 and out["repairs"] > 0
    assert out["repairs_ok"] > 0
    # A repaired txn's CommitID names its repair batch: a version past its
    # own batch's, on the repair rung's step.
    versions = {v for _, v, _ in stream}
    assert any(g[0] == "ok" and g[1] not in versions for g in got)
    if stream_name == "zipf":
        assert out["deferrals"] > 0 and out["repairs_exhausted"] > 0
        assert (out["backed_off"] > 0) == (attempts > 1)
    assert len(calls) == out["commits"]


# ------------------------------------------------------ (f) knobs off
@pytest.mark.parametrize("n", [1, 2, 4])
def test_commit_equals_resolve_with_knobs_off(knobs, n):
    """Every SCHED_* knob off (the defaults): on the straddling stream,
    two proxies alternating, commit() answers each request by resolve()'s
    verdict on the same batch (a CommitID where it committed,
    not_committed with the reporter's ranges, transaction_too_old), keeps
    resolve()'s committed foreign state txns, returns no repair, and no
    stage acts; the poll sends nothing."""
    assert not any(getattr(server_knobs(), k) for k in SCHED_KNOBS)
    knobs.set("MAX_WRITE_TRANSACTION_LIFE_VERSIONS", chip_smoke.STRADDLE_LIFE)
    stream = sched_stream(chip_smoke.straddle_stream())
    proxies = ("p0", "p1")
    a = ResolutionPlane(n, list(proxies), device="cpu", capacity=1 << 10)
    b = ResolutionPlane(n, list(proxies), device="cpu", capacity=1 << 10)
    calls = record_stages(a)
    prev, flat, state = 0, [], 0
    for i, (_, v, txns) in enumerate(stream):
        pid = proxies[i % 2]
        reqs = [CommitTransactionRequest(t, repair_eligible=True,
                                         reply=Reply()) for t in txns]
        assert a.admit(pid, reqs, prev) == reqs
        assert a.commit(pid, reqs, prev, v) == []
        want = b.resolve(pid, txns, prev, v)
        prev = v
        got = [chip_smoke.reply_of(r) for r in reqs]
        for k, (g, c) in enumerate(zip(got, want.committed)):
            if c == pt.CommitResult.COMMITTED:
                assert g[:2] == ("ok", v) and g[3] == k
            elif c == pt.CommitResult.TOO_OLD:
                assert g == ("err", "transaction_too_old", [])
            else:
                assert g == ("err", "not_committed",
                             [tuple(x) for x in
                              want.conflicting_ranges.get(k, ())])
        assert a.proxies[pid].last_state_transactions == \
            want.state_transactions
        state += len(want.state_transactions)
        flat += [int(c) for c in want.committed]
    assert all(flat.count(c) > 5 for c in (0, 1, 2)) and state > 0
    assert calls == [] and a.feed() == []
    for pid in proxies:
        assert set(a.proxies[pid].scheduler_status().values()) == {0}
        assert a.grv_proxies[pid].scheduler_status()["deferrals"] == 0


# ------------------------------------------- (g) admission and the small case
def test_grv_admission_defers_bounded_and_restamps(knobs):
    """A doomed tag is held SCHED_MAX_DEFERRALS rounds, then admitted
    unconditionally at the round's read version; a clean tag is admitted
    at once with its own snapshot; deferred requests come first, in
    order; off, nothing is deferred."""
    g = GrvProxy("p0")
    g.fold_conflict_heat([(b"h", b"h\x00", 50, 1, {"doomtag": 50}, {})])
    g.fold_conflict_heat([])    # an empty fold leaves the table
    assert g.predictor.is_doomed(("doomtag",)) and g.predictor.updates == 1

    def req(tag, snap=5):
        return CommitTransactionRequest(pt.CommitTransactionRef(
            read_conflict_ranges=[point(b"h")], read_snapshot=snap,
            tag=tag), reply=Reply())

    doomed, clean = req("doomtag"), req("clean")
    assert g.admit([doomed, clean], 100) == [doomed, clean]
    knobs.set("SCHED_PREDICTOR_ENABLED", True)
    assert grv_proxy.SCHED_MAX_DEFERRALS == \
        ref_knobs().SCHED_MAX_DEFERRALS == 3
    d1, d2, c1 = req("doomtag"), req("doomtag"), req("clean")
    assert g.admit([d1, c1, d2], 100) == [c1]
    assert c1.transaction.read_snapshot == 5
    assert g.scheduler_status()["deferred_held"] == 2
    c2 = req("clean")
    assert g.admit([c2], 200) == [c2]
    assert g.admit([], 300) == []
    assert g.admit([], 400) == [d1, d2]
    assert [r.transaction.read_snapshot for r in (d1, d2)] == [400, 400]
    assert d1._sched_defers == 3
    st = g.scheduler_status()
    assert st["deferrals"] == 6 and st["doomed_tags"] == ["doomtag"]
    assert st["deferred_held"] == 0


def test_reply_answers_once():
    r = Reply()
    r.send_error(ValueError("x"))
    with pytest.raises(RuntimeError):
        r.send(1)
    r = Reply()
    r.send(1)
    with pytest.raises(RuntimeError):
        r.send_error(ValueError("x"))


def test_sched_small_case_on_cpu():
    """chip_smoke's small exact case with the roles' sets on the CPU: the
    supervised plane equals the CPU plane and the oracle plane, every
    stage acting."""
    out = chip_smoke.sched_small("cpu", device="cpu")
    for case in ("two_reads", "one_read"):
        assert out[case]["max_defers"] == 3
        assert out[case]["repairs_exhausted"] > 0
        assert out[case]["backed_off"] > 0
        assert 0.05 < out[case]["commit_rate"] < 1


def test_sched_constants_match_reference_defaults():
    """The constants that stand for the reference's knobs hold its
    defaults: the ladder's, reorder's bound, the deferral bound."""
    k = ref_knobs()
    ladder = repair.RepairLadder.default()
    assert (ladder.backoff_versions, ladder.table_max) == \
        (k.TXN_REPAIR_BACKOFF_VERSIONS, k.TXN_REPAIR_LADDER_TABLE_MAX)
    assert port_commit_proxy.REORDER_EXACT_MAX == k.SCHED_REORDER_EXACT_MAX
    assert grv_proxy.SCHED_MAX_DEFERRALS == k.SCHED_MAX_DEFERRALS
