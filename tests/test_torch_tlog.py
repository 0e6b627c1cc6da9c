"""The port's log path held against the JAX package's: the wire format,
the TLog's commit records, the disk queue and the TLog role, and the
master's commit versions.

The reference's are foundationdb_tpu/core/wire.py, server/disk_queue.py
(over its simulated file), server/tlog.py (run in its simulated event
loop) and server/master.py; the port's are foundationdb_tpu_torch/
core/wire.py, server/{disk_queue,real_fs,tlog,master}.py.  Each case
feeds both the same seeded inputs, with tolerance 0 (everything is
bytes, ints and enums):

  (a) Writer/Reader and _pack_commit/_unpack_commit: the same bytes and
      the same records back;
  (b) DiskQueue: the same pushes, commits and pops give the same file
      bytes (the reference's durable image of its simulated file against
      the port's real file), and recover() the same records, a torn tail
      and a flipped bit included;
  (c) the TLog: the same commits (resends included), peeks under a
      lowered byte budget (cuts included) and pops give the same
      tag_data, poppedtags, byte counters, peek replies, queue records
      and file bytes;
  (d) the master: two proxies' version requests, resends and committed
      reports under the same clock readings (the reference's simulated
      loop time, the port's clock argument) give the same versions,
      chains, cached resends and live committed versions;

and the failures the port raises instead of parking or carrying on: a
TLog commit ahead of its predecessor, a master request ahead of its
predecessor, and a queue whose sync fails (the TLog stops: no reply, no
durable version, nothing acknowledged after).
"""

import os
import random

import pytest

from foundationdb_tpu.core.futures import Promise
from foundationdb_tpu.core.knobs import server_knobs as ref_knobs
from foundationdb_tpu.core.wire import Reader as RefReader
from foundationdb_tpu.core.wire import Writer as RefWriter
from foundationdb_tpu.server import disk_queue as ref_dq
from foundationdb_tpu.server import interfaces as ri
from foundationdb_tpu.server import tlog as ref_tlog
from foundationdb_tpu.server.sim_fs import SimFileSystem
from foundationdb_tpu.txn import types as rt
from foundationdb_tpu_torch.core.error import FdbError
from foundationdb_tpu_torch.core.knobs import server_knobs
from foundationdb_tpu_torch.core.wire import Reader, Writer
from foundationdb_tpu_torch.server import interfaces as pi
from foundationdb_tpu_torch.server import tlog as port_tlog
from foundationdb_tpu_torch.server.disk_queue import DiskQueue
from foundationdb_tpu_torch.server.interfaces import Reply
from foundationdb_tpu_torch.server.master import Master
from foundationdb_tpu_torch.server.real_fs import RealFile
from foundationdb_tpu_torch.txn import types as pt

TAGS = [0, 1, 2, 3, pi.TXS_TAG]


@pytest.fixture()
def loop():
    """A simulated event loop of the reference's, reset after the test."""
    from foundationdb_tpu.core import (DeterministicRandom, EventLoop,
                                       set_deterministic_random,
                                       set_event_loop)
    from foundationdb_tpu.rpc.sim import set_simulator
    set_deterministic_random(DeterministicRandom(7))
    lp = EventLoop(sim=True)
    set_event_loop(lp)
    yield lp
    set_simulator(None)
    set_event_loop(None)


@pytest.fixture()
def budget():
    """Sets TLOG_PEEK_DESIRED_BYTES in both packages, restored after."""
    regs = [ref_knobs(), server_knobs()]
    saved = [k.TLOG_PEEK_DESIRED_BYTES for k in regs]

    def set_(value):
        for k in regs:
            k.TLOG_PEEK_DESIRED_BYTES = value
    yield set_
    for k, v in zip(regs, saved):
        k.TLOG_PEEK_DESIRED_BYTES = v


def run(lp, coro):
    return lp.run_until(lp.spawn(coro), timeout=60)


def rand_key(rng, n=None):
    return bytes(rng.randrange(256) for _ in range(
        rng.randrange(0, 12) if n is None else n))


def rand_messages(rng):
    """{tag: [(type, p1, p2)]} for one version: 0-4 tags, 1-4 mutations
    each, sets, clears and atomics with keys and values of 0-11 bytes."""
    out = {}
    for tag in rng.sample(TAGS, rng.randrange(0, 5)):
        msgs = []
        for _ in range(rng.randrange(1, 5)):
            t = rng.choice([0, 1, 2, 6, 14])
            msgs.append((t, rand_key(rng), rand_key(rng)))
        out[tag] = msgs
    return out


def muts(types, msgs):
    return [types.Mutation(types.MutationType(t), a, b) for t, a, b in msgs]


def as_tuples(msgs):
    return [(int(m.type), m.param1, m.param2) for m in msgs]


# ------------------------------------------------------------ (a) wire
@pytest.mark.parametrize("seed", range(4))
def test_wire_and_records_match_reference(seed):
    rng = random.Random(seed)
    w, rw = Writer(), RefWriter()
    ops = []
    for _ in range(40):
        kind = rng.choice(["u8", "u16", "u32", "i64", "bytes_", "str_"])
        v = {"u8": rng.randrange(256), "u16": rng.randrange(1 << 16),
             "u32": rng.randrange(1 << 32),
             "i64": rng.randrange(-(1 << 63), 1 << 63),
             "bytes_": rand_key(rng), "str_": "s%d" % rng.randrange(99)}[kind]
        ops.append((kind, v))
        getattr(w, kind)(v)
        getattr(rw, kind)(v)
    blob = w.done()
    assert blob == rw.done()
    r = Reader(blob)
    assert [getattr(r, kind)() for kind, _ in ops] == [v for _, v in ops]
    assert r.at_end()
    rr = RefReader(blob)
    assert [getattr(rr, kind)() for kind, _ in ops] == [v for _, v in ops]
    for _ in range(10):
        v, prev = rng.randrange(1, 1 << 40), rng.randrange(1 << 40)
        popped = {t: rng.randrange(1 << 40) for t in
                  rng.sample(TAGS, rng.randrange(0, 4))}
        msgs = rand_messages(rng)
        got = port_tlog._pack_commit(v, prev, prev, popped,
                                     {t: muts(pt, m) for t, m in msgs.items()})
        want = ref_tlog._pack_commit(v, prev, prev, popped,
                                     {t: muts(rt, m) for t, m in msgs.items()})
        assert got == want
        back = port_tlog._unpack_commit(got)
        assert back[:4] == (v, prev, prev, popped)
        assert {t: as_tuples(m) for t, m in back[4].items()} == msgs


# ------------------------------------------------------- (b) disk queue
def port_file(tmp_path, name="q.dq"):
    return RealFile(str(tmp_path / name), name)


def file_bytes(f):
    return f.read(0, f.size())


@pytest.mark.parametrize("seed", range(4))
def test_disk_queue_matches_reference(loop, tmp_path, seed):
    rng = random.Random(seed)
    fs = SimFileSystem()
    ref = ref_dq.DiskQueue(fs.open("q.dq"))
    port = DiskQueue(port_file(tmp_path))

    async def go():
        for _ in range(30):
            op = rng.random()
            if op < 0.6:
                payload = rand_key(rng, rng.randrange(0, 40))
                assert port.push(payload) == ref.push(payload)
            elif op < 0.85:
                port.commit()
                await ref.commit()
                assert file_bytes(port.file) == bytes(ref.file.durable)
            else:
                seq = rng.randrange(0, ref.next_seq)
                port.pop(seq)
                ref.pop(seq)
            assert (port.next_seq, port.popped_seq) == \
                (ref.next_seq, ref.popped_seq)
            for seq in range(1, ref.next_seq):
                assert port.read_payload(seq) == await ref.read_payload(seq)
        port.commit()
        await ref.commit()
        assert file_bytes(port.file) == bytes(ref.file.durable)
        return bytes(ref.file.durable)

    image = run(loop, go())

    async def recover(cut, flip):
        """Both queues over `image`, cut at `cut` and with bit `flip`
        flipped (None: intact): recover() gives the same records."""
        img = bytearray(image[:cut])
        if flip is not None and img:
            img[flip % len(img)] ^= 1
        f = fs.open("r%d.dq" % len(fs.files))
        await f.write(0, bytes(img))
        await f.sync()
        pf = port_file(tmp_path, "r%d.dq" % len(os.listdir(tmp_path)))
        pf.write(0, bytes(img))
        pf.sync()
        rq, pq = ref_dq.DiskQueue(f), DiskQueue(pf)
        want = await rq.recover()
        assert pq.recover() == want
        assert (pq.next_seq, pq.popped_seq) == (rq.next_seq, rq.popped_seq)
        assert file_bytes(pf) == bytes(f.durable)
        return want

    full = run(loop, recover(len(image), None))
    assert full == [(s, p) for s, p in full if s > 0]
    for cut in sorted(rng.sample(range(len(image)), 3)):
        run(loop, recover(cut, None))
        run(loop, recover(len(image), rng.randrange(len(image) + 1)))


# --------------------------------------------------------- (c) the TLog
async def ref_commit(tlog, version, prev, kcv, messages):
    p = Promise()
    await tlog._commit(ri.TLogCommitRequest(
        version=version, prev_version=prev, known_committed_version=kcv,
        messages=messages, reply=p))
    return await p.get_future()


async def ref_peek(tlog, tag, begin):
    p = Promise()
    await tlog._peek(ri.TLogPeekRequest(tag=tag, begin=begin, reply=p))
    return await p.get_future()


def port_ask(serve, req):
    return pi.ask(serve, req)


def tlog_state(t):
    return ({tag: [(v, as_tuples(m)) for v, m in q]
             for tag, q in t.tag_data.items()}, dict(t.poppedtags),
            t.bytes_input, t.known_committed_version,
            [(v, s, set(tags)) for v, s, tags in t._record_seqs])


def reply_fields(r):
    return ([(v, as_tuples(m)) for v, m in r.messages], r.end,
            r.max_known_version)


@pytest.mark.parametrize("seed", range(5))
def test_tlog_matches_reference(loop, tmp_path, budget, seed):
    rng = random.Random(seed)
    budget(rng.choice([60, 200, 1e6]))
    fs = SimFileSystem()
    ref = ref_tlog.TLog("log0", disk_queue=ref_dq.DiskQueue(
        fs.open("log0.dq")))
    port = port_tlog.TLog("log0", disk_queue=DiskQueue(port_file(tmp_path)))

    async def go():
        version = 0
        for _ in range(60):
            op = rng.random()
            if op < 0.45 or version == 0:
                prev, version = version, version + rng.randrange(1, 1000)
                kcv = rng.randrange(0, prev + 1)
                msgs = rand_messages(rng)
                want = await ref_commit(
                    ref, version, prev, kcv,
                    {t: muts(rt, m) for t, m in msgs.items()})
                got = port_ask(port.commit, pi.TLogCommitRequest(
                    prev_version=prev, version=version,
                    known_committed_version=kcv,
                    messages={t: muts(pt, m) for t, m in msgs.items()}))
                assert got == want == version
                assert port.durable_version == ref.durable_version.get()
            elif op < 0.55:
                # A resend of the last version: no second append.
                want = await ref_commit(ref, version, prev, kcv, {})
                assert port_ask(port.commit, pi.TLogCommitRequest(
                    prev, version, kcv, {})) == want
            elif op < 0.85:
                tag, begin = rng.choice(TAGS), rng.randrange(0, version + 1)
                want = await ref_peek(ref, tag, begin)
                got = port_ask(port.peek, pi.TLogPeekRequest(tag, begin))
                assert reply_fields(got) == reply_fields(want)
            else:
                tag, to = rng.choice(TAGS), rng.randrange(0, version + 1)
                ref._pop(ri.TLogPopRequest(tag=tag, to=to, reply=False))
                port.pop(pi.TLogPopRequest(tag=tag, to=to))
            assert tlog_state(port) == tlog_state(ref)
            assert port.version == ref.version.get()
            assert (port.disk_queue.next_seq, port.disk_queue.popped_seq) \
                == (ref.disk_queue.next_seq, ref.disk_queue.popped_seq)
            assert file_bytes(port.disk_queue.file) == \
                bytes(ref.disk_queue.file.durable)
        return version

    version = run(loop, go())
    # Above the log's version the port answers at once with nothing (the
    # reference parks the peek until a commit arrives).
    got = port_ask(port.peek, pi.TLogPeekRequest(0, version + 5))
    assert reply_fields(got) == ([], version + 1, version)


def test_tlog_raises_on_a_chain_gap(tmp_path):
    t = port_tlog.TLog("log0", disk_queue=DiskQueue(port_file(tmp_path)))
    assert port_ask(t.commit, pi.TLogCommitRequest(0, 10, 0, {})) == 10
    with pytest.raises(RuntimeError, match="before its predecessor"):
        port_ask(t.commit, pi.TLogCommitRequest(15, 20, 0, {}))
    assert (t.version, t.durable_version) == (10, 10)


class FailingFile(RealFile):
    """A real file whose fsync fails once `fail` is set."""

    fail = False

    def sync(self):
        if self.fail:
            raise OSError(5, "injected fsync failure")
        super().sync()


def test_tlog_stops_when_its_sync_fails(tmp_path):
    f = FailingFile(str(tmp_path / "q.dq"), "q.dq")
    t = port_tlog.TLog("log0", disk_queue=DiskQueue(f))
    msgs = {0: [pt.Mutation.set_value(b"a", b"1")]}
    assert port_ask(t.commit, pi.TLogCommitRequest(0, 10, 0, msgs)) == 10
    f.fail = True
    req = pi.TLogCommitRequest(10, 20, 10, msgs, reply=Reply())
    with pytest.raises(OSError, match="injected"):
        t.commit(req)
    assert not req.reply.sent
    assert (t.version, t.durable_version, t.stopped) == (20, 10, True)
    # A stopped log answers nothing again, a resend included.
    f.fail = False
    for serve, req in ((t.commit, pi.TLogCommitRequest(10, 20, 10, msgs)),
                       (t.confirm_running, pi.TLogConfirmRunningRequest())):
        with pytest.raises(FdbError) as e:
            port_ask(serve, req)
        assert e.value.name == "broken_promise"
    assert t.durable_version == 10


# ------------------------------------------------------- (d) the master
class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def ref_version_fields(r):
    return (r.version, r.prev_version, list(r.resolver_changes),
            r.resolver_changes_version)


@pytest.mark.parametrize("seed", range(4))
def test_master_matches_reference(loop, monkeypatch, seed):
    """Under the same clock readings: the versions (the rate, the
    MAX_READ_TRANSACTION_LIFE_VERSIONS / 2 step cap, the
    MAX_VERSIONS_IN_FLIGHT gap cap against the live committed version),
    each proxy's chain and cached resends, and the live committed
    version.  The reference's master, served over its simulated RPC,
    reads the loop's time as its message arrives; both masters read the
    test's clock instead, which the test advances between requests."""
    from foundationdb_tpu.rpc.endpoint import RequestStream
    from foundationdb_tpu.rpc.sim import Simulator, set_simulator
    from foundationdb_tpu.server import master as ref_master
    rng = random.Random(seed)
    if seed % 2:
        # A gap cap the requests reach within the test.
        for k in (ref_knobs(), server_knobs()):
            monkeypatch.setattr(k, "MAX_VERSIONS_IN_FLIGHT", 6_000_000)
    sim = Simulator()
    set_simulator(sim)
    clock = Clock()
    monkeypatch.setattr(ref_master, "now", clock)
    ref = ref_master.Master()
    ref.run(sim.new_process(name="master"))
    port = Master(clock=clock)
    nums = {"p0": 0, "p1": 0}
    capped = []

    async def ask_ref(stream, req):
        return await RequestStream.at(stream.endpoint).get_reply(req)

    async def go():
        for _ in range(60):
            clock.t += rng.choice([0.0, 1e-4, 0.01, 0.7, 3.0, 200.0])
            op = rng.random()
            pid = rng.choice(["p0", "p1"])
            if op < 0.6:
                nums[pid] += 1
                n = nums[pid]
            elif op < 0.75 and nums[pid]:
                n = rng.randrange(max(1, nums[pid] - 3), nums[pid] + 1)
            else:
                v = rng.randrange(0, port.version + 1)
                await ask_ref(ref.interface.report_live_committed_version,
                              ri.ReportRawCommittedVersionRequest(version=v))
                port_ask(port.serve_report_committed,
                         pi.ReportRawCommittedVersionRequest(version=v))
                got = port_ask(port.serve_live_committed,
                               pi.GetRawCommittedVersionRequest())
                want = await ask_ref(ref.interface.get_live_committed_version,
                                     ri.GetRawCommittedVersionRequest())
                assert got.version == want.version
                continue
            cached = n < nums[pid]
            if cached and n < nums[pid] - 1:
                # Evicted from the cache: the reference drops the resend
                # (its reply is never sent), and so does the port.
                req = pi.GetCommitVersionRequest(n, pid, reply=Reply())
                port.serve_commit_version(req)
                assert not req.reply.sent
                continue
            want = await ask_ref(ref.interface.get_commit_version,
                                 ri.GetCommitVersionRequest(
                                     request_num=n, proxy_id=pid))
            got = port_ask(port.serve_commit_version,
                           pi.GetCommitVersionRequest(n, pid))
            assert ref_version_fields(got) == ref_version_fields(want)
            if got.version == port.live_committed_version + int(
                    server_knobs().MAX_VERSIONS_IN_FLIGHT):
                capped.append(got.version)
            assert (port.version, port.live_committed_version) == \
                (ref.version, ref.live_committed_version)

    run(loop, go())
    assert bool(capped) == bool(seed % 2)


def test_master_raises_on_a_request_ahead_of_its_predecessor():
    m = Master(clock=Clock())
    assert port_ask(m.serve_commit_version,
                    pi.GetCommitVersionRequest(1, "p0")).version == 1
    with pytest.raises(RuntimeError, match="arrived before 2"):
        m.serve_commit_version(pi.GetCommitVersionRequest(3, "p0",
                                                          reply=Reply()))
    assert m.version == 1


def test_master_hands_out_moves_like_reference(loop, monkeypatch):
    """The balancer's boundary moves ride the version replies: each proxy
    is handed every move until all the epoch's proxies have seen it,
    then the master drops it -- reply for reply as the reference master
    (its resolution_changes set to the same move)."""
    from foundationdb_tpu.rpc.endpoint import RequestStream
    from foundationdb_tpu.rpc.sim import Simulator, set_simulator
    from foundationdb_tpu.server import master as ref_master
    from foundationdb_tpu_torch.server.master import ResolutionBalancer
    sim = Simulator()
    set_simulator(sim)
    clock = Clock()
    monkeypatch.setattr(ref_master, "now", clock)
    ref = ref_master.Master()
    ref.expected_proxies = ["p0", "p1"]
    ref.resolution_changes = [(rt.KeyRange(b"\x10", b"\x20"), 1, 7)]
    ref.resolution_changes_version = 7
    ref.run(sim.new_process(name="master"))
    balancer = ResolutionBalancer([(b"", b"\xff", 0)],
                                  expected_proxies=["p0", "p1"])
    balancer.resolution_changes = [(pt.KeyRange(b"\x10", b"\x20"), 1, 7)]
    balancer.resolution_changes_version = 7
    port = Master(clock=clock, balancer=balancer)
    nums = {"p0": 0, "p1": 0}

    def fields(r):
        return ([(c[0].begin, c[0].end, c[1], c[2])
                 for c in r.resolver_changes], r.resolver_changes_version)

    async def go():
        handed = []
        for pid in ["p0", "p0", "p1", "p0", "p1"]:
            clock.t += 1.0
            nums[pid] += 1
            want = await RequestStream.at(
                ref.interface.get_commit_version.endpoint).get_reply(
                ri.GetCommitVersionRequest(request_num=nums[pid],
                                           proxy_id=pid))
            got = port_ask(port.serve_commit_version,
                           pi.GetCommitVersionRequest(nums[pid], pid))
            assert fields(got) == fields(want)
            assert got.version == want.version
            handed.append(len(got.resolver_changes))
        return handed

    assert run(loop, go()) == [1, 1, 1, 0, 0]
