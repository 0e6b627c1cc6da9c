"""The port's TLog spill, lock and recovery held against the JAX
package's.

The reference's are foundationdb_tpu/server/tlog.py (_maybe_spill, the
spilled tier of _peek and _pop, from_disk, write_genesis, recover_from,
_lock), run in its simulated event loop over SimFileSystem; the port's
are foundationdb_tpu_torch/server/tlog.py over real files.  Each case
feeds both the same seeded commits, pops and peeks, with tolerance 0
(everything is bytes, ints and enums):

  (a) with TLOG_SPILL_THRESHOLD lowered in both packages, the same spilled
      references, resident data, byte counters and queue-file bytes after
      every step, and the same peek replies, spilled tier and cuts under a
      lowered TLOG_PEEK_DESIRED_BYTES included;
  (b) from_disk over the reference's durable image copied into the
      port's file, cut at a torn tail and with a bit flipped, gives the
      same state and the same file after;
  (c) recover_from plus write_genesis give the same queue bytes and
      state, and a locked TLog answers its lock as the reference's does
      and refuses every commit after;
  (d) the reference's one-peek recovery: recover_from peeks each tag once,
      so a backlog over TLOG_PEEK_DESIRED_BYTES reaches the reference's
      new generation without its tail; the port pages through the cut
      and carries every version;

  (e) the reference's genesis record repeats the recovery version of
      its last carried record: rebuilt from disk with every entry
      spilled, the reference's peek skips that version; the port's reads
      it;

and a spilled record that fails its CRC makes peek raise (and stop the
role) rather than skip it.
"""

import random

import pytest

from foundationdb_tpu.core.futures import Promise
from foundationdb_tpu.core.knobs import server_knobs as ref_knobs
from foundationdb_tpu.server import disk_queue as ref_dq
from foundationdb_tpu.server import interfaces as ri
from foundationdb_tpu.server import tlog as ref_tlog
from foundationdb_tpu.server.sim_fs import SimFileSystem
from foundationdb_tpu.txn import types as rt
from foundationdb_tpu_torch.core.error import FdbError
from foundationdb_tpu_torch.core.knobs import server_knobs
from foundationdb_tpu_torch.server import interfaces as pi
from foundationdb_tpu_torch.server import tlog as port_tlog
from foundationdb_tpu_torch.server.disk_queue import DiskQueue
from foundationdb_tpu_torch.txn import types as pt
from test_torch_tlog import (TAGS, as_tuples, file_bytes, loop,  # noqa: F401
                             muts, port_file, rand_key, ref_commit, ref_peek,
                             reply_fields, run)


@pytest.fixture()
def knobs():
    """Sets TLOG_SPILL_THRESHOLD and TLOG_PEEK_DESIRED_BYTES in both
    packages, restored after."""
    regs = [ref_knobs(), server_knobs()]
    names = ("TLOG_SPILL_THRESHOLD", "TLOG_PEEK_DESIRED_BYTES")
    saved = [[getattr(k, n) for n in names] for k in regs]

    def set_(spill=None, peek=None):
        for k in regs:
            if spill is not None:
                k.TLOG_SPILL_THRESHOLD = spill
            if peek is not None:
                k.TLOG_PEEK_DESIRED_BYTES = peek
    yield set_
    for k, vals in zip(regs, saved):
        for n, v in zip(names, vals):
            setattr(k, n, v)


def rand_messages(rng):
    """{tag: [(type, p1, p2)]}: 0-4 tags, 1-3 mutations each, values up
    to 60 bytes, so a few versions pass a threshold of hundreds."""
    out = {}
    for tag in rng.sample(TAGS, rng.randrange(0, 5)):
        out[tag] = [(rng.choice([0, 1, 2]), rand_key(rng),
                     rand_key(rng, rng.randrange(0, 60)))
                    for _ in range(rng.randrange(1, 4))]
    return out


def full_state(t, version, durable):
    return {
        "tag_data": {tag: [(v, as_tuples(m)) for v, m in q]
                     for tag, q in t.tag_data.items()},
        "spilled": {tag: list(q) for tag, q in t.spilled.items()},
        "popped": dict(t.poppedtags), "version": version,
        "durable": durable, "kcv": t.known_committed_version,
        "bytes": (t.bytes_input, t.bytes_in_memory, t.bytes_spilled,
                  t.bytes_popped, dict(t.tag_bytes)),
        "records": [(v, s, set(tags)) for v, s, tags in t._record_seqs],
        "seq_of_version": dict(t._seq_of_version)}


def port_state(t):
    return full_state(t, t.version, t.durable_version)


def ref_state(t):
    return full_state(t, t.version.get(), t.durable_version.get())


def twin_tlogs(tmp_path, name="log0"):
    fs = SimFileSystem()
    ref = ref_tlog.TLog(name, disk_queue=ref_dq.DiskQueue(
        fs.open(name + ".wal")))
    port = port_tlog.TLog(name, disk_queue=DiskQueue(
        port_file(tmp_path, name + ".wal")))
    return fs, ref, port


async def drive_both(rng, ref, port, steps: int, peek_check=True,
                     pop_tags=TAGS):
    """Random commits, pops and peeks into both TLogs, state and file
    equal after every step; returns the last version."""
    version = 0
    for _ in range(steps):
        op = rng.random()
        if op < 0.55 or version == 0:
            prev, version = version, version + rng.randrange(1, 100)
            msgs = rand_messages(rng)
            want = await ref_commit(ref, version, prev, prev,
                                    {t: muts(rt, m) for t, m in msgs.items()})
            got = pi.ask(port.commit, pi.TLogCommitRequest(
                prev, version, prev,
                {t: muts(pt, m) for t, m in msgs.items()}))
            assert got == want == version
        elif op < 0.8 and peek_check:
            tag, begin = rng.choice(TAGS), rng.randrange(0, version + 1)
            want = await ref_peek(ref, tag, begin)
            got = pi.ask(port.peek, pi.TLogPeekRequest(tag, begin))
            assert reply_fields(got) == reply_fields(want)
        elif pop_tags:
            tag, to = rng.choice(pop_tags), rng.randrange(0, version + 1)
            ref._pop(ri.TLogPopRequest(tag=tag, to=to, reply=False))
            port.pop(pi.TLogPopRequest(tag=tag, to=to))
        assert port_state(port) == ref_state(ref)
        assert file_bytes(port.disk_queue.file) == \
            bytes(ref.disk_queue.file.durable)
    return version


# ---------------------------------------------------------- (a) spill
@pytest.mark.parametrize("seed", range(4))
def test_spill_matches_reference(loop, tmp_path, knobs, seed):  # noqa: F811
    rng = random.Random(seed)
    knobs(spill=rng.choice([300, 800]), peek=rng.choice([100, 400, 1e6]))
    _fs, ref, port = twin_tlogs(tmp_path)

    async def go():
        version = await drive_both(rng, ref, port, 80)
        # Every tag's whole backlog, spilled and resident, page by page.
        for tag in TAGS:
            begin = 0
            while begin <= version:
                want = await ref_peek(ref, tag, begin)
                got = pi.ask(port.peek, pi.TLogPeekRequest(tag, begin))
                assert reply_fields(got) == reply_fields(want)
                begin = want.end
        return version

    run(loop, go())
    assert port.bytes_spilled > 0 and any(port.spilled.values())


def test_stalled_tag_spills_and_is_read_back(loop, tmp_path,  # noqa: F811
                                             knobs):
    """After test_tlog_spill.py's stalled tag: tag 0 never pops, tag 1
    pops along; memory stays bounded, the spilled prefix is read back from
    the queue file whole and in order, and the pop trims both tiers."""
    knobs(spill=5_000, peek=1e6)
    _fs, ref, port = twin_tlogs(tmp_path)
    payload = b"x" * 100

    async def go():
        for v in range(1, 201):
            msgs = {0: [(0, b"k%04d" % v, payload)],
                    1: [(0, b"j%04d" % v, b"small")]}
            await ref_commit(ref, v, v - 1, v - 1,
                             {t: muts(rt, m) for t, m in msgs.items()})
            pi.ask(port.commit, pi.TLogCommitRequest(
                v - 1, v, v - 1, {t: muts(pt, m) for t, m in msgs.items()}))
            ref._pop(ri.TLogPopRequest(tag=1, to=v, reply=False))
            port.pop(pi.TLogPopRequest(tag=1, to=v))
        assert port_state(port) == ref_state(ref)
        want = await ref_peek(ref, 0, 1)
        return want

    want = run(loop, go())
    assert port.bytes_in_memory <= 6_000 < port.bytes_spilled
    got = pi.ask(port.peek, pi.TLogPeekRequest(0, 1))
    assert reply_fields(got) == reply_fields(want)
    assert [v for v, _m in got.messages] == list(range(1, 201))
    port.pop(pi.TLogPopRequest(tag=0, to=200))
    assert not port.spilled[0] and port.bytes_in_memory == 0


# ----------------------------------------------------- (b) from_disk
@pytest.mark.parametrize("seed", range(3))
def test_from_disk_matches_reference(loop, tmp_path, knobs,  # noqa: F811
                                     seed):
    rng = random.Random(100 + seed)
    knobs(spill=600, peek=1e6)
    _fs, ref, port = twin_tlogs(tmp_path)
    run(loop, drive_both(rng, ref, port, 50, peek_check=False,
                         pop_tags=[0, 1]))
    image = bytes(ref.disk_queue.file.durable)
    cases = [(len(image), None)] + \
        [(cut, None) for cut in sorted(rng.sample(range(len(image)), 3))] + \
        [(len(image), rng.randrange(len(image))) for _ in range(3)]
    for i, (cut, flip) in enumerate(cases):
        img = bytearray(image[:cut])
        if flip is not None:
            img[flip] ^= 1 << rng.randrange(8)
        sfs = SimFileSystem()
        sf = sfs.open("r.wal")
        sf.durable = bytearray(img)
        pf = port_file(tmp_path, "r%d.wal" % i)
        pf.write(0, bytes(img))
        pf.sync()

        async def ref_rebuild():
            return await ref_tlog.TLog.from_disk(
                "log0", ref_dq.DiskQueue(sf))

        want = run(loop, ref_rebuild())
        got = port_tlog.TLog.from_disk("log0", DiskQueue(pf))
        assert port_state(got) == ref_state(want)
        assert file_bytes(pf) == bytes(sf.durable)
        if cut == len(image) and flip is None:
            assert got.version == port.version
            assert got.tag_data.keys() == port.tag_data.keys()


# ------------------------------------- (c) recover_from, genesis, lock
def sim_process(name):
    """A process of the reference's simulator (made on first use)."""
    from foundationdb_tpu.rpc import sim as rsim
    if rsim._simulator is None:
        rsim.set_simulator(rsim.Simulator())
    return rsim.get_simulator().new_process(name=name)


async def ref_lock(t, epoch):
    p = Promise()
    await t._lock(ri.TLogLockRequest(epoch=epoch, reply=p))
    return await p.get_future()


def lock_fields(r):
    return (r.end_version, r.known_committed_version, dict(r.tags))


@pytest.mark.parametrize("seed", range(3))
def test_recover_from_and_genesis_match_reference(loop, tmp_path,  # noqa: F811
                                                  knobs, seed):
    rng = random.Random(200 + seed)
    knobs(spill=rng.choice([700, 1e9]), peek=1e6)
    fs, ref, port = twin_tlogs(tmp_path, "old")
    ref.run(sim_process("old"))
    popped = {}

    async def go():
        version = await drive_both(rng, ref, port, 40, peek_check=False,
                                   pop_tags=[0, 1, 2])
        want = await ref_lock(ref, 2)
        got = pi.ask(port.lock, pi.TLogLockRequest(epoch=2))
        assert lock_fields(got) == lock_fields(want)
        assert got.end_version == version
        # A locked TLog refuses commits: no reply on either side.
        p = Promise()
        await ref._commit(ri.TLogCommitRequest(
            prev_version=version, version=version + 1,
            known_committed_version=version, messages={}, reply=p))
        assert not p.is_set()
        with pytest.raises(FdbError) as e:
            pi.ask(port.commit, pi.TLogCommitRequest(
                version, version + 1, version, {}))
        assert e.value.name == "broken_promise"
        assert port.version == version
        popped.update({t: want.tags.get(t, 0) for t in (0, 1, 3)})
        rv = version - rng.randrange(0, 30)
        new_ref = ref_tlog.TLog("new", rv, epoch=2, disk_queue=ref_dq.
                                DiskQueue(fs.open("new.wal")))
        new_ref.run(sim_process("new"))
        await new_ref.recover_from({t: ref.interface for t in popped},
                                   popped, rv)
        await new_ref.write_genesis()
        return rv, new_ref

    rv, new_ref = run(loop, go())
    new_port = port_tlog.TLog("new", rv, epoch=2, disk_queue=DiskQueue(
        port_file(tmp_path, "new.wal")))
    new_port.recover_from({t: port for t in popped}, popped, rv)
    new_port.write_genesis()
    assert port_state(new_port) == ref_state(new_ref)
    assert file_bytes(new_port.disk_queue.file) == \
        bytes(new_ref.disk_queue.file.durable)
    # What was carried is every un-popped entry at or below rv.
    for tag in popped:
        want = [v for v, _m in port.tag_data.get(tag, ())
                if popped[tag] < v <= rv] + \
            [v for v, _s, _n in port.spilled.get(tag, ())
             if popped[tag] < v <= rv]
        assert [v for v, _m in new_port.tag_data[tag]] == sorted(want)


# ------------------------------------ (d) the one-peek recovery
def backlog(loop, tmp_path, n: int = 30):  # noqa: F811
    """An old generation (both packages) whose tag 0 holds `n` versions
    of ~215 bytes, locked; returns (ref, port, end version)."""
    fs, ref, port = twin_tlogs(tmp_path, "old")
    ref.run(sim_process("old"))

    async def go():
        for v in range(1, n + 1):
            msgs = {0: [(0, b"k%03d" % v, b"x" * 200)]}
            await ref_commit(ref, v, v - 1, v - 1,
                             {t: muts(rt, m) for t, m in msgs.items()})
            pi.ask(port.commit, pi.TLogCommitRequest(
                v - 1, v, v - 1, {t: muts(pt, m) for t, m in msgs.items()}))
        await ref_lock(ref, 2)
        pi.ask(port.lock, pi.TLogLockRequest(epoch=2))

    run(loop, go())
    return fs, ref, port, n


def test_reference_one_peek_recovery_loses_the_tail(loop, tmp_path,  # noqa: F811
                                                   knobs):
    """The reference's recover_from sends one peek a tag and ignores the
    reply's end: past TLOG_PEEK_DESIRED_BYTES the new generation gets
    only the first reply's versions, and a storage server pulling from it
    would advance past the rest."""
    knobs(spill=1e9, peek=2_000)
    fs, ref, _port, n = backlog(loop, tmp_path)
    new_ref = ref_tlog.TLog("new", n, epoch=2, disk_queue=ref_dq.DiskQueue(
        fs.open("new.wal")))
    new_ref.run(sim_process("new"))

    async def go():
        await new_ref.recover_from({0: ref.interface}, {0: 0}, n)
        return [v for v, _m in new_ref.tag_data[0]]

    carried = run(loop, go())
    assert carried == list(range(1, 11))        # 10 of the 30 versions
    assert len(carried) < n


@pytest.mark.parametrize("spill", [1e9, 1_500])
def test_port_recovery_pages_through_the_cut(loop, tmp_path, knobs,  # noqa: F811
                                            spill):
    """The port's recover_from pages through peek's budget up to the
    recovery version: every version reaches the new generation, resident
    or spilled in the old one, and its queue."""
    knobs(spill=spill, peek=2_000)
    _fs, _ref, port, n = backlog(loop, tmp_path)
    assert bool(port.bytes_spilled) == (spill < 1e9)
    new = port_tlog.TLog("new", n, epoch=2, disk_queue=DiskQueue(
        port_file(tmp_path, "new.wal")))
    new.recover_from({0: port}, {0: 0}, n)
    new.write_genesis()
    assert [v for v, _m in new.tag_data[0]] == list(range(1, n + 1))
    rebuilt = port_tlog.TLog.from_disk("new", DiskQueue(new.disk_queue.file))
    assert [v for v, _s, _n in rebuilt.spilled.get(0, ())] + \
        [v for v, _m in rebuilt.tag_data[0]] == list(range(1, n + 1))
    assert rebuilt.version == n


def test_spilled_read_error_raises(tmp_path, knobs):
    """A spilled record whose bytes rotted fails its CRC: peek raises
    io_error and the role stops; it never answers past the record."""
    knobs(spill=1_000, peek=1e6)
    t = port_tlog.TLog("log0", disk_queue=DiskQueue(port_file(tmp_path)))
    for v in range(1, 21):
        pi.ask(t.commit, pi.TLogCommitRequest(v - 1, v, v - 1, {
            0: muts(pt, [(0, b"k%02d" % v, b"y" * 100)])}))
    v, seq, _nb = t.spilled[0][0]
    off, _n = t.disk_queue._index[seq]
    f = t.disk_queue.file
    f.write(off + 3, bytes([f.read(off + 3, 1)[0] ^ 0x10]))
    with pytest.raises(FdbError) as e:
        pi.ask(t.peek, pi.TLogPeekRequest(0, 1))
    assert e.value.name == "io_error" and t.stopped


def test_genesis_does_not_shadow_the_last_carried_version(loop, tmp_path,  # noqa: F811
                                                          knobs):
    """A new generation's genesis record repeats its recovery version,
    which here is also its last carried version.  Rebuilt from disk with
    every entry spilled, the reference maps that version to the empty
    genesis record, and its peek skips the entry (a storage server would
    advance past it); the port keeps the record that holds it."""
    knobs(spill=1e9, peek=1e6)
    fs, ref, port, n = backlog(loop, tmp_path, n=5)
    new_ref = ref_tlog.TLog("new", n, epoch=2, disk_queue=ref_dq.DiskQueue(
        fs.open("new.wal")))
    new_ref.run(sim_process("new"))
    new_port = port_tlog.TLog("new", n, epoch=2, disk_queue=DiskQueue(
        port_file(tmp_path, "new.wal")))

    async def carry():
        await new_ref.recover_from({0: ref.interface}, {0: 0}, n)
        await new_ref.write_genesis()

    run(loop, carry())
    new_port.recover_from({0: port}, {0: 0}, n)
    new_port.write_genesis()
    image = bytes(new_ref.disk_queue.file.durable)
    assert file_bytes(new_port.disk_queue.file) == image
    knobs(spill=200)                     # from_disk spills every entry
    sfs = SimFileSystem()
    sfs.open("again.wal").durable = bytearray(image)

    async def reboot():
        t = await ref_tlog.TLog.from_disk("new", ref_dq.DiskQueue(
            sfs.open("again.wal")))
        return t, await ref_peek(t, 0, 1)

    again_ref, want = run(loop, reboot())
    again_port = port_tlog.TLog.from_disk("new", DiskQueue(
        new_port.disk_queue.file))
    assert [v for v, _s, _n in again_ref.spilled[0]] == \
        [v for v, _s, _n in again_port.spilled[0]] == list(range(1, n + 1))
    assert [v for v, _m in want.messages] == list(range(1, n))
    got = pi.ask(again_port.peek, pi.TLogPeekRequest(0, 1))
    assert [v for v, _m in got.messages] == list(range(1, n + 1))
