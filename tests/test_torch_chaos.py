"""The port's own simulator (foundationdb_tpu_torch/testing/tester.py
run_simulation over its SimFdbCluster) against the JAX package's
tests/test_chaos.py.

  * A same-seed double run of ChaosTest.toml (the nemesis, Cycle and
    ConsistencyCheck, two resolvers with resolver attrition) gives equal
    unseeds, digests, fold counts and metrics, an empty nondeterminism
    audit, and at least one fault loop fired: on the "native" set, and
    once on the plain torch set at tests/test_torch_cluster.py's
    capacity (2^10, delta 2^8).
  * The injected divergence: a double run of NondeterminismCanary fails
    with "unseed mismatch", and the audit names time.time_ns in
    testing/workloads.py.
  * The seven disk-fault cases of test_chaos.py (:149-380), each on the
    port's synchronous files: bit rot caught by the disk queue's frame
    CRC, a live read's CRC, the B-tree's header slot and data page CRCs,
    a storage server's death on an fsync io_error and its restart, a
    TLog's death on one, and the fault profile's mechanics.
  * CycleTest.toml and SerializabilityTest.toml run with their
    invariants (the ring stays one cycle; the database equals
    ConflictRange's model).

The `cuda` variants run CycleTest.toml and the ChaosTest double run with
the Resolver roles' sets on the card.
"""

import os
from types import SimpleNamespace

import pytest
import torch

from foundationdb_tpu_torch.core import coverage
from foundationdb_tpu_torch.core.error import FdbError
from foundationdb_tpu_torch.core.rng import (DeterministicRandom,
                                             set_deterministic_random)
from foundationdb_tpu_torch.core.scheduler import (EventLoop, delay,
                                                   set_event_loop)
from foundationdb_tpu_torch.rpc.sim import set_simulator
from foundationdb_tpu_torch.testing import run_simulation, run_test_twice

SPECS = os.path.join(os.path.dirname(__file__), "specs")
SEED = 107
SET_KWARGS = dict(capacity=1 << 10, delta_capacity=1 << 8)


def spec(name: str) -> str:
    with open(os.path.join(SPECS, name)) as f:
        return f.read()


@pytest.fixture()
def teardown():
    set_deterministic_random(DeterministicRandom(21))
    yield
    set_simulator(None)
    set_event_loop(None)


@pytest.fixture()
def loop():
    lp = EventLoop(sim=True)
    set_event_loop(lp)
    yield lp
    set_event_loop(None)


def check_chaos_pair(r1, r2) -> None:
    assert (r1.unseed, r1.digest, r1.folds) == (r2.unseed, r2.digest,
                                                r2.folds)
    assert r1.folds > 0
    assert r1.metrics == r2.metrics
    assert r1.metrics["Cycle"]["swaps"] > 0
    nem = r1.metrics["ChaosNemesis"]
    assert (nem["swizzles"] + nem["reboots"] + nem["power_fails"] +
            nem["kills"] + nem["partitions"] + nem["resolver_kills"]) > 0
    assert r1.nondeterminism == [] and r2.nondeterminism == []


def test_chaos_double_run_unseed_identical(teardown):
    """ChaosTest.toml twice at one seed on the native set: one run."""
    r1, r2 = run_test_twice(spec("ChaosTest.toml"), SEED, device="cpu",
                            backend="native")
    check_chaos_pair(r1, r2)
    assert coverage.covered("ChaosNemesisSwizzle") or \
        coverage.covered("ChaosNemesisAttrition") or \
        coverage.covered("ChaosNemesisPartition")


def test_chaos_double_run_on_the_torch_set(teardown):
    """ChaosTest.toml twice at one seed on the plain torch set (the
    supervised set over TorchConflictSet on the CPU)."""
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r1, r2 = run_test_twice(spec("ChaosTest.toml"), SEED, device="cpu",
                                backend="torch", **SET_KWARGS)
    finally:
        torch.set_num_threads(torch_threads)
    check_chaos_pair(r1, r2)
    assert r1.metrics["ChaosNemesis"]["resolver_kills"] > 0


def test_injected_divergence_fails_unseed_check(teardown):
    """A workload that reads the wall clock fails the unseed check, and
    the audit names the source."""
    canary = """
[[test]]
testTitle = 'NondetCanary'
  [[test.workload]]
  testName = 'NondeterminismCanary'
"""
    with pytest.raises(AssertionError) as ei:
        run_test_twice(canary, seed=13, n_workers=5, n_storage_workers=2,
                       device="cpu", backend="native")
    msg = str(ei.value)
    assert "unseed mismatch" in msg
    assert "divergen" in msg
    assert "time.time_ns" in msg and "testing/workloads.py" in msg


def test_cycle_test_invariant(teardown):
    """CycleTest.toml: swaps committed, the ring one cycle at the end
    (Cycle's check), clogs and kills made."""
    r = run_simulation(spec("CycleTest.toml"), SEED, device="cpu",
                       backend="native")
    assert r.metrics["Cycle"]["swaps"] > 0
    assert r.metrics["RandomClogging"]["clogs"] > 0
    assert r.metrics["Attrition"]["kills"] > 0
    assert r.nondeterminism == []


def test_serializability_test_invariant(teardown):
    """SerializabilityTest.toml: ConflictRange's sets and range clears
    read back equal to its model, ReadWrite's rows all present."""
    r = run_simulation(spec("SerializabilityTest.toml"), SEED, device="cpu",
                       backend="native")
    assert r.metrics["ReadWrite"]["operations"] > 0
    assert "ConflictRange" in r.metrics
    assert r.nondeterminism == []


# ---------------------------------------------------------------------------
# Disk faults: every detection path fires
# ---------------------------------------------------------------------------

def test_disk_queue_crc_catches_bitrot(loop):
    """Bit rot after a sync is caught by the frame CRC: a live read of a
    rotted record raises io_error, and recovery keeps a valid prefix."""
    from foundationdb_tpu_torch.server.disk_queue import DiskQueue
    from foundationdb_tpu_torch.server.sim_fs import (DiskFaultProfile,
                                                      SimFileSystem)
    set_deterministic_random(DeterministicRandom(21))
    fs = SimFileSystem()
    dq = DiskQueue(fs.open("t.wal"))
    seqs = [dq.push(b"payload-%04d" % i * 8) for i in range(8)]
    dq.commit()
    assert dq.read_payload(seqs[3]) is not None
    fs.set_fault_profile("t.wal", DiskFaultProfile(bitrot_sync_p=1.0))
    dq.push(b"one-more")
    dq.commit()
    fs.clear_fault_profiles()
    assert coverage.covered("SimDiskBitRotInjected")
    hits0 = coverage.hits("DiskQueueCrcCaught")
    detected = False
    for seq in seqs + [dq.next_seq - 1]:
        try:
            dq.read_payload(seq)
        except FdbError as e:
            assert e.name == "io_error"
            detected = True
    records = DiskQueue(fs.open("t.wal")).recover()
    if not detected:
        # The rot hit a header: recovery's checks cut the frame there.
        assert len(records) < 9
    assert coverage.hits("DiskQueueCrcCaught") > hits0


def test_disk_queue_live_read_crc_io_error(loop):
    """One durable payload byte flipped: the live read raises io_error;
    a flipped `popped` header field is caught too."""
    from foundationdb_tpu_torch.server.disk_queue import _HDR, DiskQueue
    from foundationdb_tpu_torch.server.sim_fs import SimFileSystem
    fs = SimFileSystem()
    f = fs.open("q.wal")
    dq = DiskQueue(f)
    seq = dq.push(b"X" * 64)
    dq.commit()
    offset, _length = dq._index[seq]

    def flip(i, bit):
        f.durable[i] ^= bit
        f.cache[i] ^= bit

    flip(offset + 10, 0x40)
    hits0 = coverage.hits("DiskQueueCrcCaught")
    with pytest.raises(FdbError) as ei:
        dq.read_payload(seq)
    assert ei.value.name == "io_error"
    assert coverage.hits("DiskQueueCrcCaught") == hits0 + 1
    flip(offset + 10, 0x40)                     # heal the payload
    assert dq.read_payload(seq) is not None
    flip(offset - _HDR.size + 12, 0x01)         # rot `popped`
    with pytest.raises(FdbError):
        dq.read_payload(seq)


def test_btree_header_slot_crc(loop):
    """A rotted header slot fails its CRC and recovery takes the other,
    older but whole, tree."""
    from foundationdb_tpu_torch.server.kvstore_btree import (PAGE_SIZE,
                                                             KVStoreBTree)
    from foundationdb_tpu_torch.server.sim_fs import SimFileSystem
    fs = SimFileSystem()
    kv = KVStoreBTree(fs, "ss")
    kv.set(b"k1", b"v1")
    kv.commit()                 # commit_seq 1 -> slot 1
    kv.set(b"k2", b"v2")
    kv.commit()                 # commit_seq 2 -> slot 0
    f = fs.open("ss.btree")
    f.durable[0 * PAGE_SIZE + 8] ^= 0x01
    f.cache[0 * PAGE_SIZE + 8] ^= 0x01
    hits0 = coverage.hits("BTreeSlotCrcCaught")
    kv2 = KVStoreBTree(fs, "ss")
    kv2.recover()
    assert coverage.hits("BTreeSlotCrcCaught") == hits0 + 1
    assert kv2.commit_seq == 1
    assert kv2.read_value(b"k1") == b"v1"
    assert kv2.read_value(b"k2") is None


def test_btree_data_page_crc(loop):
    """A flipped bit in a data page (one that still decodes) fails the
    page CRC and raises io_error; it is never served."""
    from foundationdb_tpu_torch.server.kvstore_btree import (PAGE_SIZE,
                                                             KVStoreBTree)
    from foundationdb_tpu_torch.server.sim_fs import SimFileSystem
    fs = SimFileSystem()
    kv = KVStoreBTree(fs, "ss")
    kv.set(b"key", b"value-a")
    kv.commit()
    f = fs.open("ss.btree")
    f.durable[2 * PAGE_SIZE + 20] ^= 0x01
    f.cache[2 * PAGE_SIZE + 20] ^= 0x01
    kv2 = KVStoreBTree(fs, "ss")
    with pytest.raises(FdbError) as ei:
        kv2.recover()
        kv2.read_value(b"key")
    assert ei.value.name == "io_error"


def test_storage_io_error_death_and_rerecruitment(teardown):
    """An io_error on a storage engine's fsync kills its process; commits
    go on on the surviving replicas; a restart on the same machine
    recovers the engine and rejoins."""
    from foundationdb_tpu_torch.server.cluster import SimFdbCluster
    from foundationdb_tpu_torch.server.interfaces import \
        DatabaseConfiguration
    from foundationdb_tpu_torch.server.sim_fs import DiskFaultProfile

    c = SimFdbCluster(config=DatabaseConfiguration(
        n_tlogs=2, log_replication=2, n_storage=3, storage_replication=2),
        n_workers=8, n_storage_workers=3, device="cpu", **SET_KWARGS)
    db = c.database()

    async def put(key, value):
        t = db.create_transaction()
        while True:
            try:
                t.set(key, value)
                await t.commit()
                return
            except FdbError as e:
                await t.on_error(e)

    async def go():
        for i in range(16):
            await put(bytes([i * 16]) + b"/seed", b"v%02d" % i)
        victim = c.workers[0][0]
        assert victim.process_class == "storage"
        fs = c.sim.fs_for(victim)
        hits0 = coverage.hits("StorageIoErrorDeath")
        fs.set_fault_profile("storage-", DiskFaultProfile(
            io_error_sync_p=1.0, max_io_errors=1))
        for i in range(400):
            await put(b"churn/%04d" % i, b"x")
            if not victim.alive:
                break
            await delay(0.1)
        assert not victim.alive, "io_error never killed the storage server"
        assert coverage.hits("StorageIoErrorDeath") > hits0
        await put(b"during/outage", b"ok")
        fs.clear_fault_profiles()
        c.restart_worker(0)
        await delay(2.0)
        await put(b"after/restart", b"ok")
        t = db.create_transaction()
        while True:
            try:
                assert await t.get(b"after/restart") == b"ok"
                assert await t.get(b"during/outage") == b"ok"
                assert await t.get(bytes([0]) + b"/seed") == b"v00"
                break
            except FdbError as e:
                await t.on_error(e)
        assert c.workers[0][0].alive
        return True

    assert c.run_until(c.loop.spawn(go()), timeout=600)


def test_tlog_fsync_io_error_kills_process(loop):
    """A TLog whose fsync fails dies and acknowledges nothing: the
    commit raises io_error, its process is told to die, and the durable
    version does not move."""
    from foundationdb_tpu_torch.server.disk_queue import DiskQueue
    from foundationdb_tpu_torch.server.interfaces import TLogCommitRequest
    from foundationdb_tpu_torch.server.sim_fs import (DiskFaultProfile,
                                                      SimFileSystem)
    from foundationdb_tpu_torch.server.tlog import TLog
    from foundationdb_tpu_torch.txn.types import Mutation, MutationType
    fs = SimFileSystem()
    fs.set_fault_profile("tlog-", DiskFaultProfile(io_error_sync_p=1.0))
    tlog = TLog("logx", 0, disk_queue=DiskQueue(fs.open("tlog-x.wal")))
    died = []
    tlog._process = SimpleNamespace(die=lambda reason: died.append(reason))
    hits0 = coverage.hits("TLogIoErrorDeath")
    replies = []
    req = TLogCommitRequest(
        prev_version=0, version=1, known_committed_version=0,
        messages={0: [Mutation(MutationType.SetValue, b"k", b"v")]},
        reply=SimpleNamespace(send=replies.append,
                              send_error=replies.append))
    with pytest.raises(FdbError) as ei:
        tlog.commit(req)
    assert ei.value.name == "io_error"
    assert died and "TLogDiskError" in died[0]
    assert coverage.hits("TLogIoErrorDeath") == hits0 + 1
    assert tlog.durable_version == 0
    assert replies == []


def test_sim_fs_fault_profile_injection(loop):
    """Profile mechanics: io_error on write, the budget, untargeted files
    healthy, latency spikes drawn and counted."""
    from foundationdb_tpu_torch.server.sim_fs import (DiskFaultProfile,
                                                      SimFileSystem)
    set_deterministic_random(DeterministicRandom(21))
    fs = SimFileSystem()
    fs.set_fault_profile("bad", DiskFaultProfile(
        io_error_write_p=1.0, max_io_errors=2))
    bad = fs.open("bad.file")
    ok = fs.open("good.file")
    for _ in range(2):
        with pytest.raises(FdbError) as ei:
            bad.write(0, b"x")
        assert ei.value.name == "io_error"
    bad.write(0, b"x")          # the budget is spent: a healthy disk
    bad.sync()
    assert bytes(bad.durable) == b"x"
    ok.write(0, b"y")
    ok.sync()
    fs.set_fault_profile("good", DiskFaultProfile(latency_spike_p=1.0))
    ok.write(4, b"z")
    assert ok.latency_spikes == 1
    assert ok.read(0, 5) == b"y\x00\x00\x00z"


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cycle_on_the_card(teardown):
    """CycleTest.toml with the Resolver roles' sets on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    r = run_simulation(spec("CycleTest.toml"), SEED, device="cuda")
    assert r.metrics["Cycle"]["swaps"] > 0
    assert r.nondeterminism == []


@pytest.mark.cuda
def test_chaos_double_run_on_the_card(teardown):
    """The ChaosTest.toml double run with the sets on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    r1, r2 = run_test_twice(spec("ChaosTest.toml"), SEED, device="cuda")
    check_chaos_pair(r1, r2)
