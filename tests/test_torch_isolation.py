"""The port stands alone: it imports neither JAX nor the JAX package, and
it never falls back to the CPU on its own (a supervised set asked for the
card when there is none raises rather than beginning degraded).  Batches that leave the compact
point layout take the general interval path."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = [
    "foundationdb_tpu_torch", "foundationdb_tpu_torch.kernels",
    "foundationdb_tpu_torch.core.knobs", "foundationdb_tpu_torch.core.error",
    "foundationdb_tpu_torch.core.rng", "foundationdb_tpu_torch.core.buggify",
    "foundationdb_tpu_torch.core.scheduler",
    "foundationdb_tpu_torch.core.futures",
    "foundationdb_tpu_torch.core.trace",
    "foundationdb_tpu_torch.core.histogram",
    "foundationdb_tpu_torch.conflict.api",
    "foundationdb_tpu_torch.conflict.supervisor",
    "foundationdb_tpu_torch.conflict.torch_backend",
    "foundationdb_tpu_torch.conflict.fused",
    "foundationdb_tpu_torch.conflict.window",
    "foundationdb_tpu_torch.conflict.oracle",
    "foundationdb_tpu_torch.conflict.encoded",
    "foundationdb_tpu_torch.ops.digest", "foundationdb_tpu_torch.ops.scan",
    "foundationdb_tpu_torch.ops.rangemax",
    "foundationdb_tpu_torch.ops.segtree", "foundationdb_tpu_torch.ops.sort",
    "foundationdb_tpu_torch.ops.shard", "foundationdb_tpu_torch.parallel",
    "foundationdb_tpu_torch.parallel.sharded_window",
    "foundationdb_tpu_torch.parallel.sharded_resolver",
    "foundationdb_tpu_torch.conflict.heat", "foundationdb_tpu_torch.server",
    "foundationdb_tpu_torch.server.interfaces",
    "foundationdb_tpu_torch.server.notified",
    "foundationdb_tpu_torch.server.resolver",
    "foundationdb_tpu_torch.server.shardmap",
    "foundationdb_tpu_torch.server.system_data",
    "foundationdb_tpu_torch.server.commit_proxy",
    "foundationdb_tpu_torch.server.master",
    "foundationdb_tpu_torch.server.cluster",
    "foundationdb_tpu_torch.server.grv_proxy",
    "foundationdb_tpu_torch.server.ratekeeper",
    "foundationdb_tpu_torch.server.tlog",
    "foundationdb_tpu_torch.server.storage",
    "foundationdb_tpu_torch.server.disk_queue",
    "foundationdb_tpu_torch.server.real_fs",
    "foundationdb_tpu_torch.server.kvstore",
    "foundationdb_tpu_torch.server.kvstore_btree",
    "foundationdb_tpu_torch.server.worker",
    "foundationdb_tpu_torch.txn.atomic", "foundationdb_tpu_torch.core.wire",
    "foundationdb_tpu_torch.sched", "foundationdb_tpu_torch.sched.predictor",
    "foundationdb_tpu_torch.sched.reorder",
    "foundationdb_tpu_torch.sched.repair", "foundationdb_tpu_torch.entry",
    "foundationdb_tpu_torch.rpc", "foundationdb_tpu_torch.rpc.endpoint",
    "foundationdb_tpu_torch.rpc.network", "foundationdb_tpu_torch.rpc.sim",
    "foundationdb_tpu_torch.rpc.peer_metrics",
    "foundationdb_tpu_torch.rpc.failure_monitor",
    "foundationdb_tpu_torch.rpc.serde",
    "foundationdb_tpu_torch.rpc.real_network",
    "foundationdb_tpu_torch.rpc.transport",
    "foundationdb_tpu_torch.core.threadpool",
    "foundationdb_tpu_torch.server.failure",
    "foundationdb_tpu_torch.client", "foundationdb_tpu_torch.client.database",
    "foundationdb_tpu_torch.client.writemap",
    "foundationdb_tpu_torch.testing",
    "foundationdb_tpu_torch.testing.workload",
    "foundationdb_tpu_torch.testing.workloads",
    "chip_smoke", "scripts.torch_kernel_ab"]


def test_port_imports_no_jax():
    """In a fresh interpreter, importing every port module (and
    chip_smoke), then a supervised set on the CPU resolving and folding a
    batch, degrading once and promoting once, the Resolver role answering
    a resolve, a metrics, a split and a heat request, a two-resolver
    resolution plane resolving a straddling batch and taking a balancing
    step, then admitting, reordering, repairing and committing a batch
    with every scheduling stage on and feeding its predictors, a static
    cluster committing a batch with an atomic, a versionstamp and a
    shard split through its master, TLogs on disk and storage servers and
    reading it back, then serving a client's transactions and a small
    Cycle through database() on the port's event loop (every role in a
    simulated process on the port's SimNetwork), a Resolver role
    answering over TCP on a real-mode loop (serde frames), and both entry
    points on the CPU (so the lazy imports have run), loads no jax and
    no foundationdb_tpu module."""
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from foundationdb_tpu_torch.conflict.api import new_conflict_set\n"
        "from foundationdb_tpu_torch.conflict.supervisor import "
        "BackendHealthMonitor, SupervisedConflictSet\n"
        "from foundationdb_tpu_torch.conflict.torch_backend import "
        "TorchConflictSet\n"
        "from foundationdb_tpu_torch.txn.types import "
        "CommitTransactionRef, KeyRange\n"
        "sup = SupervisedConflictSet(lambda oldest_version=0: "
        "TorchConflictSet(oldest_version, device='cpu', capacity=1 << 10),"
        " monitor=BackendHealthMonitor(reprobe_interval_s=0.0))\n"
        "w = CommitTransactionRef(write_conflict_ranges=[KeyRange(b'a', "
        "b'b')])\n"
        "r = CommitTransactionRef(read_snapshot=50, "
        "read_conflict_ranges=[KeyRange(b'a', b'b')])\n"
        "assert [int(v) for v in sup.resolve([w], 100)] == [2]\n"
        "sup.force_device_error = ['timeout']\n"
        "assert [int(v) for v in sup.resolve([r], 200)] == [0]\n"
        "assert [int(v) for v in sup.resolve_with_conflicts([r], 300)[0]]"
        " == [0]\n"
        "st = sup.status()\n"
        "assert (st['degrades'], st['promotions'], st['device_batches'])"
        " == (1, 1, 2), st\n"
        "from foundationdb_tpu_torch.core.histogram import emit_collection\n"
        "emit_collection(sup.metrics, 1.0)\n"
        "assert type(new_conflict_set('cpu')).__name__ == "
        "'OracleConflictSet'\n"
        "from foundationdb_tpu_torch.server import (Resolver, "
        "ResolveTransactionBatchRequest, ResolutionMetricsRequest, "
        "ResolutionSplitRequest, ResolverHeatRequest)\n"
        "got = []\n"
        "class Reply:\n"
        "    def send(self, v):\n"
        "        got.append(v)\n"
        "role = Resolver('ri', 0, backend='torch', device='cpu', "
        "capacity=1 << 10)\n"
        "role.resolve_batch(ResolveTransactionBatchRequest(0, 100, 0, "
        "[w, r], txn_state_transactions=[0], proxy_id='p0', "
        "reply=Reply()))\n"
        "assert [int(v) for v in got[0].committed] == [2, 0], got\n"
        "role.serve_metrics(ResolutionMetricsRequest(reply=Reply()))\n"
        "role.serve_split(ResolutionSplitRequest(reply=Reply()))\n"
        "role.serve_heat(ResolverHeatRequest(reply=Reply()))\n"
        "assert got[1:3] == [2, None] and len(got[3]) == 1, got\n"
        "role.emit_heat_once()\n"
        "from foundationdb_tpu_torch.server import ResolutionPlane\n"
        "plane = ResolutionPlane(2, ['p0'], device='cpu', "
        "capacity=1 << 10)\n"
        "s = CommitTransactionRef(read_conflict_ranges=[KeyRange(b'a', "
        "b'\\x90')], write_conflict_ranges=[KeyRange(b'\\x85', "
        "b'\\x86')])\n"
        "assert [int(v) for v in plane.resolve('p0', [s], 0, 100)"
        ".committed] == [2]\n"
        "assert plane.balance(100) is None\n"
        "from foundationdb_tpu_torch.core.knobs import server_knobs\n"
        "from foundationdb_tpu_torch.server import "
        "CommitTransactionRequest, Reply\n"
        "k = server_knobs()\n"
        "k.SCHED_PREDICTOR_ENABLED = k.SCHED_REORDER_ENABLED = "
        "k.SCHED_REPAIR_ENABLED = True\n"
        "t = CommitTransactionRef(read_snapshot=50, "
        "read_conflict_ranges=[KeyRange(b'\\x85', b'\\x86')], "
        "write_conflict_ranges=[KeyRange(b'c', b'd')], "
        "report_conflicting_keys=True, tag='t')\n"
        "reqs = [CommitTransactionRequest(t, repair_eligible=True, "
        "reply=Reply()), CommitTransactionRequest(s, reply=Reply())]\n"
        "reqs = plane.admit('p0', reqs, 100)\n"
        "rep = plane.commit('p0', reqs, 100, 200)\n"
        "assert [r.reply.sent for r in reqs] == [False, True], reqs\n"
        "assert plane.commit('p0', rep, 200, 300) == []\n"
        "assert reqs[0].reply.value.version == 300, reqs[0].reply.value\n"
        "assert plane.feed() and plane.proxies['p0'].scheduler_status()"
        "['repairs_succeeded'] == 1\n"
        "k.SCHED_PREDICTOR_ENABLED = k.SCHED_REORDER_ENABLED = "
        "k.SCHED_REPAIR_ENABLED = False\n"
        "import tempfile\n"
        "from foundationdb_tpu_torch.server import (StaticCluster, "
        "key_servers_key, key_servers_value)\n"
        "from foundationdb_tpu_torch.txn.types import Mutation, "
        "MutationType\n"
        "c = StaticCluster(2, ['p0', 'p1'], n_storage=2, n_tlogs=2, "
        "replication=2, datadir=tempfile.mkdtemp(), device='cpu', "
        "capacity=1 << 10)\n"
        "c.load([b'a', b'b'], [b'1', b'2'])\n"
        "ms = [Mutation(MutationType.AddValue, b'a', b'\\x01'), "
        "Mutation(MutationType.SetVersionstampedKey, b'v' + bytes(10) + "
        "b'\\x01\\x00\\x00\\x00', b'x'), Mutation.set_value("
        "key_servers_key(b'b'), key_servers_value([1, 0]))]\n"
        "q = CommitTransactionRequest(CommitTransactionRef("
        "mutations=ms, read_snapshot=c.read_version()), reply=Reply())\n"
        "[(_, v)] = c.commit('p1', [q])\n"
        "assert q.reply.value.version == v == c.read_version(), q.reply\n"
        "c.pull()\n"
        "assert c.get(b'a', v) == [b'2', b'2'], c.get(b'a', v)\n"
        "assert len(c.get_range(b'v', b'w', v)[1]) == 1\n"
        "from foundationdb_tpu_torch.core.scheduler import EventLoop\n"
        "from foundationdb_tpu_torch.testing import CycleWorkload\n"
        "loop = EventLoop()\n"
        "c.start(loop)\n"
        "db = c.database()\n"
        "async def txn():\n"
        "    t = db.create_transaction()\n"
        "    t.set(b'c', await t.get(b'a'))\n"
        "    t.set_versionstamped_value(b'd', bytes(10), 0)\n"
        "    await t.commit()\n"
        "    t2 = db.create_transaction()\n"
        "    return await t2.get_range(b'a', b'd', reverse=True)\n"
        "got = c.run_until(loop.spawn(txn()))\n"
        "assert [k for k, _ in got] == [b'c', b'b', b'a'], got\n"
        "w = CycleWorkload(c, db, {'nodeCount': 8, 'actorCount': 2, "
        "'testDuration': 0.005})\n"
        "c.run_until(loop.spawn(w.setup()))\n"
        "c.run_until(loop.spawn(w.start()))\n"
        "assert c.run_until(loop.spawn(w.check())) and w.metrics['swaps']\n"
        "c.close()\n"
        "from foundationdb_tpu_torch.rpc import serde\n"
        "from foundationdb_tpu_torch.rpc.network import set_network\n"
        "from foundationdb_tpu_torch.rpc.real_network import "
        "RealNetwork, RealProcess\n"
        "from foundationdb_tpu_torch.rpc.endpoint import RequestStream\n"
        "rl = EventLoop(sim=False)\n"
        "from foundationdb_tpu_torch.core.scheduler import set_event_loop\n"
        "set_event_loop(rl)\n"
        "srv, cli = RealNetwork(rl), RealNetwork(rl)\n"
        "set_network(cli)\n"
        "rr = Resolver('rt', 0, backend='torch', device='cpu', "
        "capacity=1 << 10)\n"
        "rr.run(RealProcess(rl, srv))\n"
        "ri = serde.decode_message(serde.encode_message(rr.interface))\n"
        "rep = rl.run_until(RequestStream.at(ri.resolve.endpoint)"
        ".get_reply(ResolveTransactionBatchRequest(0, 100, 0, [CommitTransactionRef("
        "write_conflict_ranges=[KeyRange(b'a', b'b')]), r], "
        "proxy_id='p0')), timeout=30)\n"
        "assert [int(v) for v in rep.committed] == [2, 0], rep\n"
        "srv.close()\n"
        "cli.close()\n"
        "from foundationdb_tpu_torch.entry import entry, dryrun_multichip\n"
        "fn, args = entry('cpu')\n"
        "assert int(fn(*args).sum()) == 0\n"
        "dryrun_multichip(2, 'cpu')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'foundationdb_tpu' or "
        "m.startswith('foundationdb_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_device_raises_without_cuda(monkeypatch, tmp_path):
    import numpy as np
    from foundationdb_tpu_torch.conflict import fused, window
    from foundationdb_tpu_torch.conflict.api import new_conflict_set
    from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
    from foundationdb_tpu_torch.parallel import make_conflict_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchConflictSet()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        new_conflict_set("torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        new_conflict_set("torch-raw")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        new_conflict_set("sharded")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_conflict_mesh()
    from foundationdb_tpu_torch.server import ResolutionPlane, StaticCluster
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResolutionPlane(2, ["p0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StaticCluster(2, ["p0"], datadir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        window.make_window_state(256)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fused.make_delta_state(256)
    st = window.make_window_state(256, 0, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        window.window_state_from_numpy(*window.window_state_to_numpy(st))
    assert fused.make_delta_state(256, "cpu").bk.device.type == "cpu"
    assert window.window_state_from_numpy(
        np.zeros((8, 4), np.uint32), np.zeros(4, np.int32), 1,
        device="cpu").bv.device.type == "cpu"
    assert TorchConflictSet(device="cpu").device.type == "cpu"
    assert isinstance(new_conflict_set("cpu"), OracleConflictSet)
    with pytest.raises(ValueError):
        new_conflict_set("tpu")


def test_kernel_impl_needs_a_cuda_tensor():
    """impl="kernel" on a CPU tensor raises instead of running the plain
    version; an unknown impl raises too."""
    from foundationdb_tpu_torch.ops.scan import inclusive_scan
    x = torch.ones(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        inclusive_scan(x, impl="kernel")
    with pytest.raises(ValueError):
        inclusive_scan(x, impl="fast")
    assert inclusive_scan(x).tolist() == list(range(1, 9))


def test_general_interval_batch_raises():
    """A range read (not all_point) takes the general interval path, which
    no longer raises: it resolves as the oracle does (a later range read
    over the written key conflicts)."""
    from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
    from foundationdb_tpu_torch.txn.types import CommitTransactionRef, KeyRange
    cs = TorchConflictSet(device="cpu", capacity=1 << 10)
    oracle = OracleConflictSet(0)
    txn = CommitTransactionRef(read_conflict_ranges=[KeyRange(b"a", b"c")],
                               write_conflict_ranges=[KeyRange(b"a",
                                                               b"a\x00")],
                               read_snapshot=0)
    for now in (10, 20):
        got = [int(v) for v in cs.resolve([txn], now)]
        assert got == [int(v) for v in oracle.resolve([txn], now)]
    assert got == [0]
    assert cs.profile["general_batches"] == 2
    assert cs.profile["compact_batches"] == 0


def test_digest_adjacent_writes_raise():
    """Point batches that _pack_compact rejects (two written keys whose
    digests are adjacent: k and k + b"\\x00") no longer raise: they take
    the general interval path and commit, as in the oracle."""
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
    from foundationdb_tpu_torch.txn.types import CommitTransactionRef, KeyRange
    cs = TorchConflictSet(device="cpu", capacity=1 << 10)
    txns = [CommitTransactionRef(write_conflict_ranges=[KeyRange(k, k + b"\0")])
            for k in (b"k", b"k\x00")]
    assert [int(v) for v in cs.resolve(txns, 10)] == [2, 2]
    assert cs.profile["general_batches"] == 1
    # The same keys in separate batches take the compact path.
    assert [int(v) for v in cs.resolve(txns[:1], 20)] == [2]
    assert cs.profile["compact_batches"] == 1


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory without the rest of the repository
    exits non-zero and prints no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_sources_name_no_jax():
    """No source file of the port imports jax or the JAX package."""
    pkg = os.path.join(REPO, "foundationdb_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            text = open(os.path.join(root, f)).read()
            for line in text.splitlines():
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    assert "jax" not in s, (f, s)
                    assert "foundationdb_tpu" not in s.replace(
                        "foundationdb_tpu_torch", ""), (f, s)
