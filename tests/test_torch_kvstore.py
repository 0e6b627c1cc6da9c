"""The port's storage engines held against the JAX package's.

The reference's are foundationdb_tpu/server/kvstore.py (KVStoreMemory:
a WAL over DiskQueue, one record a commit, the snapshot with its CRC and
rename) and server/kvstore_btree.py (KVStoreBTree: copy-on-write pages,
two header slots, shortened separators, prefix-compressed leaves,
overflow chains, the free list rebuilt at recovery), run in its simulated
event loop over SimFileSystem; the port's are foundationdb_tpu_torch/
server/kvstore.py and kvstore_btree.py over RealFileSystem.  Tolerance 0:

  (a) the memory engine: the same sets, clears and commits give the same
      WAL and snapshot bytes and the same contents; recovery over a torn
      WAL tail, and over a snapshot with its WAL suffix, gives the same
      contents in both;
  (b) the B-tree: the same operations (splits, values over 1,024 bytes in
      overflow chains, clears that free pages for reuse), with
      BTREE_PREFIX_COMPRESSION off and on, give the same page-file bytes,
      root, page count and free list; a torn commit (its pages written,
      its header slot torn or rotted) recovers the previous tree in both;
  (c) random operations against a dict model on the port's B-tree with
      kills between commits (after tests/test_btree_engine.py:25): every
      recovery reads back the last committed state.
"""

import random

import pytest

from foundationdb_tpu.core.knobs import server_knobs as ref_knobs
from foundationdb_tpu.server import kvstore as ref_kv
from foundationdb_tpu.server import kvstore_btree as ref_bt
from foundationdb_tpu.server.sim_fs import SimFileSystem
from foundationdb_tpu_torch.core.error import FdbError
from foundationdb_tpu_torch.core.knobs import server_knobs
from foundationdb_tpu_torch.server.kvstore import (KVStoreMemory,
                                                   open_kv_store)
from foundationdb_tpu_torch.server.kvstore_btree import PAGE_SIZE
from foundationdb_tpu_torch.server.real_fs import RealFileSystem
from test_torch_tlog import loop, run  # noqa: F401


@pytest.fixture()
def compression():
    """Sets BTREE_PREFIX_COMPRESSION in both packages, restored after."""
    regs = [ref_knobs(), server_knobs()]
    saved = [k.BTREE_PREFIX_COMPRESSION for k in regs]

    def set_(on):
        for k in regs:
            k.BTREE_PREFIX_COMPRESSION = on
    yield set_
    for k, v in zip(regs, saved):
        k.BTREE_PREFIX_COMPRESSION = v


def sim_bytes(fs, name):
    return bytes(fs.files[name].durable)


def real_bytes(fs, name):
    f = fs.open(name)
    return f.read(0, f.size())


def same_files(sfs, pfs):
    """Both namespaces hold the same names with the same bytes."""
    names = sorted(sfs.files)
    assert pfs.files == names
    for name in names:
        assert real_bytes(pfs, name) == sim_bytes(sfs, name), name


def copy_into(image: dict, tmp_path, sub: str):
    """Fresh namespaces of both packages holding `image` ({name: bytes})."""
    sfs = SimFileSystem()
    for name, data in image.items():
        sfs.open(name).durable = bytearray(data)
    pfs = RealFileSystem(str(tmp_path / sub))
    for name, data in image.items():
        f = pfs.open(name)
        f.write(0, data)
        f.sync()
    return sfs, pfs


def rand_ops(rng, n_keys: int, big: bool = False):
    """0-30 operations: 70% sets (values 0-40 bytes, or 0-300 with some
    over 1,024 when `big`), 30% clears of a key range."""
    out = []
    for _ in range(rng.randrange(0, 30)):
        k = b"key/%05d" % rng.randrange(n_keys)
        if rng.random() < 0.7:
            n = rng.randrange(0, 300 if big else 40)
            if big and rng.random() < 0.1:
                n = rng.randrange(1025, 9000)
            out.append(("set", k, bytes([rng.randrange(256)]) * n))
        else:
            k2 = b"key/%05d" % rng.randrange(n_keys)
            out.append(("clear", min(k, k2), max(k, k2)))
    return out


def apply_ops(engine, ops, model=None):
    for op, a, b in ops:
        if op == "set":
            engine.set(a, b)
            if model is not None:
                model[a] = b
        else:
            engine.clear(a, b)
            if model is not None:
                for k in [k for k in model if a <= k < b]:
                    del model[k]


# ------------------------------------------------ (a) the memory engine
@pytest.mark.parametrize("seed", range(3))
def test_memory_engine_matches_reference(loop, tmp_path, seed):  # noqa: F811
    rng = random.Random(seed)
    sfs, pfs = SimFileSystem(), RealFileSystem(str(tmp_path / "main"))
    ref, port = ref_kv.KVStoreMemory(sfs, "e"), KVStoreMemory(pfs, "e")
    ref.SNAPSHOT_EVERY_BYTES = port.SNAPSHOT_EVERY_BYTES = 700
    images = []

    async def go():
        await ref.recover()
        port.recover()
        for _ in range(30):
            ops = rand_ops(rng, 80)
            apply_ops(ref, ops)
            apply_ops(port, ops)
            if rng.random() < 0.6:
                await ref.commit()
                port.commit()
                same_files(sfs, pfs)
                assert port.read_range(b"", b"\xff") == \
                    ref.read_range(b"", b"\xff")
                k = b"key/%05d" % rng.randrange(80)
                assert port.read_value(k) == ref.read_value(k)
                assert port.stats() == ref.stats()
                images.append({n: sim_bytes(sfs, n) for n in sfs.files})

    run(loop, go())
    assert any("e.snap" in im for im in images), "no snapshot was written"
    # Recovery: every committed image, its WAL cut at a torn tail or a
    # flipped bit, with its snapshot (and WAL suffix) when it has one.
    for i, image in enumerate(rng.sample(images, 6)):
        wal = image["e.wal"]
        variants = [wal, wal[:rng.randrange(len(wal) + 1)]]
        if wal:
            flipped = bytearray(wal)
            flipped[rng.randrange(len(wal))] ^= 1 << rng.randrange(8)
            variants.append(bytes(flipped))
        for j, w in enumerate(variants):
            sfs2, pfs2 = copy_into(dict(image, **{"e.wal": w}), tmp_path,
                                   f"r{i}.{j}")
            ref2 = ref_kv.KVStoreMemory(sfs2, "e")
            port2 = KVStoreMemory(pfs2, "e")

            async def recover():
                await ref2.recover()

            run(loop, recover())
            port2.recover()
            assert port2.read_range(b"", b"\xff") == \
                ref2.read_range(b"", b"\xff")
            same_files(sfs2, pfs2)


def test_open_kv_store_kinds(tmp_path):
    fs = RealFileSystem(str(tmp_path))
    assert open_kv_store("memory", fs, "a").stats()["engine"] == "memory"
    assert open_kv_store("btree", fs, "b").stats()["engine"] == "btree"
    with pytest.raises(ValueError):
        open_kv_store("ssd", fs, "c")


# ------------------------------------------------------- (b) the B-tree
def tree_state(t):
    return (t.root, t.page_count, t.commit_seq, sorted(t.free))


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("seed", range(2))
def test_btree_matches_reference(loop, tmp_path, compression,  # noqa: F811
                                 compressed, seed):
    compression(compressed)
    rng = random.Random(10 + seed)
    sfs, pfs = SimFileSystem(), RealFileSystem(str(tmp_path / "main"))
    ref, port = ref_bt.KVStoreBTree(sfs, "b"), open_kv_store("btree", pfs,
                                                            "b")
    saw = {"split": False, "overflow": False, "reuse": False}
    commits = []

    async def go():
        await ref.recover()
        port.recover()
        for _ in range(40):
            before = bytes(sfs.files["b.btree"].durable)
            ops = rand_ops(rng, 400, big=True)
            apply_ops(ref, ops)
            apply_ops(port, ops)
            free0 = len(port.free)
            await ref.commit()
            port.commit()
            assert tree_state(port) == tree_state(ref)
            same_files(sfs, pfs)
            rows = ref.read_range(b"", b"\xff")
            assert port.read_range(b"", b"\xff") == rows
            for k, v in rows[:5]:
                assert port.read_value(k) == ref.read_value(k) == v
            saw["split"] |= ref.page_count > 4
            saw["overflow"] |= any(len(v) > 1024 for _k, v in rows)
            saw["reuse"] |= len(port.free) < free0
            commits.append((before, bytes(sfs.files["b.btree"].durable),
                            rows, ref.commit_seq))

    run(loop, go())
    assert all(saw.values()), saw
    # A torn commit: its pages are on disk, its header slot is not whole
    # (cut short, or one bit rotted): both recover the previous tree.
    for i, (before, after, _rows, seq) in enumerate(rng.sample(commits, 4)):
        prev_rows = next((r for _b, _a, r, s in commits if s == seq - 1), [])
        slot = (seq % 2) * PAGE_SIZE
        old_hdr = before[slot:slot + 24].ljust(24, b"\x00")
        new_hdr = bytearray(after[slot:slot + 24])
        if i % 2:
            new_hdr[rng.randrange(24)] ^= 1 << rng.randrange(8)
        else:
            cut = rng.randrange(1, 24)
            new_hdr[cut:] = old_hdr[cut:]
        torn = bytearray(after)
        torn[slot:slot + 24] = new_hdr
        sfs2, pfs2 = copy_into({"b.btree": bytes(torn)}, tmp_path, f"t{i}")
        ref2 = ref_bt.KVStoreBTree(sfs2, "b")
        port2 = open_kv_store("btree", pfs2, "b")

        async def recover():
            await ref2.recover()

        run(loop, recover())
        port2.recover()
        assert tree_state(port2) == tree_state(ref2)
        got = port2.read_range(b"", b"\xff")
        assert got == ref2.read_range(b"", b"\xff")
        assert port2.commit_seq == seq - 1 and got == prev_rows


def test_btree_refuses_a_key_over_a_page(tmp_path):
    fs = RealFileSystem(str(tmp_path))
    t = open_kv_store("btree", fs, "b")
    t.recover()
    t.set(b"a", b"1")
    t.commit()
    t.set(b"k" * 5000, b"v")
    with pytest.raises(FdbError) as e:
        t.commit()
    assert e.value.name == "operation_failed"
    assert t.read_range(b"", b"\xff") == [(b"a", b"1")]


# ------------------------------------------- (c) against a dict model
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_btree_random_ops_against_a_model_with_kills(tmp_path, seed):
    rng = random.Random(seed * 101)
    fs = RealFileSystem(str(tmp_path))
    eng = open_kv_store("btree", fs, "bt")
    eng.recover()
    model, durable = {}, {}
    for round_ in range(30):
        apply_ops(eng, rand_ops(rng, 300, big=seed == 3), model)
        if rng.random() < 0.5:
            eng.commit()
            durable = dict(model)
            assert dict(eng.read_range(b"", b"\xff")) == durable
        if round_ % 7 == 3:
            # A kill: the engine dropped with its uncommitted operations,
            # its file reopened by a fresh engine.
            fs.close()
            fs = RealFileSystem(str(tmp_path))
            eng = open_kv_store("btree", fs, "bt")
            eng.recover()
            model = dict(durable)
            assert dict(eng.read_range(b"", b"\xff")) == durable
            for k, v in list(durable.items())[:20]:
                assert eng.read_value(k) == v
    eng.commit()
    assert dict(eng.read_range(b"", b"\xff")) == model
