"""The port's storage path held against the JAX package's: the atomic
operators, the versioned map and the storage server's reads.

The reference's are foundationdb_tpu/txn/atomic.py and
server/storage.py; the port's foundationdb_tpu_torch/txn/atomic.py and
server/storage.py.  Tolerance 0 (bytes and ints):

  (a) every atomic op, op for op, on operands and existing values of
      widths 0-9 (the edges: absent, empty, shorter, longer), and
      AppendIfFits at the value size limit;
  (b) VersionedMap under seeded sets, clears, forget_before and rollback,
      with point reads, latest, range_bytes and scans at random versions,
      limits, byte limits and directions: the port's one scan form
      against each of the reference's two (STORAGE_VECTORIZED_SCAN off
      and on), and load() against the same rows set one by one;
  (c) the storage server over a TLog: pulled sets, clears and atomics
      read back as the model has them at each version, a peek budget
      that returns one version a peek, and the reads it refuses -- above
      every TLog's version (future_version) and below the MVCC window
      (transaction_too_old).
"""

import random

import pytest

from foundationdb_tpu.core.knobs import server_knobs as ref_knobs
from foundationdb_tpu.server.storage import VersionedMap as RefMap
from foundationdb_tpu.txn import atomic as ref_atomic
from foundationdb_tpu.txn import types as rt
from foundationdb_tpu_torch.core.error import FdbError
from foundationdb_tpu_torch.core.knobs import server_knobs
from foundationdb_tpu_torch.server.commit_proxy import LogSystemClient
from foundationdb_tpu_torch.server.interfaces import (GetKeyValuesRequest,
                                                      GetValueRequest, ask)
from foundationdb_tpu_torch.server.storage import StorageServer, VersionedMap
from foundationdb_tpu_torch.server.tlog import TLog
from foundationdb_tpu_torch.txn import atomic as port_atomic
from foundationdb_tpu_torch.txn import types as pt

ATOMIC = sorted(int(op) for op in pt.ATOMIC_OPS
                if op not in (pt.MutationType.SetVersionstampedKey,
                              pt.MutationType.SetVersionstampedValue))


# ------------------------------------------------------------ (a) atomics
def widths(rng):
    out = [None, b""]
    for n in range(1, 10):
        out.append(bytes(rng.randrange(256) for _ in range(n)))
        out.append(b"\xff" * n)
        out.append(b"\x00" * n)
    return out


@pytest.mark.parametrize("op", ATOMIC)
def test_atomic_ops_match_reference(op):
    rng = random.Random(op)
    vals = widths(rng)
    for existing in vals:
        for operand in vals[1:]:
            got = port_atomic.apply_atomic(pt.MutationType(op), existing,
                                           operand)
            want = ref_atomic.apply_atomic(rt.MutationType(op), existing,
                                           operand)
            assert got == want, (op, existing, operand)
    if op == int(pt.MutationType.AppendIfFits):
        big = b"x" * (port_atomic.VALUE_SIZE_LIMIT - 1)
        for tail in (b"y", b"yz"):
            assert port_atomic.apply_atomic(pt.MutationType(op), big, tail) \
                == ref_atomic.apply_atomic(rt.MutationType(op), big, tail)
    with pytest.raises(ValueError):
        port_atomic.apply_atomic(pt.MutationType.SetValue, b"a", b"b")


def test_types_match_reference():
    rng = random.Random(5)
    assert {int(o) for o in pt.ATOMIC_OPS} == {int(o) for o in rt.ATOMIC_OPS}
    for _ in range(50):
        v, i = rng.randrange(1 << 63), rng.randrange(1 << 16)
        assert pt.make_versionstamp(v, i) == rt.make_versionstamp(v, i)
        k = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 6)))
        if k.rstrip(b"\xff"):
            assert pt.strinc(k) == rt.strinc(k)
    with pytest.raises(OverflowError):
        pt.make_versionstamp(1, 1 << 16)
    with pytest.raises(ValueError):
        pt.strinc(b"\xff\xff")
    m = pt.Mutation.clear_range(b"a", b"b")
    assert (m.type, m.param1, m.param2) == (pt.MutationType.ClearRange,
                                             b"a", b"b")


# ---------------------------------------------------------- (b) the map
def rand_key(rng):
    return b"k%02d" % rng.randrange(40)


def map_ops(seed: int, n: int = 300):
    """Seeded (op, args) over 40 keys: sets, tombstone sets, clears,
    forget_before and a rollback, versions ascending."""
    rng = random.Random(seed)
    ops, v = [], 0
    for _ in range(n):
        r = rng.random()
        if r < 0.05 and v:
            ops.append(("forget_before", (rng.randrange(0, v + 1),)))
            continue
        if r < 0.07 and v > 10:
            ops.append(("rollback", (v - rng.randrange(0, 10),)))
            continue
        v += rng.choice([0, 1, 1, 3])
        if r < 0.55:
            ops.append(("set", (rand_key(rng), b"v%d" % rng.randrange(99),
                                v)))
        elif r < 0.65:
            ops.append(("set", (rand_key(rng), None, v)))
        else:
            a, b = sorted((rand_key(rng), rand_key(rng)))
            ops.append(("clear_range", (a, b + b"\x00", v)))
    return ops


def map_state(m):
    return list(m._keys), {k: list(c) for k, c in m._chains.items()}


@pytest.mark.parametrize("vectorized", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_versioned_map_matches_reference(monkeypatch, seed, vectorized):
    monkeypatch.setattr(ref_knobs(), "STORAGE_VECTORIZED_SCAN", vectorized)
    rng = random.Random(100 + seed)
    port, ref = VersionedMap(), RefMap()
    top = 0
    for name, args in map_ops(seed):
        if name == "rollback":
            top = args[0]
        elif name != "forget_before":
            top = args[-1]
        getattr(port, name)(*args)
        getattr(ref, name)(*args)
        assert map_state(port) == map_state(ref)
        assert len(port) == len(ref)
        for _ in range(3):
            v = rng.randrange(0, top + 2)
            k = rand_key(rng)
            assert port.get(k, v) == ref.get(k, v)
            assert port.latest(k) == ref.latest(k)
            a, b = sorted((rand_key(rng), rand_key(rng)))
            limit = rng.choice([1, 2, 5, 1000])
            limit_bytes = rng.choice([4, 20, 1 << 20])
            rev = rng.random() < 0.5
            assert port.range_read(a, b, v, limit, limit_bytes, rev) == \
                ref.range_read(a, b, v, limit, limit_bytes, rev)
            assert port.range_bytes(a, b, v) == ref.range_bytes(a, b, v)


def test_versioned_map_load_equals_sets():
    keys = [b"k%03d" % i for i in range(0, 300, 3)]
    vals = [b"v%d" % i for i in range(len(keys))]
    loaded, set_ = VersionedMap(), VersionedMap()
    loaded.load(keys, vals, 7)
    for k, v in zip(keys, vals):
        set_.set(k, v, 7)
    assert map_state(loaded) == map_state(set_)
    for m in (loaded, set_):
        m.set(b"k003", b"new", 9)
        m.clear_range(b"k010", b"k020", 10)
        m.forget_before(10)
    assert map_state(loaded) == map_state(set_)
    with pytest.raises(ValueError, match="empty"):
        loaded.load(keys, vals, 7)
    with pytest.raises(ValueError, match="ascending"):
        VersionedMap().load([b"b", b"a"], [b"1", b"2"], 0)


# ----------------------------------------------------- (c) the server
def push(log_system, prev, version, messages):
    log_system.push(prev, version, prev, messages)


def test_storage_server_reads_what_was_pulled(monkeypatch):
    """Sets, clears and atomics pulled from two TLogs (one version a peek
    under a tiny budget) read back, point and range, at every version of
    the window as a dict model has them; history below the window is
    forgotten."""
    knobs = server_knobs()
    monkeypatch.setattr(knobs, "TLOG_PEEK_DESIRED_BYTES", 1)
    monkeypatch.setattr(knobs, "MAX_READ_TRANSACTION_LIFE_VERSIONS", 50)
    rng = random.Random(3)
    tlogs = [TLog("log0"), TLog("log1")]
    ls = LogSystemClient(tlogs, replication=2)
    ss = StorageServer("ss0", 0, ls)
    ss.load([b"k%02d" % i for i in range(0, 40, 2)],
            [b"base"] * 20)
    model = {b"k%02d" % i: b"base" for i in range(0, 40, 2)}
    history = {0: dict(model)}
    version = 0
    for step in range(40):
        prev, version = version, version + rng.randrange(1, 8)
        msgs = []
        for _ in range(rng.randrange(0, 4)):
            r = rng.random()
            k = rand_key(rng)
            if r < 0.5:
                msgs.append(pt.Mutation.set_value(k, b"s%d" % step))
                model[k] = b"s%d" % step
            elif r < 0.75:
                op = pt.Mutation(pt.MutationType.AddValue, k, b"\x01")
                msgs.append(op)
                model[k] = port_atomic.apply_atomic(op.type, model.get(k),
                                                    b"\x01")
            else:
                a, b = sorted((rand_key(rng), rand_key(rng)))
                msgs.append(pt.Mutation.clear_range(a, b))
                for key in [x for x in model if a <= x < b]:
                    del model[key]
        push(ls, prev, version, {0: msgs} if msgs else {})
        history[version] = dict(model)
        if step % 5 == 4:
            moved = ss.pull()
            assert ss.version == version and moved >= 1
            for v, want in history.items():
                if v < ss.oldest_version:
                    continue
                for k in sorted(set(want) | {rand_key(rng)}):
                    assert ask(ss.get_value,
                               GetValueRequest(k, v)).value == want.get(k)
                rows = ask(ss.get_key_values,
                           GetKeyValuesRequest(b"", b"\xff", v)).data
                assert rows == sorted(want.items())
    assert ss.oldest_version == version - 50
    assert all(len(c) == 1 or c[1][0] > ss.oldest_version
               for c in ss.data._chains.values())
    # The TLogs were popped to the server's version.
    assert all(t.poppedtags[0] == version for t in tlogs)
    assert not any(t.tag_data.get(0) for t in tlogs)


def test_storage_server_refuses_reads_outside_the_window(monkeypatch):
    """Above every TLog's version: future_version (after pulling all
    there is); below the window: transaction_too_old.  Both ride the
    reply and ask() raises them."""
    monkeypatch.setattr(server_knobs(), "MAX_READ_TRANSACTION_LIFE_VERSIONS",
                        100)
    tlogs = [TLog("log0")]
    ls = LogSystemClient(tlogs)
    ss = StorageServer("ss0", 0, ls)
    push(ls, 0, 50, {0: [pt.Mutation.set_value(b"a", b"1")]})
    push(ls, 50, 500, {0: [pt.Mutation.set_value(b"a", b"2")]})
    # Reading at 500 pulls up to it first.
    assert ask(ss.get_value, GetValueRequest(b"a", 500)).value == b"2"
    for v, name in ((501, "future_version"), (10_000, "future_version"),
                    (399, "transaction_too_old"),
                    (50, "transaction_too_old")):
        for req in (GetValueRequest(b"a", v),
                    GetKeyValuesRequest(b"", b"b", v)):
            serve = ss.get_value if isinstance(req, GetValueRequest) \
                else ss.get_key_values
            with pytest.raises(FdbError) as e:
                ask(serve, req)
            assert e.value.name == name
    assert ask(ss.get_value, GetValueRequest(b"a", 400)).value == b"1"
