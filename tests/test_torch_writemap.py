"""The port's WriteMap (foundationdb_tpu_torch/client/writemap.py)
against the JAX package's (foundationdb_tpu/client/writemap.py): seeded
op sequences of sets, clears, clear ranges, every atomic type and
versionstamped keys and values; after each op every query of the map
answers the same, exceptions included."""

import random

import pytest

from foundationdb_tpu.client.writemap import WriteMap as RefWriteMap
from foundationdb_tpu.txn import types as rt
from foundationdb_tpu_torch.client.writemap import WriteMap as PortWriteMap
from foundationdb_tpu_torch.txn import types as pt

KEYS = [b"k%02d" % i for i in range(12)]
BOUNDS = [b""] + KEYS + [b"k05\x00", b"k99", b"\xff"]
ATOMICS = sorted(int(t) for t in pt.ATOMIC_OPS
                 if t not in (pt.MutationType.SetVersionstampedKey,
                              pt.MutationType.SetVersionstampedValue))
SEQUENCES = 200
OPS = 40


def operand(r) -> bytes:
    return bytes(r.randrange(256) for _ in range(r.choice([0, 1, 4, 8])))


def ops_of(seed: int) -> list:
    """OPS ops: (kind, args) with kind in set, clear, clear_range,
    atomic, vs_key, vs_value."""
    r = random.Random(seed)
    out = []
    for _ in range(OPS):
        kind = r.choice(["set", "set", "clear", "clear_range", "atomic",
                         "atomic", "atomic", "vs_key", "vs_value"])
        k = r.choice(KEYS)
        if kind == "set":
            out.append((kind, (k, operand(r))))
        elif kind == "clear":
            out.append((kind, (k, k + b"\x00")))
        elif kind == "clear_range":
            a, b = sorted(r.sample(BOUNDS, 2))
            out.append((kind, (a, b)))
        elif kind == "atomic":
            out.append((kind, (r.choice(ATOMICS), k, operand(r))))
        elif kind == "vs_key":
            off = r.randrange(0, 4)
            tmpl = k[:off] + bytes(10) + k[off:]
            out.append((kind, (tmpl + off.to_bytes(4, "little"),
                               operand(r))))
        else:
            off = r.randrange(0, 3)
            out.append((kind, (k, b"v" * off + bytes(10) + b"t" +
                               off.to_bytes(4, "little"))))
    return out


def apply(wm, types, op) -> None:
    kind, args = op
    if kind == "set":
        wm.set(*args)
    elif kind in ("clear", "clear_range"):
        wm.clear(*args)
    elif kind == "atomic":
        wm.atomic_op(types.MutationType(args[0]), args[1], args[2])
    elif kind == "vs_key":
        wm.atomic_op(types.MutationType.SetVersionstampedKey, *args)
    else:
        wm.atomic_op(types.MutationType.SetVersionstampedValue, *args)


def outcome(fn):
    """A call's value, or its exception by class name and error name."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - compared by name
        return ("raise", type(e).__name__, getattr(e, "name", str(e)))


def muts(wm) -> list:
    return [(int(m.type), m.param1, m.param2) for m in wm.mutations]


def state(wm, r) -> list:
    got = []
    for k in KEYS + [b"k05\x00", b"zz"]:
        got.append((k, wm.has_writes(k), wm.needs_base(k),
                    wm.is_unreadable(k)))
        for base in (None, b"", b"\x07", operand(r)):
            got.append(outcome(lambda: wm.merge(k, base)))
    for _ in range(3):
        a, b = sorted(r.sample(BOUNDS, 2))
        got.append((a, b, wm.touched_keys_in(a, b), wm.clears_in(a, b)))
    got.append(wm.write_conflict_ranges())
    got.append(muts(wm))
    got.append(len(wm))
    return got


@pytest.mark.parametrize("block", range(4))
def test_writemap_matches_reference(block):
    per = SEQUENCES // 4
    for seed in range(block * per, (block + 1) * per):
        ref, port = RefWriteMap(), PortWriteMap()
        for i, op in enumerate(ops_of(seed)):
            apply(ref, rt, op)
            apply(port, pt, op)
            want = state(ref, random.Random(seed * 1000 + i))
            got = state(port, random.Random(seed * 1000 + i))
            assert got == want, (seed, i, op)


def test_versionstamped_key_covers_every_stamp():
    """A versionstamped key's write conflict range spans every stamp its
    slot can take, in both packages."""
    for wm, types in ((RefWriteMap(), rt), (PortWriteMap(), pt)):
        wm.atomic_op(types.MutationType.SetVersionstampedKey,
                     b"p" + bytes(10) + b"s" + (1).to_bytes(4, "little"),
                     b"v")
        [(lo, hi)] = wm.write_conflict_ranges()
        assert lo == b"p" + bytes(10) + b"s"
        assert hi == b"p" + b"\xff" * 10 + b"s\x00"
