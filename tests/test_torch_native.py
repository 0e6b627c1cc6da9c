"""The port's native C++ conflict set (foundationdb_tpu_torch/conflict/
native.py) against the JAX package's NativeConflictSet and the port's
oracle.

The same seeded batches (tests/test_conflict_native.py's cases: ranges
over a small key universe and point transactions over a hot keyspace,
with a floor that moves on every other batch) go through all three; the
verdict codes must be equal, batch by batch, and the two native sets'
segment counts equal after every batch (tolerance 0).  Then empty ranges
(a transaction reading only empty ranges still counts as a reader for the
too-old rule) and reads below the floor; the factory's "native" and
"auto" routes (the native set with no card); and a build that fails
raises with the compiler's stderr.  The library is built with g++ at
first use into build/native/.
"""

import os
import shutil

import pytest
import torch

from foundationdb_tpu.conflict.native import \
    NativeConflictSet as RefNative
from foundationdb_tpu.core import DeterministicRandom
from foundationdb_tpu.txn.types import CommitTransactionRef, KeyRange
from foundationdb_tpu_torch.conflict import native as port_native
from foundationdb_tpu_torch.conflict.api import new_conflict_set
from foundationdb_tpu_torch.conflict.native import NativeConflictSet
from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet
from foundationdb_tpu_torch.txn import types as pt

from test_conflict_oracle import make_domain, random_txn

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ toolchain")


def random_point_txn(rng, nkeys, now, window):
    """tests/test_conflict_tpu.py's point transaction: every range is
    [k, k + \\x00) over `nkeys` hot keys."""
    snap = now - rng.random_int(0, window)
    tr = CommitTransactionRef(read_snapshot=max(snap, 0))
    for _ in range(rng.random_int(0, 4)):
        k = b"k%03d" % rng.random_int(0, nkeys - 1)
        tr.read_conflict_ranges.append(KeyRange(k, k + b"\x00"))
    for _ in range(rng.random_int(0, 3)):
        k = b"k%03d" % rng.random_int(0, nkeys - 1)
        tr.write_conflict_ranges.append(KeyRange(k, k + b"\x00"))
    return tr


def to_port(tr):
    return pt.CommitTransactionRef(
        read_conflict_ranges=[pt.KeyRange(r.begin, r.end)
                              for r in tr.read_conflict_ranges],
        write_conflict_ranges=[pt.KeyRange(w.begin, w.end)
                               for w in tr.write_conflict_ranges],
        read_snapshot=tr.read_snapshot)


def codes(verdicts):
    return [int(v) for v in verdicts]


class Trio:
    """The reference's native set, the port's and the port's oracle, fed
    the same batches."""

    def __init__(self, oldest_version=0):
        self.ref = RefNative(oldest_version)
        self.port = NativeConflictSet(oldest_version)
        self.oracle = OracleConflictSet(oldest_version)

    def resolve(self, batch, now, new_oldest=None):
        want = codes(self.ref.resolve(batch, now, new_oldest))
        ported = [to_port(t) for t in batch]
        got = codes(self.port.resolve(ported, now, new_oldest))
        exact = codes(self.oracle.resolve(ported, now, new_oldest))
        assert got == want == exact, (now, got, want, exact)
        assert self.port.segment_count() == self.ref.segment_count()
        assert self.port.oldest_version == self.ref.oldest_version
        return got


@pytest.mark.parametrize("seed", [41, 42, 43, 44])
def test_native_matches_reference_and_oracle(seed):
    rng = DeterministicRandom(seed)
    domain = make_domain()
    sets = Trio()
    now = 0
    seen = set()
    for i in range(60):
        now += rng.random_int(1, 2_000_000)
        if i % 2:
            batch = [random_point_txn(rng, 12, now, 4_000_000)
                     for _ in range(rng.random_int(1, 24))]
        else:
            batch = [random_txn(rng, domain, now, 4_000_000)
                     for _ in range(rng.random_int(1, 10))]
        new_oldest = now - 5_000_000 if rng.coinflip() else None
        seen.update(sets.resolve(batch, now, new_oldest))
    assert sets.port.segment_count() >= 1
    assert {0, 2} <= seen          # conflicts and commits both seen


def test_empty_ranges_and_too_old_reads():
    """Empty read and write ranges are dropped before encoding; a reader
    of only empty ranges below the floor is still TOO_OLD; a read below
    the floor with a real range is TOO_OLD; an empty write writes
    nothing; the floor a batch moves applies from the next batch on."""
    sets = Trio()
    w = CommitTransactionRef(read_snapshot=0)
    w.write_conflict_ranges += [KeyRange(b"a", b"c"), KeyRange(b"x", b"x")]
    assert sets.resolve([w], 100) == [2]
    empty_reader = CommitTransactionRef(read_snapshot=50)
    empty_reader.read_conflict_ranges.append(KeyRange(b"b", b"b"))
    real_reader = CommitTransactionRef(read_snapshot=50)
    real_reader.read_conflict_ranges.append(KeyRange(b"b", b"bb"))
    x_reader = CommitTransactionRef(read_snapshot=50)
    x_reader.read_conflict_ranges.append(KeyRange(b"x", b"y"))
    assert sets.resolve([empty_reader, real_reader, x_reader], 200) == \
        [2, 0, 2]
    # The floor moves to 150 after this batch, so its readers are judged
    # against the old floor; in the next both are too old.
    assert sets.resolve([empty_reader, real_reader], 300, 150) == [2, 0]
    assert sets.resolve([empty_reader, real_reader, x_reader], 350) == \
        [1, 1, 1]
    # A transaction with no reads is never too old.
    blind = CommitTransactionRef(read_snapshot=0)
    blind.write_conflict_ranges.append(KeyRange(b"q", b"r"))
    assert sets.resolve([blind], 400) == [2]


def test_factory_native_and_auto(monkeypatch):
    """"native" is the C++ set; "auto" with no card is too; "cpu" stays
    the oracle."""
    assert type(new_conflict_set("native", 7)) is NativeConflictSet
    assert new_conflict_set("native", 7).oldest_version == 7
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert type(new_conflict_set("auto")) is NativeConflictSet
    assert type(new_conflict_set("cpu")) is OracleConflictSet


def test_failed_build_raises_with_stderr(monkeypatch, tmp_path):
    """A source that does not compile raises from the factory (no quiet
    fall to the oracle) with g++'s stderr, and nothing is left where the
    library would be."""
    bad = tmp_path / "conflict.cpp"
    bad.write_text("this is not C++\n")
    so = tmp_path / "build" / "libconflict.so"
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "SRC", str(bad))
    monkeypatch.setattr(port_native, "BUILD_DIR", str(so.parent))
    monkeypatch.setattr(port_native, "SO", str(so))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        new_conflict_set("auto")
    assert "conflict.cpp" in str(info.value)
    assert not os.path.exists(so)


def test_library_is_built_under_build():
    """The library lives in build/native/ beside the package, never next
    to the source."""
    NativeConflictSet(0)
    assert os.path.exists(port_native.SO)
    assert os.path.dirname(port_native.SO).endswith(
        os.path.join("build", "native"))
    assert not os.path.exists(os.path.join(
        os.path.dirname(port_native.SRC), "libconflict.so"))
