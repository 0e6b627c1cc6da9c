"""The port's wire format (foundationdb_tpu_torch/rpc/serde.py) against
the JAX package's (foundationdb_tpu/rpc/serde.py): the same seeded
messages, built in each package's own types, encode to the same bytes in
the tagged form and in the columnar form (RPC_COLUMNAR_ENABLED set in
both packages' knobs), and each package decodes the other's frames to
the values it would have built itself (tolerance 0 throughout).

The messages are every type that crosses the port's network on the
cluster's and the TCP resolver's paths: the client's commit, read
version, key locations and storage reads with their replies, the
master's version messages, the resolve request and reply, the TLog
commit, confirm and peek reply, CommitID, an FdbError reply with its
details, the waitFailure request and the interfaces.  The resolver's,
a commit proxy's and a GRV proxy's interfaces are the reference's field
for field, so their frames are equal; the master's, a TLog's and a
storage server's lack streams the port does not serve (the reference's
configuration and backup nudges, queuing metrics, data distribution),
so those are held to cross-package decoding only.  A malformed frame and
an unregistered class name fail as the reference's do."""

import struct

import numpy as np
import pytest

from foundationdb_tpu.core import error as ref_error
from foundationdb_tpu.core.knobs import server_knobs as ref_knobs
from foundationdb_tpu.rpc import endpoint as ref_endpoint
from foundationdb_tpu.rpc import serde as ref_serde
from foundationdb_tpu.server import failure as ref_failure
from foundationdb_tpu.server import interfaces as ref_if
from foundationdb_tpu.txn import types as ref_types
from foundationdb_tpu_torch.core import error as port_error
from foundationdb_tpu_torch.core.knobs import server_knobs as port_knobs
from foundationdb_tpu_torch.rpc import endpoint as port_endpoint
from foundationdb_tpu_torch.rpc import serde as port_serde
from foundationdb_tpu_torch.server import failure as port_failure
from foundationdb_tpu_torch.server import interfaces as port_if
from foundationdb_tpu_torch.txn import types as port_types

REF = dict(types=ref_types, ifs=ref_if, error=ref_error, ep=ref_endpoint,
           failure=ref_failure, serde=ref_serde)
PORT = dict(types=port_types, ifs=port_if, error=port_error,
            ep=port_endpoint, failure=port_failure, serde=port_serde)
BIG = (1 << 64) + 12345            # past i64: the tagged form's big int


@pytest.fixture(autouse=True)
def registries():
    ref_serde.bootstrap_registry()
    port_serde.bootstrap_registry()
    saved = (ref_knobs().RPC_COLUMNAR_ENABLED,
             port_knobs().RPC_COLUMNAR_ENABLED)
    yield
    ref_knobs().RPC_COLUMNAR_ENABLED, port_knobs().RPC_COLUMNAR_ENABLED = \
        saved


def key(rng, n=None):
    n = int(rng.integers(1, 24)) if n is None else n
    return b"k" + rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


def txn(m, rng, ranges: bool, mutations: bool, base: int):
    t = m["types"]
    reads, writes = [], []
    for _ in range(int(rng.integers(0, 4))):
        b = key(rng)
        e = b + (b"\xff" * int(rng.integers(1, 3)) if ranges else b"\x00")
        reads.append(t.KeyRange(b, e))
    for _ in range(int(rng.integers(0, 3))):
        b = key(rng)
        writes.append(t.KeyRange(b, b + b"\x00"))
    muts = []
    if mutations:
        for j in range(int(rng.integers(0, 4))):
            op = [t.MutationType.SetValue, t.MutationType.ClearRange,
                  t.MutationType.AddValue][j % 3]
            muts.append(t.Mutation(op, key(rng), key(rng, 8)))
    kw = dict(read_conflict_ranges=reads, write_conflict_ranges=writes,
              mutations=muts, read_snapshot=base - int(rng.integers(0, 5000)),
              report_conflicting_keys=bool(rng.integers(0, 2)))
    if rng.integers(0, 3) == 0:
        kw["tenant_id"] = int(rng.integers(0, 1 << 40))
    if rng.integers(0, 3) == 0:
        kw["tag"] = "tag%d" % int(rng.integers(0, 9))
    return t.CommitTransactionRef(**kw)


def messages(m, seed: int) -> dict:
    """Every message of the paths, built in package `m`'s types from one
    seeded draw (so both packages build the same values)."""
    rng = np.random.default_rng(seed)
    t, i = m["types"], m["ifs"]
    v = (1 << 62) + int(rng.integers(0, 1 << 30))

    def txns(n, ranges, mutations):
        return [txn(m, rng, ranges, mutations, v) for _ in range(n)]

    out = {}
    out["resolve_points"] = i.ResolveTransactionBatchRequest(
        v - 1000, v, v - 2000, txns(12, False, False), proxy_id="p0")
    out["resolve_ranges"] = i.ResolveTransactionBatchRequest(
        v - 1000, v, v - 2000, txns(12, True, True),
        txn_state_transactions=[0, 5, 11], proxy_id="proxy1",
        span="p1.e1.b7")
    out["resolve_empty"] = i.ResolveTransactionBatchRequest(0, 1, 0, [])
    out["resolve_bigint"] = i.ResolveTransactionBatchRequest(
        BIG, BIG + 1, -BIG, txns(2, False, False), proxy_id="p0")
    codes = [t.CommitResult(int(c)) for c in rng.integers(0, 3, size=40)]
    out["resolve_reply"] = i.ResolveTransactionBatchReply(
        committed=codes,
        state_transactions=[
            (v - 10, "p1", 0, [t.Mutation(t.MutationType.SetValue,
                                          b"\xff/conf/a", b"1")],
             t.CommitResult.COMMITTED),
            (v - 5, "p1", 1, [], t.CommitResult.CONFLICT)],
        conflicting_ranges={3: [(b"a", b"b"), (key(rng), b"z")], 17: []},
        attribution_exact={3: True, 17: False, 30: True})
    out["resolve_reply_empty"] = i.ResolveTransactionBatchReply(committed=[])
    out["commit_request"] = i.CommitTransactionRequest(
        transaction=txn(m, rng, True, True, v), debug_id="dbg",
        repair_eligible=True, repair_attempt=2)
    out["commit_request_plain"] = i.CommitTransactionRequest(
        transaction=txn(m, rng, False, True, 0))
    out["commit_id"] = i.CommitID(version=v, txn_batch_id=7,
                                  txn_batch_index=65535)
    out["grv_request"] = i.GetReadVersionRequest(
        priority=i.TransactionPriority.IMMEDIATE, transaction_count=5,
        tags=("a", "b"), tenant_id=9)
    out["grv_reply"] = i.GetReadVersionReply(version=v, locked=True)
    out["locations_request"] = i.GetKeyServerLocationsRequest(
        b"a", b"q", limit=3, reverse=True)
    out["locations_reply"] = i.GetKeyServerLocationsReply(
        results=[(t.KeyRange(b"a", b"m"), []), (t.KeyRange(b"m", b"q"), [])])
    out["get_value"] = i.GetValueRequest(key(rng), v)
    out["get_value_reply"] = i.GetValueReply(value=key(rng, 100), version=v)
    out["get_value_reply_none"] = i.GetValueReply(value=None, version=v)
    out["get_key_values"] = i.GetKeyValuesRequest(
        b"prefix/aa", b"prefix/az", v, limit=17, limit_bytes=1 << 16,
        reverse=True)
    out["get_key_values_reply"] = i.GetKeyValuesReply(
        data=[(b"prefix/a%03d" % j, key(rng, 30)) for j in range(9)],
        more=True, version=v)
    out["commit_version_request"] = i.GetCommitVersionRequest(
        request_num=41, proxy_id="p1")
    out["commit_version_reply"] = i.GetCommitVersionReply(
        version=v, prev_version=v - 1000,
        resolver_changes=[(t.KeyRange(b"\x40", b"\x80"), 1, v - 3000)],
        resolver_changes_version=v - 3000)
    out["report_committed"] = i.ReportRawCommittedVersionRequest(version=v)
    out["live_committed"] = i.GetRawCommittedVersionRequest()
    out["live_committed_reply"] = i.GetRawCommittedVersionReply(version=v)
    out["tlog_commit"] = i.TLogCommitRequest(
        v - 1000, v, v - 2000,
        {0: [t.Mutation(t.MutationType.SetValue, key(rng), key(rng))],
         3: [], i.TXS_TAG: [t.Mutation(t.MutationType.ClearRange,
                                       b"\xff/a", b"\xff/b")]})
    out["tlog_confirm"] = i.TLogConfirmRunningRequest()
    out["tlog_peek_reply"] = i.TLogPeekReply(
        messages=[(v - 20, [t.Mutation(t.MutationType.SetValue, b"a",
                                       b"1")]), (v - 10, [])],
        end=v, max_known_version=v - 5)
    e = m["error"].err("not_committed", "conflict")
    e.details = [(b"a", b"b"), (b"c", b"d")]
    out["error_reply"] = e
    out["error_plain"] = m["error"].err("transaction_too_old")
    out["wait_failure"] = m["failure"].WaitFailureRequest()
    return out


def interfaces(m) -> dict:
    """Each role's interface with its streams registered under the same
    addresses and tokens in both packages."""
    i, ep = m["ifs"], m["ep"]
    addr = ep.NetworkAddress("10.0.0.7", 4500)
    made = {"resolver": i.ResolverInterface("resolver1"),
            "commit_proxy": i.CommitProxyInterface("proxy0"),
            "grv_proxy": i.GrvProxyInterface("grv"),
            "master": i.MasterInterface(),
            "tlog": i.TLogInterface("log0"),
            "storage": i.StorageServerInterface("ss2", 2)}
    for name, iface in made.items():
        for n, stream in enumerate(iface.streams()):
            stream.set_endpoint(ep.Endpoint(
                addr, f"{stream.name}:{name}{n:02d}"))
    return made


SAME_FRAME = ("resolver", "commit_proxy", "grv_proxy")


def plain(v):
    """A value as nested tuples of builtins, for comparison within one
    package (interfaces have no __eq__)."""
    import dataclasses
    from enum import Enum
    if isinstance(v, Enum):
        return (type(v).__name__, v.value)
    if isinstance(v, BaseException):
        return ("error", v.code, v.name, str(v),
                plain(getattr(v, "details", None)))
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,) + tuple(
            (f.name, plain(getattr(v, f.name)))
            for f in dataclasses.fields(v) if f.name != "reply")
    if hasattr(v, "set_endpoint"):
        return ("stream", tuple(v.endpoint))
    if isinstance(v, (list, tuple)):
        return (type(v).__name__,) + tuple(plain(x) for x in v)
    if isinstance(v, dict):
        return ("dict",) + tuple((plain(k), plain(x)) for k, x in v.items())
    if hasattr(v, "__dict__") and type(v).__name__.endswith("Interface"):
        return (type(v).__name__,) + tuple(
            (k, plain(x)) for k, x in vars(v).items()
            if not k.startswith("_"))
    return v


def set_columnar(on: bool) -> None:
    ref_knobs().RPC_COLUMNAR_ENABLED = on
    port_knobs().RPC_COLUMNAR_ENABLED = on


@pytest.mark.parametrize("columnar", [False, True],
                         ids=["tagged", "columnar"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_frames_equal_the_reference(columnar, seed):
    set_columnar(columnar)
    ref, port = messages(REF, seed), messages(PORT, seed)
    assert list(ref) == list(port)
    for name in ref:
        want = ref_serde.encode_message(ref[name])
        got = port_serde.encode_message(port[name])
        assert got == want, name
        # The envelope (the RealNetwork's request body) with a span.
        assert port_serde.encode_envelope(port[name], "span-7") == \
            ref_serde.encode_envelope(ref[name], "span-7"), name


@pytest.mark.parametrize("columnar", [False, True],
                         ids=["tagged", "columnar"])
def test_columnar_frames_are_columnar(columnar):
    """The knob picks the form: a hot message's frame starts with the
    columnar tag exactly when it is on (in both packages)."""
    set_columnar(columnar)
    port = messages(PORT, 4)
    tag = port_serde.encode_message(port["resolve_ranges"])[0]
    assert tag == (port_serde.T_COLUMNAR if columnar
                   else port_serde.T_DATACLASS)


@pytest.mark.parametrize("columnar", [False, True],
                         ids=["tagged", "columnar"])
@pytest.mark.parametrize("seed", [5, 6])
def test_each_decodes_the_other(columnar, seed):
    set_columnar(columnar)
    ref, port = messages(REF, seed), messages(PORT, seed)
    for name in ref:
        from_port = ref_serde.decode_message(
            port_serde.encode_message(port[name]))
        assert plain(from_port) == plain(ref[name]), name
        from_ref = port_serde.decode_message(
            ref_serde.encode_message(ref[name]))
        assert plain(from_ref) == plain(port[name]), name
        value, span = port_serde.decode_envelope(
            ref_serde.encode_envelope(ref[name], "s1"))
        assert span == "s1" and plain(value) == plain(port[name]), name


def test_reference_only_fields_are_dropped_and_defaulted():
    """A reference frame carrying fields the port's classes lack (a
    lock_aware transaction, a TLog commit's span, a read's debug id and
    tag) decodes in the port without them; the port's frame of the same
    message writes the reference's defaults there."""
    for columnar in (False, True):
        set_columnar(columnar)
        t = ref_types
        rt = t.CommitTransactionRef(
            write_conflict_ranges=[t.KeyRange(b"a", b"b")], lock_aware=True)
        got = port_serde.decode_message(ref_serde.encode_message(
            ref_if.CommitTransactionRequest(transaction=rt)))
        assert plain(got.transaction) == plain(port_types.CommitTransactionRef(
            write_conflict_ranges=[port_types.KeyRange(b"a", b"b")]))
        for msg in (ref_if.TLogCommitRequest(1, 2, 0, {}, span="s"),
                    ref_if.GetValueRequest(b"k", 5, debug_id="d", tag="x"),
                    ref_if.GetKeyValuesRequest(b"a", b"b", 5, debug_id="d",
                                               tag="x")):
            back = port_serde.decode_message(ref_serde.encode_message(msg))
            again = ref_serde.decode_message(port_serde.encode_message(back))
            stripped = type(msg)(**{
                f: getattr(msg, f) for f in ("prev_version", "version",
                                             "known_committed_version",
                                             "messages", "key", "begin",
                                             "end", "limit", "limit_bytes",
                                             "reverse")
                if hasattr(msg, f)})
            assert plain(again) == plain(stripped)


def test_interfaces():
    ref, port = interfaces(REF), interfaces(PORT)
    for name in ref:
        r_bytes = ref_serde.encode_message(ref[name])
        p_bytes = port_serde.encode_message(port[name])
        if name in SAME_FRAME:
            assert p_bytes == r_bytes, name
        # Each package decodes the other's frame to an interface whose
        # every stream is a client stub at the same endpoint.
        from_ref = port_serde.decode_message(r_bytes)
        from_port = ref_serde.decode_message(p_bytes)
        for mine, theirs in ((port[name], from_port), (ref[name], from_ref)):
            for k, x in vars(mine).items():
                if k.startswith("_"):
                    continue
                y = getattr(theirs, k)
                if hasattr(x, "set_endpoint"):
                    assert tuple(y.endpoint) == tuple(x.endpoint), (name, k)
                else:
                    assert y == x, (name, k)
    # A reply carrying storage interfaces (the location service's).
    loc = port_if.GetKeyServerLocationsReply(
        results=[(port_types.KeyRange(b"a", b"b"), [port["storage"]])])
    back = ref_serde.decode_message(port_serde.encode_message(loc))
    ssi = back.results[0][1][0]
    assert type(ssi).__name__ == "StorageServerInterface"
    assert tuple(ssi.get_value.endpoint) == \
        tuple(port["storage"].get_value.endpoint)
    # An unregistered stream cannot be shipped, in either package.
    for serde, ifs in ((ref_serde, ref_if), (port_serde, port_if)):
        with pytest.raises(Exception) as e:
            serde.encode_message(ifs.ResolverInterface("r"))
        assert "not registered" in str(e.value)


def outcome(fn):
    try:
        return ("ok", plain(fn()))
    except Exception as e:  # noqa: BLE001 - the failure is the outcome
        return (type(e).__name__, getattr(e, "code", None), str(e))


@pytest.mark.parametrize("frame", [
    b"",                                     # nothing
    b"\x63",                                 # an unknown tag
    bytes([11]) + struct.pack("<I", 10) + b"NoSuchType" + b"\0" * 4,
    bytes([16]) + struct.pack("<I", 4) + b"Nope" + bytes([3]) + b"\0" * 8,
    bytes([12]) + struct.pack("<I", 6) + b"Absent" + b"\0" * 4,
    bytes([18]) + struct.pack("<I", 8) + b"NotAType" + b"\x01",
    bytes([18]) + struct.pack("<I", 28) + b"ResolveTransactionBatchReply"
    + b"\x09",                               # a wrong codec version
    bytes([6]) + struct.pack("<I", 100) + b"short",
    bytes([3]) + b"\x01\x02",                # a cut i64
], ids=["empty", "bad-tag", "unregistered-dataclass", "unregistered-enum",
        "unregistered-object", "unknown-columnar", "codec-version",
        "cut-bytes", "cut-int"])
def test_malformed_frames_fail_as_the_reference(frame):
    """Each fails with the reference's error and message, but a byte
    string cut short, which the reference decodes to what is there (it
    does not check the length), and so does the port."""
    want = outcome(lambda: ref_serde.decode_message(frame))
    got = outcome(lambda: port_serde.decode_message(frame))
    assert (want[0] == "ok") == (frame[:1] == bytes([6]))
    assert got == want


def test_truncated_frames_fail_as_the_reference():
    """Every prefix of a real frame, in both forms: decoded or failed the
    same way in both packages."""
    for columnar in (False, True):
        set_columnar(columnar)
        ref, port = messages(REF, 7), messages(PORT, 7)
        for name in ("resolve_ranges", "resolve_reply", "get_key_values"):
            frame = port_serde.encode_message(port[name])
            for cut in range(0, len(frame), max(1, len(frame) // 40)):
                want = outcome(lambda: ref_serde.decode_message(frame[:cut]))
                got = outcome(lambda: port_serde.decode_message(frame[:cut]))
                assert got[0] == want[0], (name, cut)
