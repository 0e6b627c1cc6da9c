"""Tagged wire serialization for the role interfaces and their messages
(a copy of foundationdb_tpu/rpc/serde.py that writes the reference's
frames byte for byte).

Reference: the reference ships every request/reply/interface struct through
FlowTransport using the classic field-order serializer plus the tagged
(schema-evolving) ObjectSerializer (flow/serialize.h, flow/flat_buffers.h,
fdbrpc/fdbrpc.h:595 — RequestStreams serialize as their Endpoint tokens).

This module is the Python analog for the real TCP transport: a TYPE-TAGGED
recursive encoder over the framework's value vocabulary, with a registry of
message/interface classes keyed by stable class name.  No pickle: the format
is explicit, versioned by the transport handshake, and only constructs
registered types — a malformed peer frame cannot execute arbitrary code.

Encoding rules:
  * scalars: None, bool, int (i64 or big-int bytes), float, bytes, str
  * containers: list, tuple, dict (encoded recursively)
  * Enum / IntEnum: class name + value
  * dataclasses (requests/replies, KeyRange, Mutation, ...): class name +
    declared fields, SKIPPING the `reply` field — the transport carries the
    reply token out-of-band, exactly like the reference's ReplyPromise
    embedded token (fdbrpc.h: ReplyPromise serializes as an endpoint)
  * interface classes (bundles of RequestStreams; registered explicitly):
    instance __dict__, skipping private attrs and the sim-only `role`
    backref; RequestStream values encode as their Endpoint
  * RequestStream / RequestStreamStub: the Endpoint (address + token);
    decoded as a client-half RequestStream whose endpoint is set — callers
    use `.endpoint`, `.get_reply`, `.send` exactly as with a local stream
  * FdbError: code + name + message (error replies)
  * the hot messages (the resolve request and reply, the commit request,
    the TLog commit and peek reply, the storage reads and their replies):
    columnar frames when RPC_COLUMNAR_ENABLED is on (see below).

The port's dataclasses are trimmed: where the reference's frame carries a
field the port's class lacks (CommitTransactionRef.lock_aware,
TLogCommitRequest.span, GetValueRequest.debug_id and tag, ...), the
encoder writes the reference's default in the reference's place
(_REFERENCE_FIELDS), and the decoder skips it, as the reference's decoder
skips a field it does not know.  So a frame of the port's is the
reference's frame of the same message, and each package decodes the
other's.  The envelope carries the span the caller names (the port keeps
no ambient span).
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Any, Callable, Dict, Optional

from ..core.error import ERROR_CODES, FdbError
from ..core.wire import Reader, Writer
from .endpoint import Endpoint, NetworkAddress, RequestStream, RequestStreamStub

# -- type tags ---------------------------------------------------------------
T_NONE = 0
T_TRUE = 1
T_FALSE = 2
T_INT = 3          # i64
T_BIGINT = 4       # arbitrary precision (sign byte + magnitude bytes)
T_FLOAT = 5
T_BYTES = 6
T_STR = 7
T_LIST = 8
T_TUPLE = 9
T_DICT = 10
T_DATACLASS = 11
T_OBJECT = 12      # registered plain class (interfaces): __dict__ encoding
T_STREAM = 13      # RequestStream/Stub -> Endpoint
T_ENDPOINT = 14
T_ADDRESS = 15
T_ENUM = 16
T_ERROR = 17
T_COLUMNAR = 18    # batch-level columnar frame for the hot commit RPCs

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1

# class name -> class, for dataclasses, interfaces, enums
_REGISTRY: Dict[str, type] = {}
_IS_INTERFACE: Dict[str, bool] = {}
# cache: class -> list of field names to ship (dataclasses, minus `reply`)
_FIELDS: Dict[type, list] = {}


def register(cls: type, interface: bool = False) -> type:
    """Register a class for wire transport.  `interface=True` marks plain
    (non-dataclass) classes encoded via __dict__ (role interfaces)."""
    name = cls.__name__
    prev = _REGISTRY.get(name)
    if prev is not None and prev is not cls:
        raise FdbError(ERROR_CODES["internal_error"],
                       message=f"serde name collision: {name}")
    _REGISTRY[name] = cls
    _IS_INTERFACE[name] = interface
    return cls


def register_module(mod) -> None:
    """Register every dataclass and every *Interface class defined in
    `mod` (classes merely imported into it are skipped)."""
    for obj in vars(mod).values():
        if not isinstance(obj, type) or obj.__module__ != mod.__name__:
            continue
        if dataclasses.is_dataclass(obj) or issubclass(obj, Enum):
            register(obj)
        elif obj.__name__.endswith("Interface"):
            register(obj, interface=True)


def _ship_fields(cls: type) -> list:
    names = _FIELDS.get(cls)
    if names is None:
        names = [f.name for f in dataclasses.fields(cls)
                 if f.name != "reply"]
        _FIELDS[cls] = names
    return names


# Fields grafted onto a struct after its legacy frame was fixed: elided
# from the legacy frame while they hold their default (the reference's
# rule, so the frames stay the same).
_ELIDE_DEFAULT_FIELDS = {
    "GetKeyValuesRequest": ("debug_id",),
}

# The reference's field lists where the port's trimmed class differs, in
# the reference's order: a name with a default is one the port's class
# lacks, written as that default.
_MISSING = object()
_REFERENCE_FIELDS: Dict[str, tuple] = {
    "CommitTransactionRef": (
        ("read_conflict_ranges", _MISSING), ("write_conflict_ranges",
                                             _MISSING),
        ("mutations", _MISSING), ("read_snapshot", _MISSING),
        ("report_conflicting_keys", _MISSING), ("lock_aware", False),
        ("tenant_id", _MISSING), ("tag", _MISSING)),
    "ReportRawCommittedVersionRequest": (("version", _MISSING),
                                         ("locked", False)),
    "GetRawCommittedVersionReply": (("version", _MISSING),
                                    ("locked", False)),
    "GetReadVersionRequest": (
        ("priority", _MISSING), ("transaction_count", _MISSING),
        ("flags", 0), ("debug_id", _MISSING), ("tags", _MISSING),
        ("tenant_id", _MISSING)),
    "TLogCommitRequest": (
        ("prev_version", _MISSING), ("version", _MISSING),
        ("known_committed_version", _MISSING), ("messages", _MISSING),
        ("span", "")),
    "GetValueRequest": (("key", _MISSING), ("version", _MISSING),
                        ("debug_id", ""), ("tag", "")),
    "GetKeyValuesRequest": (
        ("begin", _MISSING), ("end", _MISSING), ("version", _MISSING),
        ("limit", _MISSING), ("limit_bytes", _MISSING),
        ("reverse", _MISSING), ("debug_id", ""), ("tag", "")),
    # The control plane's messages (server/interfaces.py): the region,
    # storage-cache, TSS, backup, lock, tenant and health fields the port
    # does not keep.
    "DatabaseConfiguration": (
        ("n_tlogs", _MISSING), ("n_commit_proxies", _MISSING),
        ("n_grv_proxies", _MISSING), ("n_resolvers", _MISSING),
        ("n_storage", _MISSING), ("log_replication", _MISSING),
        ("storage_replication", _MISSING), ("conflict_backend", _MISSING),
        ("storage_engine", _MISSING), ("min_workers", _MISSING),
        ("usable_regions", 1), ("remote_dc", ""), ("n_log_routers", 1),
        ("n_remote_tlogs", 1), ("n_storage_caches", 0), ("tss_count", 0)),
    "RegisterWorkerRequest": (
        ("worker", _MISSING), ("process_class", _MISSING),
        ("recovered_logs", _MISSING), ("recovered_storage", _MISSING),
        ("storage_versions", _MISSING), ("locality", _MISSING),
        ("machine_stats", {}), ("metrics_doc", {}), ("health_report", {})),
    "WorkerRegistration": (
        ("worker", _MISSING), ("process_class", _MISSING),
        ("recovered_logs", _MISSING), ("recovered_storage", _MISSING),
        ("storage_versions", _MISSING), ("locality", _MISSING),
        ("machine_stats", {}), ("metrics_doc", {}), ("health_report", {}),
        ("registered_at", _MISSING)),
    "InitializeTLogRequest": (
        ("tlog_id", _MISSING), ("recovery_version", _MISSING),
        ("recover_tags", _MISSING), ("recover_popped", _MISSING),
        ("epoch", _MISSING), ("feeder_routers", None), ("feeder_tags", [])),
    "InitializeCommitProxyRequest": (
        ("proxy_id", _MISSING), ("epoch", _MISSING), ("master", _MISSING),
        ("resolvers", _MISSING), ("tlogs", _MISSING),
        ("key_resolvers_ranges", _MISSING),
        ("key_servers_ranges", _MISSING),
        ("storage_interfaces", _MISSING), ("recovery_version", _MISSING),
        ("backup_active", False), ("db_locked", None),
        ("region_replication", False), ("storage_caches", []),
        ("tss_mapping", {}), ("tenants", {}),
        ("tenant_metadata_version", 0)),
    "InitializeStorageRequest": (
        ("ss_id", _MISSING), ("tag", _MISSING), ("pull_tlogs", None),
        ("cache_role", False), ("tss_role", False), ("own_ranges", []),
        ("epoch", 0), ("engine", _MISSING)),
}

def encode_value(w: Writer, v: Any) -> None:
    if v is None:
        w.u8(T_NONE)
    elif v is True:
        w.u8(T_TRUE)
    elif v is False:
        w.u8(T_FALSE)
    elif isinstance(v, Enum):
        w.u8(T_ENUM).str_(type(v).__name__)
        encode_value(w, v.value)
    elif isinstance(v, int):
        if _I64_MIN <= v <= _I64_MAX:
            w.u8(T_INT).i64(v)
        else:
            neg = v < 0
            mag = (-v if neg else v)
            w.u8(T_BIGINT).u8(1 if neg else 0).bytes_(
                mag.to_bytes((mag.bit_length() + 7) // 8, "little"))
    elif isinstance(v, float):
        import struct
        w.u8(T_FLOAT)
        w._parts.append(struct.pack("<d", v))
    elif isinstance(v, (bytes, bytearray, memoryview)):
        w.u8(T_BYTES).bytes_(bytes(v))
    elif isinstance(v, str):
        w.u8(T_STR).str_(v)
    elif isinstance(v, (RequestStream, RequestStreamStub)):
        ep = v.endpoint if isinstance(v, RequestStream) else v.ep
        if not isinstance(ep, Endpoint):
            raise FdbError(ERROR_CODES["internal_error"],
                           message=f"RequestStream {v.name!r} not "
                                   "registered")
        w.u8(T_STREAM)
        _encode_endpoint(w, ep)
    elif isinstance(v, Endpoint):
        w.u8(T_ENDPOINT)
        _encode_endpoint(w, v)
    elif isinstance(v, NetworkAddress):
        w.u8(T_ADDRESS).str_(v.ip).u32(v.port)
    elif isinstance(v, FdbError):
        w.u8(T_ERROR).u32(v.code).str_(v.name).str_(str(v))
        # Optional structured payload (e.g. not_committed carrying the
        # conflicting key ranges for \xff\xff/transaction/conflicting_keys)
        encode_value(w, getattr(v, "details", None))
    elif isinstance(v, tuple):
        w.u8(T_TUPLE).u32(len(v))
        for x in v:
            encode_value(w, x)
    elif isinstance(v, list):
        w.u8(T_LIST).u32(len(v))
        for x in v:
            encode_value(w, x)
    elif isinstance(v, dict):
        w.u8(T_DICT).u32(len(v))
        for k, x in v.items():
            encode_value(w, k)
            encode_value(w, x)
    elif type(v).__name__ in _COLUMNAR_CODECS:
        # Hot commit-pipeline RPC (ResolveTransactionBatchRequest /
        # TLogCommitRequest / ResolveTransactionBatchReply): knob-gated
        # columnar frame, instrumented either way (Encode band).
        _encode_hot(w, v)
    elif dataclasses.is_dataclass(v) and not isinstance(v, type):
        _encode_dataclass(w, v)
    elif _REGISTRY.get(type(v).__name__) is type(v):
        # registered interface class: __dict__ minus private/sim-only attrs
        w.u8(T_OBJECT).str_(type(v).__name__)
        items = [(k, x) for k, x in vars(v).items()
                 if not k.startswith("_") and k != "role"]
        w.u32(len(items))
        for k, x in items:
            w.str_(k)
            encode_value(w, x)
    else:
        raise FdbError(ERROR_CODES["internal_error"],
                       message=f"cannot serialize {type(v).__name__}")


def _encode_dataclass(w: Writer, v: Any) -> None:
    """The legacy T_DATACLASS field-name/value encoding (schema-evolving;
    the columnar codecs fall back to it for unexpected payload shapes)."""
    cls = type(v)
    name = cls.__name__
    if _REGISTRY.get(name) is not cls:
        raise FdbError(ERROR_CODES["internal_error"],
                       message=f"unregistered dataclass {name}")
    w.u8(T_DATACLASS).str_(name)
    ref = _REFERENCE_FIELDS.get(name)
    if ref is None:
        items = [(f, getattr(v, f)) for f in _ship_fields(cls)]
    else:
        items = [(f, getattr(v, f) if d is _MISSING else d) for f, d in ref]
    elide = _ELIDE_DEFAULT_FIELDS.get(name)
    if elide:
        items = [(f, x) for f, x in items if f not in elide or x]
    w.u32(len(items))
    for fname, x in items:
        w.str_(fname)
        encode_value(w, x)


def _encode_endpoint(w: Writer, ep: Endpoint) -> None:
    w.str_(ep.address.ip).u32(ep.address.port).str_(ep.token)


def _decode_endpoint(r: Reader) -> Endpoint:
    ip = r.str_()
    port = r.u32()
    token = r.str_()
    return Endpoint(NetworkAddress(ip, port), token)


def decode_value(r: Reader) -> Any:
    tag = r.u8()
    if tag == T_NONE:
        return None
    if tag == T_TRUE:
        return True
    if tag == T_FALSE:
        return False
    if tag == T_INT:
        return r.i64()
    if tag == T_BIGINT:
        neg = r.u8()
        v = int.from_bytes(r.bytes_(), "little")
        return -v if neg else v
    if tag == T_FLOAT:
        import struct
        v = struct.unpack_from("<d", r._d, r._o)[0]
        r._o += 8
        return v
    if tag == T_BYTES:
        return r.bytes_()
    if tag == T_STR:
        return r.str_()
    if tag == T_STREAM:
        ep = _decode_endpoint(r)
        rs = RequestStream(ep.token.split(":", 1)[0])
        rs.set_endpoint(ep)
        return rs
    if tag == T_ENDPOINT:
        return _decode_endpoint(r)
    if tag == T_ADDRESS:
        ip = r.str_()
        return NetworkAddress(ip, r.u32())
    if tag == T_ERROR:
        code = r.u32()
        name = r.str_()
        msg = r.str_()
        e = FdbError(code, name, msg)
        details = decode_value(r)
        if details is not None:
            e.details = details
        return e
    if tag == T_TUPLE:
        return tuple(decode_value(r) for _ in range(r.u32()))
    if tag == T_LIST:
        return [decode_value(r) for _ in range(r.u32())]
    if tag == T_DICT:
        n = r.u32()
        out = {}
        for _ in range(n):
            k = decode_value(r)
            out[k] = decode_value(r)
        return out
    if tag == T_ENUM:
        cls = _required(r.str_())
        return cls(decode_value(r))
    if tag == T_DATACLASS:
        cls = _required(r.str_())
        if cls.__name__ in _COLUMNAR_CODECS:
            # Legacy-format frame of a hot RPC (mixed-format peer): still
            # decodes transparently, still lands in the Decode band so
            # the e2e attribution sees serialization cost either way.
            t0 = _now()
            v = _decode_dataclass_body(r, cls)
            rpc_collection().histogram("Decode").record(_now() - t0)
            return v
        return _decode_dataclass_body(r, cls)
    if tag == T_OBJECT:
        cls = _required(r.str_())
        obj = cls.__new__(cls)
        for _ in range(r.u32()):
            k = r.str_()
            setattr(obj, k, decode_value(r))
        return obj
    if tag == T_COLUMNAR:
        return _decode_columnar(r)
    raise FdbError(ERROR_CODES["internal_error"],
                   message=f"bad serde tag {tag}")


def _required(name: str) -> type:
    cls = _REGISTRY.get(name)
    if cls is None:
        raise FdbError(ERROR_CODES["internal_error"],
                       message=f"unknown serde type {name!r}")
    return cls


def _decode_dataclass_body(r: Reader, cls: type) -> Any:
    n = r.u32()
    kw = {}
    known = {f.name for f in dataclasses.fields(cls)}
    for _ in range(n):
        fname = r.str_()
        val = decode_value(r)
        if fname in known:     # unknown fields: skip (schema evolution)
            kw[fname] = val
    return cls(**kw)


# ---------------------------------------------------------------------------
# Columnar frames for the hot commit-pipeline RPCs
# ---------------------------------------------------------------------------
# The commit fan-out's bytes are dominated by three messages: the
# proxy->resolver ResolveTransactionBatchRequest (thousands of clipped
# conflict ranges per batch), its verdict reply, and the proxy->TLog push
# (the batch's whole mutation stream).  The generic T_DATACLASS encoding
# pays a field-NAME string + a type tag per value and a per-object header
# per KeyRange/Mutation; at production batch sizes that is most of the
# wire image.  The columnar frames below instead write one batch-level
# header and pack every key/range/mutation parameter into ONE contiguous
# prefix-truncated key stream (varint shared-prefix length vs the
# previous key + suffix bytes — the reference's Redwood/ssd page key
# compression applied to the wire), with verdicts/flags/counts as flat
# byte or varint columns.
#
# Mixed-format safety: encoding is gated on RPC_COLUMNAR_ENABLED (default
# OFF — knobs-off wire images are bit-identical to the legacy format),
# while DECODING is format-transparent and always
# available: a columnar-off peer reads columnar frames and a columnar-on
# peer reads legacy frames, so the knob can be flipped per process /
# mid-rollout without a protocol-version bump.  Frames carry a format
# version byte for future evolution.
#
# Observability: Encode/Decode latency bands + frame/byte counters on the
# process-wide "Rpc" CounterCollection (rpc_collection()), and CommitDebug
# span points (Rpc.encode.<Type>/Rpc.decode.<Type>) when the message
# carries a debug-tagged batch span.

_COLUMNAR_VERSION = 1
# Per-message format versions: the read-reply family moved to
# a keys-stream + value-length-column layout, stamped 2 so a frame from
# the older interleaved layout is rejected loudly instead of misdecoded.
# Names absent here are version 1.
_CODEC_VERSIONS: Dict[str, int] = {
    "GetKeyValuesReply": 2,
}


def _codec_version(name: str) -> int:
    return _CODEC_VERSIONS.get(name, _COLUMNAR_VERSION)


_rpc_metrics = None


def rpc_collection():
    global _rpc_metrics
    if _rpc_metrics is None:
        from ..core.histogram import CounterCollection
        _rpc_metrics = CounterCollection("Rpc", "serde")
    return _rpc_metrics


def _columnar_enabled() -> bool:
    from ..core.knobs import server_knobs
    return bool(server_knobs().RPC_COLUMNAR_ENABLED)


def _now() -> float:
    """Band clock: the installed reactor's now(); 0.0 when encoding
    outside any loop (a frame made by a test or a tool) — the
    band then records nothing meaningful but nothing crashes."""
    from ..core.scheduler import current_event_loop_or_none
    loop = current_event_loop_or_none()
    return loop.now() if loop is not None else 0.0


# -- flat-column primitives (varints, zigzag, prefix-truncated keys) --------

def _wv(out: bytearray, v: int) -> None:
    """LEB128 varint (unsigned)."""
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _wz(out: bytearray, v: int) -> None:
    """Zigzag varint (signed; versions, tags, tenant ids)."""
    _wv(out, (v << 1) if v >= 0 else ((-v) << 1) - 1)


def _wb(out: bytearray, b: bytes) -> None:
    _wv(out, len(b))
    out += b


def _rv(r: Reader) -> int:
    d = r._d
    o = r._o
    v = 0
    s = 0
    while True:
        b = d[o]
        o += 1
        v |= (b & 0x7F) << s
        if b < 0x80:
            break
        s += 7
    r._o = o
    return v


def _rz(r: Reader) -> int:
    z = _rv(r)
    return (z >> 1) if not (z & 1) else -((z + 1) >> 1)


def _rd_raw(r: Reader, n: int) -> bytes:
    b = r._d[r._o:r._o + n]
    r._o += n
    return b


def _rb(r: Reader) -> bytes:
    return _rd_raw(r, _rv(r))


# Longest-common-prefix helper, shared with the B-tree's compressed
# leaf pages (one implementation: core/wire.py).
from ..core.wire import longest_common_prefix_len as _prefix_len  # noqa: E402


def _enc_key_stream(out: bytearray, keys: list) -> None:
    """All of a frame's keys/params as one contiguous column: each entry
    is (shared-prefix-length vs the previous entry, suffix).  Conflict
    ranges arrive begin/end interleaved and batch-adjacent, so real
    streams share long prefixes."""
    _wv(out, len(keys))
    prev = b""
    for k in keys:
        p = _prefix_len(prev, k)
        _wv(out, p)
        _wv(out, len(k) - p)
        out += k[p:]
        prev = k


def _dec_key_stream(r: Reader) -> list:
    n = _rv(r)
    keys = []
    prev = b""
    d = r._d
    for _ in range(n):
        p = _rv(r)
        s = _rv(r)
        o = r._o
        suffix = d[o:o + s]
        r._o = o + s
        k = (prev[:p] + suffix) if p else suffix
        keys.append(k)
        prev = k
    return keys


# -- shared CommitTransactionRef columns -------------------------------------
# Used by the resolution fan-out AND the client->proxy commit request;
# snapshots are stored as zigzag deltas vs `base_version` (the batch's
# commit version for resolution requests, 0 for client commits).

def _enc_txn_meta(out: bytearray, t: Any, base_version: int,
                  keys: list, mtypes: bytearray) -> None:
    tid = t.tenant_id
    has_tenant = tid is not None and tid != -1
    flags = ((1 if t.report_conflicting_keys else 0)
             | (2 if getattr(t, "lock_aware", False) else 0)
             | (4 if has_tenant else 0)
             | (8 if t.tag else 0))
    out.append(flags)
    _wz(out, base_version - t.read_snapshot)
    rr = t.read_conflict_ranges
    wr = t.write_conflict_ranges
    ms = t.mutations
    _wv(out, len(rr))
    _wv(out, len(wr))
    _wv(out, len(ms))
    if has_tenant:
        _wz(out, tid)
    if flags & 8:
        _wb(out, t.tag.encode())
    for rg in rr:
        keys.append(rg.begin)
        keys.append(rg.end)
    for rg in wr:
        keys.append(rg.begin)
        keys.append(rg.end)
    for m in ms:
        mtypes.append(int(m.type))
        keys.append(m.param1)
        keys.append(m.param2)


def _dec_txn_meta(r: Reader, base_version: int) -> tuple:
    d = r._d
    flags = d[r._o]
    r._o += 1
    snap = base_version - _rz(r)
    nr = _rv(r)
    nw = _rv(r)
    nm = _rv(r)
    tid = _rz(r) if flags & 4 else -1
    tag = _rb(r).decode() if flags & 8 else ""
    return flags, snap, nr, nw, nm, tid, tag


def _build_txn(meta: tuple, keys: list, ki: int, mtypes: bytes,
               mi: int) -> tuple:
    from ..txn.types import (CommitTransactionRef, KeyRange, Mutation,
                             MutationType)
    flags, snap, nr, nw, nm, tid, tag = meta
    rr = []
    for _ in range(nr):
        rr.append(KeyRange(keys[ki], keys[ki + 1]))
        ki += 2
    wr = []
    for _ in range(nw):
        wr.append(KeyRange(keys[ki], keys[ki + 1]))
        ki += 2
    ms = []
    for _ in range(nm):
        ms.append(Mutation(MutationType(mtypes[mi]),
                           keys[ki], keys[ki + 1]))
        mi += 1
        ki += 2
    # The port's CommitTransactionRef has no lock_aware (flag 2).
    return CommitTransactionRef(
        read_conflict_ranges=rr, write_conflict_ranges=wr,
        mutations=ms, read_snapshot=snap,
        report_conflicting_keys=bool(flags & 1),
        tenant_id=tid, tag=tag), ki, mi


# -- ResolveTransactionBatchRequest ------------------------------------------

def _enc_resolve_request(v: Any) -> bytes:
    out = bytearray()
    version = v.version
    _wz(out, v.prev_version)
    _wz(out, version)
    _wz(out, v.last_received_version)
    _wb(out, v.proxy_id.encode())
    _wb(out, v.span.encode())
    st = v.txn_state_transactions
    _wv(out, len(st))
    for i in st:
        _wv(out, i)
    txns = v.transactions
    _wv(out, len(txns))
    keys: list = []
    mtypes = bytearray()
    for t in txns:
        _enc_txn_meta(out, t, version, keys, mtypes)
    out += mtypes
    _enc_key_stream(out, keys)
    return bytes(out)


def _dec_resolve_request(r: Reader) -> Any:
    from ..server.interfaces import ResolveTransactionBatchRequest
    prev = _rz(r)
    version = _rz(r)
    lrv = _rz(r)
    proxy_id = _rb(r).decode()
    span = _rb(r).decode()
    st = [_rv(r) for _ in range(_rv(r))]
    n = _rv(r)
    metas = []
    total_m = 0
    for _ in range(n):
        meta = _dec_txn_meta(r, version)
        metas.append(meta)
        total_m += meta[4]
    mtypes = _rd_raw(r, total_m)
    keys = _dec_key_stream(r)
    ki = 0
    mi = 0
    txns = []
    for meta in metas:
        txn, ki, mi = _build_txn(meta, keys, ki, mtypes, mi)
        txns.append(txn)
    return ResolveTransactionBatchRequest(
        prev_version=prev, version=version, last_received_version=lrv,
        transactions=txns, txn_state_transactions=st,
        proxy_id=proxy_id, span=span)


# -- CommitTransactionRequest (client -> proxy) ------------------------------
# The client edge's hottest message: ONE transaction's full conflict
# ranges + mutations, encoded with the same column/key-stream machinery
# (snapshot delta base 0 — there is no batch version yet).

def _enc_commit_request(v: Any) -> bytes:
    out = bytearray()
    flags = ((1 if v.repair_eligible else 0)
             | (2 if v.debug_id else 0))
    out.append(flags)
    _wv(out, int(v.repair_attempt))
    if flags & 2:
        _wb(out, v.debug_id.encode())
    keys: list = []
    mtypes = bytearray()
    _enc_txn_meta(out, v.transaction, 0, keys, mtypes)
    out += mtypes
    _enc_key_stream(out, keys)
    return bytes(out)


def _dec_commit_request(r: Reader) -> Any:
    from ..server.interfaces import CommitTransactionRequest
    d = r._d
    flags = d[r._o]
    r._o += 1
    attempt = _rv(r)
    debug_id = _rb(r).decode() if flags & 2 else ""
    meta = _dec_txn_meta(r, 0)
    mtypes = _rd_raw(r, meta[4])
    keys = _dec_key_stream(r)
    txn, _ki, _mi = _build_txn(meta, keys, 0, mtypes, 0)
    return CommitTransactionRequest(
        transaction=txn, debug_id=debug_id,
        repair_eligible=bool(flags & 1), repair_attempt=attempt)


# -- ResolveTransactionBatchReply --------------------------------------------

def _enc_resolve_reply(v: Any) -> bytes:
    out = bytearray()
    com = v.committed
    _wv(out, len(com))
    out += bytes(bytearray(int(c) for c in com))
    keys: list = []
    cr = v.conflicting_ranges
    _wv(out, len(cr))
    for i, ranges in cr.items():
        _wv(out, i)
        _wv(out, len(ranges))
        for b, e in ranges:
            if type(b) is not bytes or type(e) is not bytes:
                raise TypeError("non-bytes conflicting range")
            keys.append(b)
            keys.append(e)
    ae = v.attribution_exact
    _wv(out, len(ae))
    for i, x in ae.items():
        _wv(out, (i << 1) | (1 if x else 0))
    _enc_key_stream(out, keys)
    # State transactions are rare metadata (mutations + verdicts):
    # generic encoding, appended as a sub-message.
    sw = Writer()
    encode_value(sw, v.state_transactions)
    out += sw.done()
    return bytes(out)


def _dec_resolve_reply(r: Reader) -> Any:
    from ..server.interfaces import ResolveTransactionBatchReply
    from ..txn.types import CommitResult
    n = _rv(r)
    codes = _rd_raw(r, n)
    committed = [CommitResult(b) for b in codes]
    cr_meta = []
    for _ in range(_rv(r)):
        i = _rv(r)
        k = _rv(r)
        cr_meta.append((i, k))
    ae = {}
    for _ in range(_rv(r)):
        z = _rv(r)
        ae[z >> 1] = bool(z & 1)
    keys = _dec_key_stream(r)
    ki = 0
    cr = {}
    for i, k in cr_meta:
        lst = []
        for _ in range(k):
            lst.append((keys[ki], keys[ki + 1]))
            ki += 2
        cr[i] = lst
    state = decode_value(r)
    return ResolveTransactionBatchReply(
        committed=committed, state_transactions=state,
        conflicting_ranges=cr, attribution_exact=ae)


# -- TLogCommitRequest -------------------------------------------------------

def _enc_tlog_commit(v: Any) -> bytes:
    out = bytearray()
    _wz(out, v.prev_version)
    _wz(out, v.version)
    _wz(out, v.known_committed_version)
    _wb(out, getattr(v, "span", "").encode())
    msgs = v.messages
    _wv(out, len(msgs))
    keys: list = []
    mtypes = bytearray()
    for tag, ms in msgs.items():
        _wz(out, tag)
        _wv(out, len(ms))
        for m in ms:
            mtypes.append(int(m.type))
            keys.append(m.param1)
            keys.append(m.param2)
    out += mtypes
    _enc_key_stream(out, keys)
    return bytes(out)


def _dec_tlog_commit(r: Reader) -> Any:
    from ..server.interfaces import TLogCommitRequest
    from ..txn.types import Mutation, MutationType
    prev = _rz(r)
    version = _rz(r)
    kcv = _rz(r)
    _rb(r)      # the span, which the port's TLogCommitRequest lacks
    meta = []
    total = 0
    for _ in range(_rv(r)):
        tag = _rz(r)
        k = _rv(r)
        meta.append((tag, k))
        total += k
    mtypes = _rd_raw(r, total)
    keys = _dec_key_stream(r)
    ki = 0
    mi = 0
    messages = {}
    for tag, k in meta:
        ms = []
        for _ in range(k):
            ms.append(Mutation(MutationType(mtypes[mi]),
                               keys[ki], keys[ki + 1]))
            mi += 1
            ki += 2
        messages[tag] = ms
    return TLogCommitRequest(prev_version=prev, version=version,
                             known_committed_version=kcv,
                             messages=messages)


# -- storage read path (client <-> storage, per transaction) -----------------

def _enc_get_value_request(v: Any) -> bytes:
    out = bytearray()
    debug_id = getattr(v, "debug_id", "")
    tag = getattr(v, "tag", "")
    flags = (1 if debug_id else 0) | (2 if tag else 0)
    out.append(flags)
    _wz(out, v.version)
    _wb(out, v.key)
    if flags & 1:
        _wb(out, debug_id.encode())
    if flags & 2:
        _wb(out, tag.encode())
    return bytes(out)


def _dec_get_value_request(r: Reader) -> Any:
    from ..server.interfaces import GetValueRequest
    flags = r._d[r._o]
    r._o += 1
    version = _rz(r)
    key = _rb(r)
    # The debug id and the tag, which the port's GetValueRequest lacks.
    if flags & 1:
        _rb(r)
    if flags & 2:
        _rb(r)
    return GetValueRequest(key=key, version=version)


def _enc_get_value_reply(v: Any) -> bytes:
    out = bytearray()
    val = v.value
    if val is None:
        out.append(0)
    else:
        if type(val) is not bytes:
            raise TypeError("non-bytes value")
        out.append(1)
        _wb(out, val)
    _wz(out, v.version)
    return bytes(out)


def _dec_get_value_reply(r: Reader) -> Any:
    from ..server.interfaces import GetValueReply
    flags = r._d[r._o]
    r._o += 1
    val = _rb(r) if flags & 1 else None
    return GetValueReply(value=val, version=_rz(r))


def _enc_get_key_values_request(v: Any) -> bytes:
    """The range-read request: begin/end share a mini prefix-truncated
    stream (range endpoints usually share a long shard/tenant prefix),
    limits ride as varints."""
    out = bytearray()
    tag = getattr(v, "tag", "")
    debug_id = getattr(v, "debug_id", "")
    flags = ((1 if v.reverse else 0) | (2 if tag else 0)
             | (4 if debug_id else 0))
    out.append(flags)
    _wz(out, v.version)
    _wv(out, v.limit)
    _wv(out, v.limit_bytes)
    begin, end = v.begin, v.end
    if type(begin) is not bytes or type(end) is not bytes:
        raise TypeError("non-bytes range endpoint")
    _wb(out, begin)
    p = _prefix_len(begin, end)
    _wv(out, p)
    _wv(out, len(end) - p)
    out += end[p:]
    if flags & 2:
        _wb(out, tag.encode())
    if flags & 4:
        _wb(out, debug_id.encode())
    return bytes(out)


def _dec_get_key_values_request(r: Reader) -> Any:
    from ..server.interfaces import GetKeyValuesRequest
    flags = r._d[r._o]
    r._o += 1
    version = _rz(r)
    limit = _rv(r)
    limit_bytes = _rv(r)
    begin = _rb(r)
    p = _rv(r)
    s = _rv(r)
    end = begin[:p] + _rd_raw(r, s)
    # The tag and the debug id, which the port's GetKeyValuesRequest
    # lacks.
    if flags & 2:
        _rb(r)
    if flags & 4:
        _rb(r)
    return GetKeyValuesRequest(begin=begin, end=end, version=version,
                               limit=limit, limit_bytes=limit_bytes,
                               reverse=bool(flags & 1))


def _enc_get_key_values_reply(v: Any) -> bytes:
    """Format v2: the reply's KEYS ride one prefix-truncated
    stream (adjacent result rows share long prefixes — a range scan's
    whole point) and VALUES ride a varint length column + one contiguous
    blob.  v1 interleaved values into the key stream, diffing each value
    against its neighboring key — pure overhead for binary values."""
    out = bytearray()
    out.append((1 if v.more else 0))
    _wz(out, v.version)
    data = v.data
    keys: list = []
    vals: list = []
    for k, val in data:
        if type(k) is not bytes or type(val) is not bytes:
            raise TypeError("non-bytes row")
        keys.append(k)
        vals.append(val)
    _enc_key_stream(out, keys)
    for val in vals:
        _wv(out, len(val))
    out += b"".join(vals)
    return bytes(out)


def _dec_get_key_values_reply(r: Reader) -> Any:
    from ..server.interfaces import GetKeyValuesReply
    flags = r._d[r._o]
    r._o += 1
    version = _rz(r)
    keys = _dec_key_stream(r)
    lens = [_rv(r) for _ in range(len(keys))]
    d = r._d
    o = r._o
    vals = []
    for n in lens:
        vals.append(d[o:o + n])
        o += n
    r._o = o
    return GetKeyValuesReply(data=list(zip(keys, vals)),
                             more=bool(flags & 1), version=version)


# -- TLogPeekReply (TLog -> storage pull path) -------------------------------
# The commit stream's SECOND trip over the wire: every mutation ships
# again to each pulling storage replica.  Versions ascend, so they pack
# as deltas; params ride the shared key stream.

def _enc_tlog_peek_reply(v: Any) -> bytes:
    out = bytearray()
    _wz(out, v.end)
    _wz(out, v.max_known_version)
    entries = v.messages
    _wv(out, len(entries))
    keys: list = []
    mtypes = bytearray()
    prev = 0
    for ver, ms in entries:
        _wz(out, ver - prev)
        prev = ver
        _wv(out, len(ms))
        for m in ms:
            mtypes.append(int(m.type))
            keys.append(m.param1)
            keys.append(m.param2)
    out += mtypes
    _enc_key_stream(out, keys)
    return bytes(out)


def _dec_tlog_peek_reply(r: Reader) -> Any:
    from ..server.interfaces import TLogPeekReply
    from ..txn.types import Mutation, MutationType
    end = _rz(r)
    mkv = _rz(r)
    meta = []
    total = 0
    prev = 0
    for _ in range(_rv(r)):
        prev += _rz(r)
        k = _rv(r)
        meta.append((prev, k))
        total += k
    mtypes = _rd_raw(r, total)
    keys = _dec_key_stream(r)
    ki = 0
    mi = 0
    messages = []
    for ver, k in meta:
        ms = []
        for _ in range(k):
            ms.append(Mutation(MutationType(mtypes[mi]),
                               keys[ki], keys[ki + 1]))
            mi += 1
            ki += 2
        messages.append((ver, ms))
    return TLogPeekReply(messages=messages, end=end,
                         max_known_version=mkv)


_COLUMNAR_CODECS: Dict[str, tuple] = {
    "ResolveTransactionBatchRequest": (_enc_resolve_request,
                                       _dec_resolve_request),
    "ResolveTransactionBatchReply": (_enc_resolve_reply,
                                     _dec_resolve_reply),
    "TLogCommitRequest": (_enc_tlog_commit, _dec_tlog_commit),
    "CommitTransactionRequest": (_enc_commit_request, _dec_commit_request),
    "TLogPeekReply": (_enc_tlog_peek_reply, _dec_tlog_peek_reply),
    "GetValueRequest": (_enc_get_value_request, _dec_get_value_request),
    "GetValueReply": (_enc_get_value_reply, _dec_get_value_reply),
    "GetKeyValuesRequest": (_enc_get_key_values_request,
                            _dec_get_key_values_request),
    "GetKeyValuesReply": (_enc_get_key_values_reply,
                          _dec_get_key_values_reply),
}


def _encode_hot(w: Writer, v: Any) -> None:
    """Encode one hot RPC message: columnar when the knob is on (legacy
    fallback for unexpected payload shapes — the codecs only understand
    the canonical KeyRange/Mutation/tuple vocabulary), legacy otherwise.
    Either way the Encode band and frame counters record it."""
    name = type(v).__name__
    t0 = _now()
    col = rpc_collection()
    payload = None
    if _columnar_enabled():
        try:
            payload = _COLUMNAR_CODECS[name][0](v)
        except Exception:  # noqa: BLE001 — shape outside the codec's
            payload = None  # vocabulary: the legacy format carries it
    if payload is not None:
        w.u8(T_COLUMNAR).str_(name)
        w.u8(_codec_version(name))
        w._parts.append(payload)
        col.counter("ColumnarFrames").add(1)
        col.counter("ColumnarBytes").add(len(payload))
    else:
        _encode_dataclass(w, v)
        col.counter("LegacyFrames").add(1)
    col.histogram("Encode").record(_now() - t0)
    span = getattr(v, "span", "")
    if span:
        from ..core.trace import trace_batch_event
        trace_batch_event("CommitDebug", span, f"Rpc.encode.{name}")


def _decode_columnar(r: Reader) -> Any:
    t0 = _now()
    name = r.str_()
    ver = r.u8()
    if ver != _codec_version(name):
        raise FdbError(ERROR_CODES["internal_error"],
                       message=f"unknown columnar frame version {ver} "
                               f"for {name}")
    codec = _COLUMNAR_CODECS.get(name)
    if codec is None:
        raise FdbError(ERROR_CODES["internal_error"],
                       message=f"unknown columnar type {name!r}")
    v = codec[1](r)
    rpc_collection().histogram("Decode").record(_now() - t0)
    span = getattr(v, "span", "")
    if span:
        from ..core.trace import trace_batch_event
        trace_batch_event("CommitDebug", span, f"Rpc.decode.{name}")
    return v


def encode_message(v: Any) -> bytes:
    w = Writer()
    encode_value(w, v)
    return w.done()


def decode_message(b: bytes) -> Any:
    return decode_value(Reader(b))


# -- span-carrying envelope (reference flow/Tracing.h SpanContext riding
# every FlowTransport packet): the span id travels OUTSIDE the value so
# transports can stamp/propagate it without understanding the payload. ----

def encode_envelope(v: Any, span: str = "") -> bytes:
    """Message + span context (the span the caller names: the port keeps
    no ambient span, so it writes the reference's frame of a caller with
    none set)."""
    w = Writer().str_(span)
    encode_value(w, v)
    return w.done()


def decode_envelope(b: bytes):
    """(value, span) from an envelope frame."""
    r = Reader(b)
    span = r.str_()
    return decode_value(r), span


_bootstrapped = False


def bootstrap_registry() -> None:
    """Register every module that defines types the port's network
    carries (the reference's bootstrap_registry over the port's modules:
    its messages, interfaces, the coordinators', cluster controller's and
    master's messages, the waitFailure request and data distribution's
    module, as the reference registers its; FdbError
    travels as T_ERROR and needs no registration).  Idempotent; called by
    the real transport at startup."""
    global _bootstrapped
    if _bootstrapped:
        return
    _bootstrapped = True
    import importlib
    for modname in (
            "foundationdb_tpu_torch.txn.types",
            "foundationdb_tpu_torch.server.interfaces",
            "foundationdb_tpu_torch.server.coordination",
            "foundationdb_tpu_torch.server.cluster_controller",
            "foundationdb_tpu_torch.server.master",
            "foundationdb_tpu_torch.server.failure",
            "foundationdb_tpu_torch.server.data_distribution",
    ):
        register_module(importlib.import_module(modname))
