"""System keyspace conventions and the shard map's metadata mutations
(trimmed copy of foundationdb_tpu/server/system_data.py, reference
fdbclient/SystemData.cpp and fdbserver/ApplyMetadataMutation.cpp:52-61).

What the resolution plane and the write path read: the first key of the
`\\xff` system range, which every resolver owns (RESOLVER_ALL) and whose
mutations make a transaction a state transaction; the shard map under
`\\xff/keyServers/`, whose committed mutations every commit proxy applies
to its map of storage teams (apply_key_servers_mutation, the shard-map
part of ApplyMetadataMutation.cpp) and also logs on TXS_TAG; the
disownment fence the committing proxy sends a server a team change drops
(DISOWN_SHARD_PREFIX, disowned_spans); the server registry, whose
entries a worker commits for the storage servers it recruits or brings
back from disk and every commit proxy applies to its storage directory
(server_tag_key, server_tag_value, parse_server_tag_mutation); the
exclusion list under `\\xff/conf/excluded/`, which the operator writes
(client/management.py) and data distribution follows and clears when it
retires a dead server (excluded_key); the database configuration as
committed `\\xff/conf/<field>` keys (conf_key, parse_conf_mutation, which
leaves the exclusion list out); the committed floor of storage tags
(MAX_TAG_KEY) and the perpetual wiggle's position
(STORAGE_WIGGLE_POS_KEY).  Of the reference's other metadata (backup,
lock, tenants, coordinators, knobs, cache ranges) the port has none.
"""

from __future__ import annotations

from typing import List

from ..core.wire import Reader, Writer
from ..txn.types import Mutation, MutationType
from .interfaces import TXS_TAG, Tag  # noqa: F401  (re-export TXS_TAG)
from .shardmap import RangeMap

SYSTEM_KEYS_BEGIN = b"\xff"
SYSTEM_KEYS_END = b"\xff\xff"
KEY_SERVERS_PREFIX = b"\xff/keyServers/"
KEY_SERVERS_END = b"\xff/keyServers0"
SERVER_TAG_PREFIX = b"\xff/serverTag/"
SERVER_TAG_END = b"\xff/serverTag0"
# Tag -> b"1": the storage servers the operator excluded (reference
# excludedServersPrefix under \xff/conf/).  Data distribution drains
# every shard off them; they stay fetch sources while they drain.
EXCLUDED_PREFIX = b"\xff/conf/excluded/"
EXCLUDED_END = b"\xff/conf/excluded0"
# The database configuration as ordinary keys (reference \xff/conf/
# parsed by DatabaseConfiguration, changed by ManagementAPI `configure`):
# field name -> its printed value, e.g. \xff/conf/n_resolvers = b"2".
# The exclusion list nests here and is not a configuration field.
CONF_PREFIX = b"\xff/conf/"
CONF_END = b"\xff/conf0"

# The coordinators' connection spec as committed data (reference
# \xff/coordinators, ManagementAPI changeQuorum): the management API
# writes the new spec here and the master's _coordinators_watch moves
# the coordinated state when it differs from the running quorum.
COORDINATORS_KEY = b"\xff/coordinators"
# The floor of storage tags, committed in the transaction that claims a
# tag: no tag is issued twice across recoveries, even after a retired
# tag's registry and exclusion entries are cleared.
MAX_TAG_KEY = b"\xff/maxServerTag"
# The last tag the perpetual wiggle finished (reference
# perpetualStorageWiggleIDPrefix): a new distributor resumes after it.
STORAGE_WIGGLE_POS_KEY = b"\xff/storageWigglePos"


def key_servers_key(key: bytes) -> bytes:
    """The system key whose value holds the storage team for the shard
    STARTING at `key` (reference keyServersKey)."""
    return KEY_SERVERS_PREFIX + key


def key_servers_value(tags: List[Tag]) -> bytes:
    w = Writer().u16(len(tags))
    for t in tags:
        w.u32(t)
    return w.done()


def decode_key_servers_value(blob: bytes) -> List[Tag]:
    r = Reader(blob)
    return [r.u32() for _ in range(r.u16())]


def server_tag_key(tag: Tag) -> bytes:
    """The registry key of the storage server with `tag` (reference
    serverTagKeyFor)."""
    return SERVER_TAG_PREFIX + b"%010d" % tag


def server_tag_value(interface) -> bytes:
    """A storage server's interface as its registry value: the wire's
    frame of it (rpc/serde.py, as the reference stores it)."""
    from ..rpc import serde
    serde.bootstrap_registry()
    return serde.encode_message(interface)


def decode_server_tag_value(blob: bytes):
    from ..rpc import serde
    serde.bootstrap_registry()
    return serde.decode_message(blob)


def parse_server_tag_mutation(m: Mutation):
    """[(tag, interface)] for a registry write, [(tag, None)] for each
    tag a registry clear retires, else None (reference :226)."""
    if m.type == MutationType.SetValue and \
            m.param1.startswith(SERVER_TAG_PREFIX):
        tag = int(m.param1[len(SERVER_TAG_PREFIX):])
        return [(tag, decode_server_tag_value(m.param2))]
    if m.type == MutationType.ClearRange and \
            m.param1 < SERVER_TAG_END and m.param2 > SERVER_TAG_PREFIX:
        # The retired tags exactly: the candidate keys inside the clear
        # (its bounds need not be registry keys; tags are small ints).
        lo = max(m.param1, SERVER_TAG_PREFIX)
        digits = bytes(c for c in lo[len(SERVER_TAG_PREFIX):][:10]
                       if 48 <= c <= 57)
        lo_tag = int(digits) if len(digits) == 10 else 0
        out = []
        for tag in range(lo_tag, lo_tag + 10_000):
            k = server_tag_key(tag)
            if k >= m.param2:
                break
            if k >= m.param1:
                out.append((tag, None))
        return out or None
    return None


def excluded_key(tag: Tag) -> bytes:
    """The exclusion-list key of the storage server with `tag`."""
    return EXCLUDED_PREFIX + b"%010d" % tag


def conf_key(field_name: str) -> bytes:
    return CONF_PREFIX + field_name.encode()


def parse_conf_mutation(m: Mutation):
    """[(field name, value or None)] for a \\xff/conf/ configuration
    mutation (None: the field cleared back to its default), else None
    (reference :198).  The exclusion list is not configuration: a write
    or a clear inside it alone parses as None."""
    if m.type == MutationType.SetValue:
        if not m.param1.startswith(CONF_PREFIX) or \
                m.param1.startswith(EXCLUDED_PREFIX):
            return None
        return [(m.param1[len(CONF_PREFIX):].decode(), m.param2)]
    if m.type == MutationType.ClearRange:
        lo = max(m.param1, CONF_PREFIX)
        hi = min(m.param2, CONF_END)
        if hi <= lo:
            return None
        if lo >= EXCLUDED_PREFIX and hi <= EXCLUDED_END:
            return None
        if hi == lo + b"\x00" and lo.startswith(CONF_PREFIX):
            # A point clear ([key, key + \x00)) reverts one field.
            return [(lo[len(CONF_PREFIX):].decode(), None)]
        # A broad clear cannot name its keys: "*" resets every field.
        return [("*", None)]
    return None


# Private shard-disownment mutations (reference ApplyMetadataMutation's
# PRIVATIZED \xff/serverKeys/<id>/ writes, routed to the affected
# server's own tag): when a committed \xff/keyServers/ change removes a
# tag from a shard's team, the commit proxy appends
#   SetValue(DISOWN_SHARD_PREFIX + <begin>, <end>)
# to that tag's messages AT THE MOVE'S COMMIT VERSION.  The storage
# server applies it in-stream: it cannot pass the move's version without
# learning that it no longer owns [begin, end), so a server that was
# unreachable while data distribution moved its shards never serves a
# read at a version where the writes stopped reaching it.  The
# RemoveShardRequest that data distribution sends a reachable member
# drops the rows; this mutation is the fence.  The prefix sorts below
# every stored key of the system range (\xff\x02 < \xff/) and is consumed,
# never stored.
DISOWN_SHARD_PREFIX = b"\xff\x02/disownShard/"


def disowned_spans(key_servers: RangeMap, m: Mutation):
    """The tags that lose a span if `m` (a committed \\xff/keyServers/
    mutation) is applied to `key_servers`, computed on the map before it
    is: [(tag, begin, end)], one for each old span a tag leaves.  Empty
    for any other mutation, for a split and for a team that only grows."""
    out = []
    if m.type == MutationType.SetValue and \
            m.param1.startswith(KEY_SERVERS_PREFIX):
        boundary = m.param1[len(KEY_SERVERS_PREFIX):]
        new_team = set(decode_key_servers_value(m.param2))
        _b, e, _v = key_servers.range_containing(boundary)
        for b0, e0, team in key_servers.intersecting(boundary, e):
            for t in team or ():
                if t not in new_team:
                    out.append((t, b0, e0))
    elif m.type == MutationType.ClearRange and \
            m.param2 > KEY_SERVERS_PREFIX and m.param1 < KEY_SERVERS_END:
        # A boundary removed: the span joins the PRECEDING shard's team,
        # and what the absorbed span's teams had beyond it is disowned
        # (as apply_key_servers_mutation merges).
        lo = max(m.param1, KEY_SERVERS_PREFIX)[len(KEY_SERVERS_PREFIX):]
        hi_raw = min(m.param2, KEY_SERVERS_END)
        hi = (hi_raw[len(KEY_SERVERS_PREFIX):]
              if hi_raw.startswith(KEY_SERVERS_PREFIX) else SYSTEM_KEYS_END)
        prev_team = None
        for b, _e, v in key_servers.ranges():
            if b < lo:
                prev_team = v
            else:
                break
        keep = set(prev_team or ())
        rb, re_, _v = key_servers.range_containing(hi)
        until = hi if rb == hi else re_
        if until > lo:
            for b0, e0, team in key_servers.intersecting(lo, until):
                for t in team or ():
                    if t not in keep:
                        out.append((t, b0, e0))
    return out


def apply_key_servers_mutation(key_servers: RangeMap, m: Mutation) -> bool:
    """Apply one committed `\\xff/keyServers/` mutation to a shard map.

    SetValue at keyServersKey(k): the shard starting at k (up to the next
    existing boundary) is owned by the decoded team -- a set at an interior
    key splits the containing shard.  ClearRange removes boundaries in the
    range: the affected span merges into the preceding shard's team.
    Returns True if the mutation was a keyServers mutation."""
    if m.type == MutationType.SetValue:
        if not m.param1.startswith(KEY_SERVERS_PREFIX):
            return False
        boundary = m.param1[len(KEY_SERVERS_PREFIX):]
        team = decode_key_servers_value(m.param2)
        # The new boundary owns up to the END of the shard containing it
        # (a set at an interior key splits that shard).
        _b, e, _v = key_servers.range_containing(boundary)
        key_servers.set_range(boundary, e, team)
        return True
    if m.type == MutationType.ClearRange:
        if m.param2 <= KEY_SERVERS_PREFIX or m.param1 >= KEY_SERVERS_END:
            return False
        lo = max(m.param1, KEY_SERVERS_PREFIX)[len(KEY_SERVERS_PREFIX):]
        hi_raw = min(m.param2, KEY_SERVERS_END)
        hi = (hi_raw[len(KEY_SERVERS_PREFIX):]
              if hi_raw.startswith(KEY_SERVERS_PREFIX) else SYSTEM_KEYS_END)
        # Team owning the point just below `lo` absorbs the cleared span,
        # which extends to the next surviving boundary at/after `hi`.
        prev_team = None
        for b, _e, v in key_servers.ranges():
            if b < lo:
                prev_team = v
            else:
                break
        rb, re_, _v = key_servers.range_containing(hi)
        until = hi if rb == hi else re_
        if prev_team is not None and until > lo:
            key_servers.set_range(lo, until, prev_team)
        return True
    return False
