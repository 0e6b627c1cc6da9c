"""System keyspace conventions and the shard map's metadata mutations
(trimmed copy of foundationdb_tpu/server/system_data.py, reference
fdbclient/SystemData.cpp and fdbserver/ApplyMetadataMutation.cpp:52-61).

What the resolution plane and the write path read: the first key of the
`\\xff` system range, which every resolver owns (RESOLVER_ALL) and whose
mutations make a transaction a state transaction; and the shard map under
`\\xff/keyServers/`, whose committed mutations every commit proxy applies
to its map of storage teams (apply_key_servers_mutation, the shard-map
part of ApplyMetadataMutation.cpp) and also logs on TXS_TAG.  Of the
reference's metadata (the server registry, exclusions, configuration,
backup, lock, tenants, the disownment fence) the port has only the shard
map.
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
