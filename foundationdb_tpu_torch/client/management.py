"""The management API: an operator's actions as ordinary transactions
(a trimmed copy of foundationdb_tpu/client/management.py).

Reference: fdbclient/ManagementAPI.actor.cpp -- excludeServers and
includeServers write the exclusion list under `\\xff/conf/excluded/`, and
the data distributor drains the excluded servers; changeConfig writes the
configuration's fields under `\\xff/conf/`, and the master ends the epoch
so that recovery recruits the new shape.  Each call is one serializable
transaction through the client: the operator has no private channel
into the cluster, so a change survives what the database survives.

Kept: _retrying, exclude_servers, include_servers, excluded_servers,
change_configuration, get_configuration, change_coordinators (:136) and
get_coordinators (:175).  Left out: lock_database and
unlock_database (the port's proxies keep no lock), set_knob and
get_knob_overrides (the knobs as data), and cache_range and
uncache_range (the storage caches).

Usage, on a SimFdbCluster's loop (server/cluster.py):
    db = cluster.database()
    await change_configuration(db, n_resolvers=3)
    await exclude_servers(db, [2])
    await include_servers(db, [2])
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from ..core.error import FdbError, err
from ..server.system_data import (CONF_END, CONF_PREFIX, COORDINATORS_KEY,
                                  EXCLUDED_END,
                                  EXCLUDED_PREFIX, conf_key, excluded_key)


async def _retrying(db, fn):
    """fn(transaction) in a system-key transaction, committed, retried
    through on_error; fn's result."""
    t = db.create_transaction()
    t.access_system_keys = True
    while True:
        try:
            r = await fn(t)
            await t.commit()
            return r
        except FdbError as e:
            await t.on_error(e)


async def exclude_servers(db, tags: Iterable[int]) -> None:
    """Exclude storage servers by tag: data distribution drains every
    shard off them, and they stop being placement candidates at once
    (reference excludeServers)."""
    async def go(t):
        for tag in tags:
            t.set(excluded_key(tag), b"1")
    await _retrying(db, go)


async def include_servers(db, tags: Optional[Iterable[int]] = None) -> None:
    """Admit excluded servers again (None: every one; reference
    includeServers)."""
    async def go(t):
        if tags is None:
            t.clear(EXCLUDED_PREFIX, EXCLUDED_END)
        else:
            for tag in tags:
                t.clear(excluded_key(tag))
    await _retrying(db, go)


async def excluded_servers(db) -> List[int]:
    """The excluded tags, as committed."""
    t = db.create_transaction()
    t.access_system_keys = True
    while True:
        try:
            rows = await t.get_range(EXCLUDED_PREFIX, EXCLUDED_END)
            return [int(k[len(EXCLUDED_PREFIX):]) for k, v in rows
                    if v == b"1"]
        except FdbError as e:
            await t.on_error(e)


async def change_configuration(db, **fields) -> None:
    """Change the database configuration in one transaction (reference
    `fdbcli configure`, changeConfig): each field's printed value under
    \\xff/conf/, None clearing it back to the default.  The commit's
    proxy nudges the master, which ends the epoch where a value differs
    from the recruited one; the next recovery recruits the new shape."""
    async def go(t):
        for name, value in fields.items():
            if value is None:
                t.clear(conf_key(name))
            else:
                t.set(conf_key(name), str(value).encode())
    await _retrying(db, go)


async def get_configuration(db) -> dict:
    """The committed \\xff/conf/ fields, {name: printed value} (an absent
    field is at its static default); the exclusion list is not among
    them."""
    async def go(t):
        rows = await t.get_range(CONF_PREFIX, CONF_END)
        return {k[len(CONF_PREFIX):].decode(): v for k, v in rows
                if not k.startswith(EXCLUDED_PREFIX)}
    return await _retrying(db, go)


async def change_coordinators(db, new_spec: str) -> None:
    """changeQuorum (reference ManagementAPI changeQuorumChecker): check
    that the target quorum answers a coordinated read, then commit the
    new connection spec to \\xff/coordinators.  The master seeds the new
    quorum, forwards the old one and ends its epoch; workers and clients
    follow the forward replies (server/coordination.py
    move_coordinated_state)."""
    from ..server.coordination import (CoordinatedState, normalize_spec,
                                       parse_spec)
    new_spec = normalize_spec(new_spec)   # the committed form is canonical
    coords = parse_spec(new_spec)
    if not coords:
        raise err("client_invalid_operation", "empty coordinator spec")
    cur_coords = getattr(db.cluster, "coordinators", None) or []
    cur_addrs = {(c.reg_read.address.ip, c.reg_read.address.port)
                 for c in cur_coords
                 if getattr(c.reg_read, "address", None) is not None}
    new_addrs = {(c.reg_read.address.ip, c.reg_read.address.port)
                 for c in coords}
    if cur_addrs & new_addrs:
        raise err("client_invalid_operation",
                  "new quorum must not share members with the current one "
                  "(change in two disjoint steps)")
    probe = CoordinatedState(coords)
    try:
        await probe.read()
    except FdbError as e:
        if e.name == "coordinators_changed":
            raise err("client_invalid_operation",
                      f"target quorum {new_spec} is itself forwarded")
        raise

    async def go(t):
        t.set(COORDINATORS_KEY, new_spec.encode())
    await _retrying(db, go)


async def get_coordinators(db) -> str:
    """The committed coordinator spec ("" before any change)."""
    async def go(t):
        raw = await t.get(COORDINATORS_KEY)
        return raw.decode() if raw else ""
    return await _retrying(db, go)
