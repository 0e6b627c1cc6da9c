"""Configuration as data in the port (foundationdb_tpu_torch/server/
system_data.py conf_key and parse_conf_mutation, interfaces.py
DatabaseConfiguration.with_conf, the commit proxy's nudge, the master's
replay, effective configuration, watch and poll, and client/
management.py) against the JAX package, on the CPU.

  * The reference's tests/test_config_data.py case on the port's
    SimFdbCluster(device="cpu"): a configure is one transaction, the
    epoch ends and recovery recruits the new shape, which survives a
    whole-cluster power failure and can be changed again.  The two
    packages' simulations draw their randomness differently, so the
    runs are held to a dict model of every acknowledged write (tolerance
    0), and the core state the coordinators hold is unpacked by the
    reference's DBCoreState to the same conf.
  * A retried, identical configure, a field the port does not keep and
    a configure while the nudge is lost (the poll heals it): dict
    models.
  * parse_conf_mutation and with_conf on seeded mutations (sets, point
    and broad clears, the exclusion list, unknown fields and values that
    do not parse), get_configuration and the management writes on the
    same rows, and the packed DBCoreState with a filled conf: equal to
    the reference's, byte for byte.
"""

import os
import random
import sys

import pytest

from foundationdb_tpu.client import management as ref_mgmt
from foundationdb_tpu.server import interfaces as ref_if
from foundationdb_tpu.server import master as ref_master
from foundationdb_tpu.server import system_data as ref_sd
from foundationdb_tpu.txn import types as rt
from foundationdb_tpu_torch.client import management as port_mgmt
from foundationdb_tpu_torch.client.management import (change_configuration,
                                                      get_configuration)
from foundationdb_tpu_torch.core.scheduler import delay
from foundationdb_tpu_torch.server import interfaces as port_if
from foundationdb_tpu_torch.server import master as port_master
from foundationdb_tpu_torch.server import system_data as port_sd
from foundationdb_tpu_torch.server.coordination import CoordinatedState
from foundationdb_tpu_torch.txn import types as pt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_master_recovery import (check_replicas,  # noqa: E402
                                        commit_kv, make_cluster, read_key,
                                        teardown)  # noqa: F401


async def wait_recovered(c, want_resolvers, want_proxies, deadline=60.0):
    while deadline > 0:
        cc = c.current_cc()
        if cc is not None and cc.db_info.recovery_state in (
                "accepting_commits", "fully_recovered"):
            info = cc.db_info
            if len(info.resolvers) == want_resolvers and \
                    len(info.commit_proxies) == want_proxies:
                return True
        await delay(0.5)
        deadline -= 0.5
    return False


async def core_state_conf(c) -> dict:
    """The serving epoch's core state, packed as the coordinators keep
    it across a reboot, unpacked by the reference's DBCoreState."""
    cs = port_master.DBCoreState.coerce(await CoordinatedState(
        c.coordinator_clients).read())
    assert cs.epoch == c.current_cc().db_info.epoch
    return ref_master.DBCoreState.unpack(cs.pack()).conf


def test_config_change_is_transactional_and_survives_power_fail(teardown):  # noqa: F811,E501
    """The reference's case (dict model): the role counts change in one
    transaction, recovery recruits them, a power failure keeps them, and
    a later configure changes them back."""
    c = make_cluster(n_workers=6, n_storage_workers=2)
    db = c.database()
    model = {}

    async def phase1():
        for i in range(10):
            await commit_kv(db, b"c%02d" % i, b"v%02d" % i, model)
        epoch = c.current_cc().db_info.epoch
        await change_configuration(db, n_resolvers=2, n_commit_proxies=2)
        assert (await get_configuration(db))["n_resolvers"] == b"2"
        assert await wait_recovered(c, 2, 2), "new counts never recruited"
        assert c.current_cc().db_info.epoch == epoch + 1
        assert await read_key(db, b"c05") == b"v05"
        await commit_kv(db, b"after-change", b"yes", model)
        assert await core_state_conf(c) == {"n_resolvers": b"2",
                                            "n_commit_proxies": b"2"}
        await check_replicas(c, db, model)

    c.run_until(c.loop.spawn(phase1()), timeout=120)
    c.power_fail_reboot()
    db2 = c.database()

    async def phase2():
        assert await wait_recovered(c, 2, 2, deadline=90.0), \
            "config lost across power failure"
        await check_replicas(c, db2, model)
        assert (await get_configuration(db2))["n_commit_proxies"] == b"2"
        await change_configuration(db2, n_resolvers=1)
        assert await wait_recovered(c, 1, 2), "change-back never adopted"
        await commit_kv(db2, b"changed-back", b"1", model)
        await check_replicas(c, db2, model)
        assert await core_state_conf(c) == {"n_resolvers": b"1",
                                            "n_commit_proxies": b"2"}

    c.run_until(c.loop.spawn(phase2()), timeout=180)


def test_identical_configure_keeps_the_epoch(teardown):  # noqa: F811
    """Dict model: a configure equal to the recruited configuration (a
    retry after commit_unknown_result), one of a field the port does not
    keep and one whose value does not parse (recruitment keeps its own)
    end no epoch, across the poll's period; clearing a field the epoch
    took from the database goes back to the static configuration."""
    c = make_cluster(n_workers=6, n_storage_workers=2)
    db = c.database()
    model = {}

    async def go():
        await commit_kv(db, b"a", b"1", model)
        await change_configuration(db, n_resolvers=2)
        assert await wait_recovered(c, 2, 1)
        epoch = c.current_cc().db_info.epoch
        await change_configuration(db, n_resolvers=2)
        await change_configuration(db, usable_regions=2, n_resolvers=2)
        await change_configuration(db, n_resolvers="x7")
        await commit_kv(db, b"b", b"2", model)
        await delay(12.0)        # two periods of the poll
        assert c.current_cc().db_info.epoch == epoch
        await change_configuration(db, n_resolvers=None)
        assert await wait_recovered(c, 1, 1)
        assert c.current_cc().db_info.epoch == epoch + 1
        await delay(12.0)
        assert c.current_cc().db_info.epoch == epoch + 1
        await commit_kv(db, b"c", b"3", model)
        await check_replicas(c, db, model)

    c.run_until(c.loop.spawn(go()), timeout=300)


def test_lost_nudge_is_healed_by_the_poll(teardown, monkeypatch):  # noqa: F811,E501
    """Dict model: with the master's watch of the proxies' nudges
    disabled, the poll alone ends the epoch within its 5 s period and
    recovery recruits the committed shape."""
    async def deaf(master, config, static):
        await delay(1e9)
    monkeypatch.setattr(port_master, "_config_change_watch", deaf)
    c = make_cluster(n_workers=6, n_storage_workers=2)
    db = c.database()
    model = {}

    async def go():
        await commit_kv(db, b"a", b"1", model)
        epoch = c.current_cc().db_info.epoch
        t0 = c.loop.now()
        await change_configuration(db, n_resolvers=2)
        assert await wait_recovered(c, 2, 1)
        assert c.current_cc().db_info.epoch == epoch + 1
        assert c.loop.now() - t0 <= 5.0 + 5.0
        await commit_kv(db, b"b", b"2", model)
        await check_replicas(c, db, model)

    c.run_until(c.loop.spawn(go()), timeout=120)


CONF_FIELDS = ("n_tlogs", "n_commit_proxies", "n_grv_proxies", "n_resolvers",
               "n_storage", "log_replication", "storage_replication",
               "conflict_backend", "storage_engine", "min_workers",
               "usable_regions", "remote_dc", "tss_count", "no_such_field")


def conf_mutations(rng, n: int):
    """Seeded (type, param1, param2) mutations over \\xff/conf/ and around
    it: field sets (values that parse and values that do not), point
    clears, broad clears, exclusion-list writes and clears, and keys
    outside the configuration."""
    out = []
    for _ in range(n):
        r = rng.random()
        f = rng.choice(CONF_FIELDS).encode()
        if r < 0.4:
            v = rng.choice([b"%d" % rng.randrange(1, 5), b"btree", b"memory",
                            b"", b"x7"])
            out.append((0, b"\xff/conf/" + f, v))
        elif r < 0.55:
            k = b"\xff/conf/" + f
            out.append((1, k, k + b"\x00"))
        elif r < 0.65:
            a, b = sorted(rng.sample([b"\xff/conf/", b"\xff/conf/n",
                                      b"\xff/conf/z", b"\xff/conf0",
                                      b"\xff/conf/excluded/",
                                      b"\xff/conf/excluded0", b"\xff/b",
                                      b"\xff/d"], 2))
            out.append((1, a, b))
        elif r < 0.8:
            k = b"\xff/conf/excluded/%010d" % rng.randrange(5)
            out.append(rng.choice([(0, k, b"1"), (1, k, k + b"\x00")]))
        else:
            out.append((0, rng.choice([b"\xff/keyServers/a", b"user/k",
                                       b"\xff/confx"]), b"v"))
    return out


@pytest.mark.parametrize("seed", [41, 42, 43])
def test_parse_conf_and_with_conf_match_reference(seed):
    """Tolerance 0: parse_conf_mutation's fields and values, the conf the
    master's replay builds from them ("*" clears it, None pops a field),
    and with_conf's configuration over every field the port keeps, equal
    the reference's."""
    rng = random.Random(seed)
    muts = conf_mutations(rng, 300)
    ref_conf, port_conf = {}, {}
    port_fields = [f for f in port_if.DatabaseConfiguration.__dataclass_fields__
                   if f != "storage_boundaries"]
    for i, (op, a, b) in enumerate(muts):
        rm = rt.Mutation(rt.MutationType(op), a, b)
        pm = pt.Mutation(pt.MutationType(op), a, b)
        got, want = port_sd.parse_conf_mutation(pm), \
            ref_sd.parse_conf_mutation(rm)
        assert got == want, (a, b)
        for conf, parsed in ((ref_conf, want), (port_conf, got)):
            for fname, raw in parsed or ():
                if fname == "*":
                    conf.clear()
                elif raw is None:
                    conf.pop(fname, None)
                else:
                    conf[fname] = raw
        assert port_conf == ref_conf
        if i % 10 == 0:
            base = dict(n_resolvers=rng.randrange(1, 4),
                        storage_engine=rng.choice(["memory", "btree"]))
            pc = port_if.DatabaseConfiguration(**base).with_conf(port_conf)
            rc = ref_if.DatabaseConfiguration(**base).with_conf(ref_conf)
            for f in port_fields:
                assert getattr(pc, f) == getattr(rc, f), f
    assert port_sd.conf_key("n_resolvers") == ref_sd.conf_key("n_resolvers")
    for name in ("CONF_PREFIX", "CONF_END", "EXCLUDED_PREFIX",
                 "EXCLUDED_END", "MAX_TAG_KEY", "STORAGE_WIGGLE_POS_KEY"):
        assert getattr(port_sd, name) == getattr(ref_sd, name), name
    assert set(port_if.DatabaseConfiguration._INT_FIELDS) <= \
        set(ref_if.DatabaseConfiguration._INT_FIELDS)
    assert set(port_if.DatabaseConfiguration._STR_FIELDS) == \
        set(ref_if.DatabaseConfiguration._STR_FIELDS) - {"remote_dc"}


class _Txn:
    """A transaction that records writes and answers get_range from a
    sorted dict, for both packages' management calls."""

    def __init__(self, rows, log):
        self.rows, self.log = rows, log
        self.access_system_keys = False

    async def get_range(self, begin, end, limit=1000):
        return [(k, v) for k, v in sorted(self.rows.items())
                if begin <= k < end][:limit]

    def set(self, k, v):
        self.log.append(("set", k, v))

    def clear(self, k, end=None):
        self.log.append(("clear", k, end))

    async def commit(self):
        self.log.append(("commit", self.access_system_keys))


class _Db:
    def __init__(self, rows):
        self.rows, self.log = rows, []

    def create_transaction(self):
        return _Txn(self.rows, self.log)


def run_coro(coro):
    try:
        coro.send(None)
    except StopIteration as e:
        return e.value
    raise AssertionError("the call suspended")


@pytest.mark.parametrize("seed", [51, 52])
def test_management_calls_match_reference(seed):
    """Tolerance 0: on the same committed rows, get_configuration and
    excluded_servers answer what the reference's do, and
    change_configuration, exclude_servers and include_servers write the
    same keys and values in the same order."""
    rng = random.Random(seed)
    rows = {}
    for _ in range(30):
        f = rng.choice(CONF_FIELDS).encode()
        rows[b"\xff/conf/" + f] = b"%d" % rng.randrange(9)
        rows[b"\xff/conf/excluded/%010d" % rng.randrange(20)] = \
            rng.choice([b"1", b"0"])
    rows[b"\xff/conf0"] = b"outside"
    rows[b"\xff/conf/excluded0"] = b"1"
    for name, args, kwargs in (
            ("get_configuration", (), {}),
            ("excluded_servers", (), {}),
            ("change_configuration", (),
             dict(n_resolvers=3, storage_engine="btree",
                  n_commit_proxies=None)),
            ("exclude_servers", ([rng.randrange(20) for _ in range(3)],), {}),
            ("include_servers", ([rng.randrange(20)],), {}),
            ("include_servers", (), {})):
        dbs = [_Db(dict(rows)), _Db(dict(rows))]
        got = run_coro(getattr(port_mgmt, name)(dbs[0], *args, **kwargs))
        want = run_coro(getattr(ref_mgmt, name)(dbs[1], *args, **kwargs))
        assert got == want, name
        assert dbs[0].log == dbs[1].log, name


def test_packed_core_state_with_conf_matches_reference():
    """Tolerance 0: a DBCoreState with a filled conf packs to the
    reference's bytes, and each package unpacks the other's to the same
    fields."""
    rng = random.Random(61)
    for _ in range(20):
        conf = {rng.choice(CONF_FIELDS): b"%d" % rng.randrange(9)
                for _ in range(rng.randrange(0, 6))}
        kw = dict(epoch=rng.randrange(1, 9),
                  recovery_version=rng.randrange(1 << 40),
                  log_replication=rng.randrange(1, 3),
                  key_servers_ranges=[(b"", b"\x80", [0, 1]),
                                      (b"\x80", b"\xff\xff", [1, 2])],
                  n_resolvers=rng.randrange(1, 4),
                  map_version=rng.randrange(1 << 40),
                  tlog_ids=["log0.ab.e3", "log1.ab.e3"],
                  storage_ids={0: "ss0", 1: "ss1", 2: "ss4"},
                  resolver_ranges=[(b"", b"\x80", 0), (b"\x80", b"\xff", 1)],
                  conf=conf)
        p = port_master.DBCoreState(**kw).pack()
        r = ref_master.DBCoreState(**kw).pack()
        assert p == r
        back = port_master.DBCoreState.unpack(r)
        assert back.conf == conf and back.storage_ids == kw["storage_ids"]
        assert ref_master.DBCoreState.unpack(p).conf == conf
