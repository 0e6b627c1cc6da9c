"""The coordinators change on the port (foundationdb_tpu_torch/server/
coordination.py move_coordinated_state, master.py _coordinators_watch,
client/management.py change_coordinators) against the JAX package's
tests/test_coordinators_change.py.

Its two cases run on the port's SimFdbCluster with device="cpu": a live
change to three new coordinators, after which every old coordinator
answers with the forward, acknowledged writes read back, and the cluster
recovers on the new quorum alone once the old coordinators and the
master's process are killed; and a change to addresses with no
coordinator behind them is refused.  The forward marker's bytes equal
the reference's pack_forward, and each package unpacks the other's.
Integer and byte values: tolerance 0.
"""

import numpy as np
import pytest

from foundationdb_tpu.server import coordination as ref_coord
from foundationdb_tpu_torch.client.management import (change_coordinators,
                                                      get_coordinators)
from foundationdb_tpu_torch.core.error import FdbError
from foundationdb_tpu_torch.core.scheduler import delay
from foundationdb_tpu_torch.server import coordination as port_coord

from test_torch_master_recovery import (commit_kv, make_cluster,  # noqa: F401
                                        read_key, teardown)


def test_forward_marker_bytes_equal_the_reference():
    """pack_forward's bytes equal the reference's over seeded specs, and
    each package's unpack_forward reads the other's marker (and nothing
    else)."""
    rng = np.random.default_rng(26)
    for _ in range(64):
        n = int(rng.integers(1, 6))
        spec = ",".join(
            f"{rng.integers(1, 255)}.{rng.integers(0, 255)}."
            f"{rng.integers(0, 255)}.{rng.integers(1, 255)}:"
            f"{rng.integers(1, 65535)}" for _ in range(n))
        packed = port_coord.pack_forward(spec)
        assert packed == ref_coord.pack_forward(spec)
        assert port_coord.unpack_forward(ref_coord.pack_forward(spec)) \
            == spec
        assert ref_coord.unpack_forward(packed) == spec
        assert port_coord.normalize_spec(spec) == \
            ref_coord.normalize_spec(spec)
    for other in (None, b"", b"\xffMOVED", b"dbcore", bytearray(b"x" * 9)):
        assert port_coord.unpack_forward(other) is None
        assert ref_coord.unpack_forward(other) is None


def test_change_quorum_live_then_kill_old_coordinators(teardown):  # noqa: F811
    c = make_cluster()
    db = c.database()
    model = {}

    async def load():
        for i in range(10):
            await commit_kv(db, b"pre%03d" % i, b"v%03d" % i, model)

    c.run_until(c.loop.spawn(load()), timeout=120)

    old = list(c.coordinators)
    for i in range(3):
        c.add_coordinator(name=f"newcoord{i}")
    new = c.coordinators[len(old):]
    new_spec = c.spec_of(new)

    async def change():
        await change_coordinators(db, new_spec)
        assert await get_coordinators(db) == new_spec

    c.run_until(c.loop.spawn(change()), timeout=60)

    # The master notices the committed spec within its poll interval,
    # moves the state and ends the epoch; the old coordinators forward.
    async def wait_moved():
        for _ in range(120):
            if all(s._forward_spec() == new_spec for _, s in old):
                return
            await delay(0.5)
        raise AssertionError("old coordinators never forwarded")

    c.run_until(c.loop.spawn(wait_moved()), timeout=120)

    async def after_move():
        assert await read_key(db, b"pre000") == b"v000"
        await commit_kv(db, b"post-move", b"yes", model)
        assert await read_key(db, b"post-move") == b"yes"

    c.run_until(c.loop.spawn(after_move()), timeout=120)
    # Every process follows the forward: the shared list names the new
    # quorum.
    assert port_coord.normalize_spec(",".join(
        f"{x.reg_read.address.ip}:{x.reg_read.address.port}"
        for x in c.coordinator_clients)) == new_spec

    # Kill every old coordinator and the master's process: the next
    # recovery elects and recovers on the new quorum alone.
    for p, _ in old:
        c.sim.kill_process(p)
    cc = c.current_cc()
    mp = c.process_of(cc.db_info.master) if cc is not None else None
    if mp is not None:
        c.sim.kill_process(mp)

    async def after_kill():
        await commit_kv(db, b"post-kill", b"yes", model)
        for k, v in sorted(model.items()):
            assert await read_key(db, k) == v, k

    c.run_until(c.loop.spawn(after_kill()), timeout=240)
    assert all(not p.alive for p, _ in old)


def test_change_quorum_rejects_unreachable_target(teardown):  # noqa: F811
    c = make_cluster(n_workers=4, n_storage_workers=2)
    db = c.database()

    c.run_until(c.loop.spawn(commit_kv(db, b"k", b"v")), timeout=120)

    async def bad_change():
        try:
            # No coordination server at these addresses: the probe fails
            # rather than commit a spec that would strand the next move.
            await change_coordinators(db, "10.99.0.1:4500,10.99.0.2:4500")
        except FdbError:
            return True
        return False

    f = c.loop.spawn(bad_change())
    c.run_until(f, timeout=90)
    assert f.get() is True
    assert c.run_until(c.loop.spawn(get_coordinators(db)),
                       timeout=60) == ""


def test_change_quorum_refuses_shared_members(teardown):  # noqa: F811
    """A target that shares a member with the running quorum is refused
    before anything is committed (one register cannot hold both the
    seeded state and the forward)."""
    c = make_cluster(n_workers=4, n_storage_workers=2)
    db = c.database()
    c.run_until(c.loop.spawn(commit_kv(db, b"k", b"v")), timeout=120)
    c.add_coordinator(name="extra0")
    spec = c.spec_of([c.coordinators[0], c.coordinators[-1]])

    async def shared():
        with pytest.raises(FdbError) as ei:
            await change_coordinators(db, spec)
        assert ei.value.name == "client_invalid_operation"
        return await get_coordinators(db)

    assert c.run_until(c.loop.spawn(shared()), timeout=60) == ""
