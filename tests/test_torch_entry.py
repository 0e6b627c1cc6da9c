"""The port's entry points held against __graft_entry__.py's.

entry(): the port's window_query and its arguments at the reference's
shapes (a 2^12 window, 256 queries of 16-byte keys, seed 0) give the
conflict bits the reference's window_query gives on its own arguments,
at snapshot 0 and at snapshot -1 (where every query conflicts); the
port's arguments are the reference's digests as rows.  dryrun_multichip():
the port's sharded set over mesh rows of "cpu" agrees with the oracle
batch for batch.  Integer data, tolerance 0.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from foundationdb_tpu_torch import entry as port_entry
from foundationdb_tpu_torch.ops.digest import rows_to_planar


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU route is many small tensor operations, which a
    thread pool only slows down on a shared CPU while it takes cores from
    whatever else runs: one intra-op thread, restored after the test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("snap_shift", [0, -1])
def test_entry_matches_reference(snap_shift):
    ref_fn, ref_args = graft.entry()
    fn, args = port_entry.entry("cpu")
    assert all(a.device.type == "cpu" for a in args)
    bk, bv, qb, qe, snap, valid = args
    assert tuple(qb.shape) == (port_entry.N_QUERIES, 8)
    assert bk.shape[0] == bv.shape[0] == port_entry.CAPACITY
    assert np.array_equal(rows_to_planar(qb), np.asarray(ref_args[2]))
    assert np.array_equal(rows_to_planar(qe), np.asarray(ref_args[3]))
    ref_args = ref_args[:4] + (ref_args[4] + snap_shift,) + ref_args[5:]
    want = np.asarray(ref_fn(*ref_args)).astype(np.int32)
    got = fn(bk, bv, qb, qe, snap + snap_shift, valid).numpy()
    assert np.array_equal(got, want)
    assert int(got.sum()) == (port_entry.N_QUERIES if snap_shift else 0)


def test_entry_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.dryrun_multichip(2)


@pytest.mark.parametrize("n_devices", [8, 4, 1])
def test_dryrun_multichip_on_cpu_rows(n_devices):
    port_entry.dryrun_multichip(n_devices, "cpu")
