"""Device-resident conflict window state (sorted segment arrays).

The reference skip list (fdbserver/SkipList.cpp) maintains a piecewise-
constant function V(key) = version of the last write covering key.  Here,
as in foundationdb_tpu/conflict/window.py, that function is a pair of
capacity-padded arrays on the device:

    bk: int32[CAP, 8]  sorted boundary digests as rows (ops/digest.py;
                       padding = MAX_DIGEST rows)
    bv: int32[CAP]     version of segment [bk[i], bk[i+1]) (pad NEG_INF)
    size: int32[1]     live boundary count

Versions are int32 offsets from a host-held base.  Only the state type and
its constructor live here; the window kernels (query / insert / gc) belong
to the general interval path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.digest import max_rows
from ..ops.rangemax import NEG_INF


class WindowState(NamedTuple):
    bk: torch.Tensor    # int32[CAP, 8]
    bv: torch.Tensor    # int32[CAP]
    size: torch.Tensor  # int32[1]


def make_window_state(cap: int, init_version_rel: int = 0,
                      device="cpu") -> WindowState:
    """One segment covering all keys (digest(b"") = all zeros) at
    init_version_rel; everything past it MAX / NEG_INF."""
    assert cap & (cap - 1) == 0, "capacity must be a power of two"
    bk = max_rows(cap, device)
    bk[0] = 0
    bv = torch.full((cap,), NEG_INF, dtype=torch.int32, device=device)
    bv[0] = init_version_rel
    return WindowState(bk, bv, torch.ones((1,), dtype=torch.int32,
                                          device=device))
