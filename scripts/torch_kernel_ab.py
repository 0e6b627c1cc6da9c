#!/usr/bin/env python3
"""Time the port's build_sparse_table and sort_rows of one checkout on one
NVIDIA GPU, at the shapes the conflict path hands them.

  python3 scripts/torch_kernel_ab.py [--root DIR] [--label NAME] [--profile]

DIR (default: the checkout holding this script) is the checkout whose
foundationdb_tpu_torch package is timed; its kernels are built from its own
csrc/ into its own build/.  The inputs, the checks and the timing are this
checkout's chip_smoke.py: table_sizes (2^18, 2^20, 2^21) and sort_inputs
((a) the config-3 universe of one batch, (b) random 32-byte digests, (c)
rows sharing an 8-byte prefix, and the window path's endpoint sort).  So
two commits are compared on one card by running this once per checkout in
one session, in turns (parent, change, change, parent).  Prints one JSON
line: each case's launches a call, own device time, plain time, bound and
equality with the plain version (any difference fails the run).  With
--profile it adds, under "profile", each kernel's mean device time and
launches per call by torch.profiler, for the table at 2^21 and for each
sort input, and the time of a copy_ of the universe's rows (the bytes of
one sort pass: a floor for a pass).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    S = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(S)
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
    assert K.CSRC.startswith(root), K.CSRC
    K.build()
    tables = S.table_sizes()
    _, enc, _ = S.make_stream3(np.random.default_rng(17), 1)[0]
    packed = TorchConflictSet._pack(enc)
    _, r_cap, w_cap = packed["caps"]
    n_rows = 2 * (r_cap + w_cap)
    universe = torch.from_numpy(
        packed["buf"][:32 * n_rows].view(np.int32).reshape(n_rows, 8)
        .copy()).to(S.DEVICE)
    sorts = S.sort_inputs(universe, r_cap, w_cap, enc.w_txn.shape[0])
    out = {"label": args.label, "root": os.path.relpath(root, HERE),
           "build_sparse_table": tables, "sort_rows": sorts}
    if args.profile:
        out["profile"] = profile(S, universe, r_cap, w_cap,
                                 enc.w_txn.shape[0])
    out["gpu"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


def profile(S, universe, r_cap: int, w_cap: int, n_writes: int,
            calls: int = 5) -> dict:
    """Per-kernel device time (mean microseconds a launch) and launches a
    call, by torch.profiler over `calls` calls of each case."""
    import torch
    from torch.profiler import ProfilerActivity
    from foundationdb_tpu_torch.ops.rangemax import build_sparse_table
    from foundationdb_tpu_torch.ops.sort import sort_rows
    g = torch.Generator(device=S.DEVICE).manual_seed(5)
    v = torch.randint(-(1 << 31), (1 << 31) - 1, (1 << 21,),
                      dtype=torch.int32, device=S.DEVICE, generator=g)
    cases = {"table_2^21": lambda: build_sparse_table(v)}
    for what, (rows, tie, pay) in S.sort_cases(universe, r_cap, w_cap,
                                                n_writes).items():
        cases[f"sort_{what}"] = (lambda rows=rows, tie=tie, pay=pay:
                                 sort_rows(rows, tie=tie, payload=pay))
    result = {}
    for name, fn in cases.items():
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = {}
        for e in p.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0 and e.key.split("(")[0].split()[-1].startswith("k_"):
                kernels[e.key.split("(")[0].split()[-1]] = {
                    "us_per_launch": us / e.count,
                    "launches_per_call": e.count / calls}
        result[name] = kernels
    dst = torch.empty_like(universe)
    result["copy_universe_ms"] = S.device_ms(lambda: dst.copy_(universe),
                                             reps=20)
    return result


if __name__ == "__main__":
    sys.exit(main())
