"""Build, bind and count the hand-written CUDA kernels (csrc/*.cu).

Each source in csrc/ is compiled by nvcc for sm_90a into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), all sources in parallel, at first use, into build/torch_kernels/
under the repository root (listed in .gitignore).  The libraries are
loaded with ctypes; every launcher takes device pointers, sizes and the
CUDA stream, allocates nothing, never synchronises and returns
cudaGetLastError(), which `launch` turns into an exception.

Launch counters: `LAUNCHES[name]` is a plain int per kernel wrapper (the
Python function in ops/ or conflict/fused.py that owns the kernel); the
wrapper bumps it by one for every kernel launch it makes, and nowhere
else.  A run resets them with `reset_counts()` and reads them after, to
show the path really went through the kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
SOURCES = ("digest_search", "sparse_table", "rank_scan", "intra_batch",
           "sort", "segtree", "window", "insert", "shard")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# Kernel wrappers on the conflict path (the names LAUNCHES is keyed by):
# name -> (CUDA source, the JAX device code it replaces).
_REF = "foundationdb_tpu/"
KERNELS = {
    "searchsorted": ("digest_search", _REF + "ops/digest.py:243"),
    "history_probe": ("digest_search", _REF + "conflict/fused.py:351"),
    "inclusive_scan": ("rank_scan", _REF + "conflict/window.py:233"),
    "compact_rows": ("rank_scan", _REF + "conflict/window.py:235"),
    "build_sparse_table": ("sparse_table", _REF + "ops/rangemax.py:20"),
    "compact_prep": ("intra_batch", _REF + "conflict/fused.py:300"),
    "read_write_prep": ("intra_batch", _REF + "conflict/fused.py:332"),
    # and, in the same launch, the codes (fused.py:388, batch_codes)
    "intra_batch_fixpoint": ("intra_batch", _REF + "conflict/fused.py:373"),
    "point_insert": ("insert", _REF + "conflict/fused.py:157"),
    "merge": ("rank_scan", _REF + "conflict/fused.py:607"),
    "sort_rows": ("sort", _REF + "conflict/fused.py:524"),
    "general_prep": ("intra_batch", _REF + "conflict/fused.py:479"),
    # and, in the same launch when given codes_out, the codes
    # (fused.py:550-566, general_codes)
    "interval_fixpoint": ("segtree", _REF + "conflict/fused.py:531"),
    "window_query": ("window", _REF + "conflict/window.py:66"),
    "union_ranges": ("window", _REF + "conflict/window.py:85"),
    "window_insert": ("insert", _REF + "conflict/window.py:127"),
    "window_gc": ("window", _REF + "conflict/window.py:219"),
    "clip_rows": ("shard", _REF + "parallel/sharded_window.py:166"),
    "shard_combine": ("shard", _REF + "conflict/fused.py:362"),
    "shard_commit": ("shard", _REF + "parallel/sharded_window.py:183"),
}
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

# C signatures: "p" pointer or stream, "i" int, "l" 64-bit int.  The last
# argument of every launcher is the stream; ib_unpack_layout launches
# nothing and takes none (see query).
_SIGS = {
    "digest_search": {
        "ds_search": "pipiip" "p",
        "ds_history": "pippipppi" "pp" "p",
    },
    "sparse_table": {"st_tile": "ppii" "p", "st_high": "pii" "p"},
    "rank_scan": {
        "rs_scan": "pplp" "p",
        "rs_compact": "lppppppl" "ii" "p",
        "mg_merge": "ppip" "ppip" "pp" "ii" "plp" "p",
    },
    "intra_batch": {
        "ib_unpack_layout": "iiii" "p",
        "ib_unpack": "iiiiii" "pppppp" "ppppp" "pl" "p",
        "ib_rw_prep": "iiii" "pppppppp" "ppppppp" "p",
        "ib_fixpoint": "iiii" "ppppppp" "ppppp" "pppp" "p",
        "ig_prep": "iii" "ppppppppp" "pppp" "p",
    },
    "sort": {"so_sort": "li" "pppppp" "p"},
    "segtree": {"sg_fixpoint": "iiii" "ppppppppp" "pl" "ppp" "ppppp" "p"},
    "window": {
        "wq_query": "pipppp" "plp" "p",
        "wu_endpoints": "l" "pppppp" "ppp" "l" "p",
        "wu_sweep": "l" "ppp" "l" "pp" "l" "p" "p",
        "wg_gc": "ppp" "iii" "pl" "p",
    },
    "insert": {
        "pi_mark": "lppi" "pp" "p",
        "ri_insert": "ppip" "ppi" "ppi" "pi" "pi" "pp" "plp" "p",
    },
    "shard": {
        "sh_clip": "l" "ppppp" "pppp" "p",
        "sh_combine": "pppppppp" "ill" "p" "p",
        "sh_commit": "pi" "ppp" "ppp" "p",
    },
}
_CTYPE = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_int64}

_lock = threading.Lock()
_fns: Dict[str, object] = {}
BUILD_SECONDS = None
# counter -> [(start, end) CUDA events], while timed_launches() is active.
_timed: Optional[Dict[str, List[tuple]]] = None


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def timed_launches():
    """Bracket every launch made inside the block by a pair of CUDA events
    on its stream, and yield {counter: [(start, end), ...]}.  The sum of
    a counter's elapsed times is the device time of that wrapper's own
    kernels, without the launches of the wrappers it calls; read it once
    the stream has finished.  For measurement only."""
    global _timed
    _timed = {}
    try:
        yield _timed
    finally:
        _timed = None


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    toolkit = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if path is None and os.path.exists(toolkit):
        path = toolkit
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _so_path(src: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{src}.so")


def _stale(src: str) -> bool:
    so = _so_path(src)
    if not os.path.exists(so):
        return True
    newest = max(os.path.getmtime(os.path.join(CSRC, f)) for f in
                 (f"{src}.cu", "common.cuh"))
    return os.path.getmtime(so) < newest


def build(force: bool = False) -> float:
    """Compile every stale csrc/*.cu (one nvcc per source, all started
    together) and load the libraries; returns the wall seconds spent."""
    global BUILD_SECONDS
    with _lock:
        if _fns and not force:
            return BUILD_SECONDS or 0.0
        t0 = time.perf_counter()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for src in SOURCES:
            if not (force or _stale(src)):
                continue
            tmp = _so_path(src) + f".{os.getpid()}.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, f"{src}.cu")]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
        errors = []
        for src, tmp, proc in procs:
            out, errb = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src}.cu:\n{errb.decode(errors='replace')}"
                              f"{out.decode(errors='replace')}")
            else:
                os.replace(tmp, _so_path(src))
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        fns = {}
        for src, sigs in _SIGS.items():
            lib = ctypes.CDLL(_so_path(src))
            for name, sig in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = [_CTYPE[c] for c in sig]
                fn.restype = ctypes.c_int
                fns[name] = fn
        _fns.update(fns)
        BUILD_SECONDS = time.perf_counter() - t0
        return BUILD_SECONDS


def use_kernel(t, impl) -> bool:
    """Which body a wrapper runs: the CUDA kernel for a CUDA tensor, the
    plain-torch version for a CPU tensor.  impl="plain" selects the plain
    version on the card (for comparing the two); there is no fallback."""
    if impl not in (None, "plain", "kernel"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "plain":
        return False
    if t.device.type == "cuda":
        return True
    if impl == "kernel":
        raise ValueError("impl='kernel' needs tensors on a CUDA device")
    return False


def query(fn_name: str, *args) -> None:
    """Call a function of the libraries that launches nothing (a layout a
    kernel owns, written into host memory); raise if it fails."""
    if not _fns:
        build()
    rc = _fns[fn_name](*[_arg(a) for a in args])
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: cudaError {rc}")


def _arg(a):
    if hasattr(a, "data_ptr"):
        return a.data_ptr()
    return a


def launch(counter: str, fn_name: str, *args, count: int = 1) -> None:
    """Call one launcher on the current CUDA stream of the first tensor
    argument's device; count its `count` kernel launches under `counter`
    (a launcher that enqueues several kernels is given how many by its
    wrapper); raise on a launch error.
    Every tensor handed to a kernel must be a contiguous int32 / int64 /
    int8 / uint8 tensor on that one CUDA device: the kernels index raw
    pointers."""
    import torch
    if not _fns:
        build()
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    dev = tensors[0].device
    for t in tensors:
        if (t.device != dev or dev.type != "cuda" or not t.is_contiguous()
                or t.dtype not in (torch.int32, torch.int64, torch.int8,
                                   torch.uint8)):
            raise ValueError(
                f"{fn_name}: kernel arguments must be contiguous int32/int64/"
                f"int8/uint8 tensors on one CUDA device, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    stream = torch.cuda.current_stream(dev)
    timed = _timed
    if timed is not None:
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
    rc = _fns[fn_name](*[_arg(a) for a in args], stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {fn_name} failed to launch: "
                           f"cudaError {rc}")
    if timed is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        timed.setdefault(counter, []).append((start, end))
    LAUNCHES[counter] += count
