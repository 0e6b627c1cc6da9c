"""The tester: runs a test spec against the port's simulated cluster
through setup -> start -> quiescence -> check (a copy of
foundationdb_tpu/testing/tester.py).

Reference: fdbserver/tester.actor.cpp runTests (:1603) / runWorkload
(:755) -- reads a TOML spec (tests/specs/*.toml), instantiates registered
workloads, runs their phases (chaos workloads run concurrently with the
invariant workloads' start phase), waits for quiescence (QuietDatabase:
recovery settled, a probe commits), then runs every workload's check.

run_simulation runs one seeded spec on a fresh world (generator, run
digest, event loop and SimFdbCluster) and returns its SimRunReport, with
the unseed the double-run check compares; the Resolver roles' conflict
sets are built on `device` (the card unless the caller passes
device="cpu") with `set_kwargs` (capacity, delta_capacity, ...).  The
report carries the run's SlowTask events (core/profiler.py) for people
to read: none of them is folded into the digest.

Left out: effective_hash_seed and repro_hash_seed_prefix (the
cross-process repro commands of the reference's scripts/run_chaos.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

try:
    import tomllib                      # Python >= 3.11
except ImportError:                     # pragma: no cover - version-dependent
    tomllib = None                      # the subset parser below

from ..core.error import FdbError
from ..core.futures import wait_all
from ..core.scheduler import delay, spawn
from ..core.trace import Severity, TraceEvent
from . import workloads as _builtin  # noqa: F401 - populates the registry
from .workload import TestWorkload, workload_registry


def _parse_toml_subset(text: str) -> Dict[str, Any]:
    """Parser for the TOML subset the specs use: comments, [table] and
    [[array.of.tables]] headers with dotted paths, and scalar
    `key = value` pairs (quoted strings, ints, floats, booleans)."""

    def scalar(raw: str) -> Any:
        raw = raw.strip()
        if len(raw) >= 2 and raw[0] == raw[-1] and raw[0] in "'\"":
            return raw[1:-1]
        if raw in ("true", "false"):
            return raw == "true"
        try:
            return int(raw)
        except ValueError:
            return float(raw)           # raises on junk

    root: Dict[str, Any] = {}
    current = root
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("["):
            is_array = line.startswith("[[")
            close = line.find("]]" if is_array else "]")
            if close < 0:
                raise ValueError(f"unclosed table header line {lineno}: "
                                 f"{line!r}")
            path = line[2 if is_array else 1:close].strip().split(".")
            node: Any = root
            for part in path[:-1]:
                nxt = node.setdefault(part, {})
                if isinstance(nxt, list):   # descend into the latest entry
                    nxt = nxt[-1]
                node = nxt
            leaf = path[-1]
            if is_array:
                node.setdefault(leaf, []).append({})
                current = node[leaf][-1]
            else:
                current = node.setdefault(leaf, {})
        elif "=" in line:
            key, _, raw = line.partition("=")
            raw = raw.strip()
            if raw and raw[0] in "'\"":
                # A quoted string: what follows the closing quote (an
                # inline comment) is dropped.
                close = raw.find(raw[0], 1)
                if close < 0:
                    raise ValueError(f"unclosed string line {lineno}: "
                                     f"{line!r}")
                raw = raw[:close + 1]
            elif "#" in raw:
                raw = raw.split("#", 1)[0]
            current[key.strip()] = scalar(raw)
        else:
            raise ValueError(f"unparseable spec line {lineno}: {line!r}")
    return root


def load_spec(path_or_text: str) -> Dict[str, Any]:
    """Parse a TOML test spec, given as its text or its path:

        [[test]]
        testTitle = 'CycleTest'
          [[test.workload]]
          testName = 'Cycle'
          nodeCount = 16
    """
    if "\n" in path_or_text or "[" in path_or_text.split("\n")[0]:
        text = path_or_text
    else:
        with open(path_or_text, "rb") as f:
            text = f.read().decode()
    if tomllib is not None:
        return tomllib.loads(text)
    return _parse_toml_subset(text)


async def quiet_database(cluster, db, timeout: float = 60.0) -> None:
    """Wait for the cluster to settle (reference QuietDatabase.actor.cpp):
    recovery complete and a probe transaction commits."""
    from ..core.scheduler import now
    deadline = now() + timeout
    while now() < deadline:
        cc = cluster.current_cc()
        if cc is not None and cc.db_info.recovery_state in (
                "accepting_commits", "fully_recovered"):
            try:
                t = db.create_transaction()
                t.set(b"\x02quiet_probe", b"1")
                await t.commit()
                return
            except FdbError:
                pass
        await delay(1.0)
    raise FdbError(1004, "timed_out", "quiet_database timed out")


class NondeterminismAudit:
    """Records every call, from a file of the port's package, of the wall
    clock or the OS's entropy while installed: the simulator's contract
    is that nothing inside a run reads the outside world.  Findings are
    (function, file, line).  ALLOWED_FILES are the reference's escape
    hatches: core/rng.py seeds the nondeterministic id generator from
    os.urandom, core/scheduler.py reads the monotonic clock in real mode,
    and the thread pool, the profiler and the real network and files run
    only for real."""

    PATCHES = (("time", "time"), ("time", "time_ns"),
               ("time", "monotonic"), ("time", "perf_counter"),
               ("os", "urandom"), ("random", "random"),
               ("random", "randrange"), ("random", "getrandbits"))
    ALLOWED_FILES = ("core/rng.py", "core/scheduler.py",
                     "core/threadpool.py", "core/profiler.py",
                     "rpc/real_network.py", "server/real_fs.py")

    def __init__(self) -> None:
        import os as _os
        self.findings: List[tuple] = []
        self._saved: List[tuple] = []
        pkg_dir = _os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__)))
        self._pkg_prefix = pkg_dir + _os.sep

    def _record(self, func_name: str) -> None:
        import sys
        frame = sys._getframe(2)
        fn = frame.f_code.co_filename
        if not fn.startswith(self._pkg_prefix):
            return
        rel = fn[len(self._pkg_prefix):].replace("\\", "/")
        if rel.endswith(self.ALLOWED_FILES):
            return
        entry = (func_name, rel, frame.f_lineno)
        if entry not in self.findings:
            self.findings.append(entry)

    def __enter__(self) -> "NondeterminismAudit":
        import importlib
        for mod_name, attr in self.PATCHES:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)

            def make(orig=orig, label=f"{mod_name}.{attr}"):
                def wrapped(*a, **kw):
                    self._record(label)
                    return orig(*a, **kw)
                return wrapped
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, make())
        return self

    def __exit__(self, *exc) -> None:
        for mod, attr, orig in self._saved:
            setattr(mod, attr, orig)
        self._saved.clear()


class SimRunReport:
    """Everything one deterministic simulation run leaves behind;
    `slow_tasks` is the run's SlowTask events as (callback, wall ms),
    `slowest_callback` its slowest callback as (callback, wall ms), and
    `wall_s` / `virtual_s` its wall and simulated seconds."""

    def __init__(self, seed: int, metrics, unseed: int, digest: int,
                 folds: int, checkpoints, nondeterminism,
                 slow_tasks=(), slowest_callback=("", 0.0),
                 wall_s: float = 0.0, virtual_s: float = 0.0) -> None:
        self.seed = seed
        self.metrics = metrics
        self.unseed = unseed
        self.digest = digest
        self.folds = folds
        self.checkpoints = list(checkpoints)
        self.nondeterminism = nondeterminism
        self.slow_tasks = list(slow_tasks)
        self.slowest_callback = slowest_callback
        self.wall_s = wall_s
        self.virtual_s = virtual_s

    def __repr__(self) -> str:  # pragma: no cover
        return (f"SimRunReport(seed={self.seed}, unseed={self.unseed:#010x},"
                f" digest={self.digest:#010x}, folds={self.folds})")


def _sim_config(spec, n_workers: int, n_storage_workers: int,
                backend: Optional[str]):
    """The spec's [sim] worker pool and [cluster] configuration (unknown
    fields raise); `backend` names the Resolver roles' conflict set."""
    from ..server.interfaces import DatabaseConfiguration
    sim_conf = dict(spec.get("sim") or {})
    n_workers = int(sim_conf.pop("n_workers", n_workers))
    n_storage_workers = int(sim_conf.pop("n_storage_workers",
                                         n_storage_workers))
    if sim_conf:
        raise KeyError(f"unknown [sim] fields {sorted(sim_conf)} in spec")
    fields = dict(n_tlogs=2, log_replication=2, n_storage=2,
                  storage_replication=2)
    for k, v in (spec.get("cluster") or {}).items():
        if k not in DatabaseConfiguration._INT_FIELDS and \
                k not in DatabaseConfiguration._STR_FIELDS:
            raise KeyError(f"unknown [cluster] field {k!r} in spec")
        fields[k] = v
    if backend is not None:
        fields["conflict_backend"] = backend
    return DatabaseConfiguration(**fields), n_workers, n_storage_workers


def _knob_overrides(spec) -> Dict[str, Any]:
    """Apply the spec's [knobs] (server knobs first, then client knobs;
    every name checked before any is set); returns what to restore."""
    from ..core.knobs import client_knobs, server_knobs
    sknobs, cknobs = server_knobs(), client_knobs()

    def target(k: str):
        if not k.startswith("_"):
            if hasattr(sknobs, k):
                return sknobs
            if hasattr(cknobs, k):
                return cknobs
        raise KeyError(f"unknown [knobs] field {k!r} in spec")

    overrides = dict(spec.get("knobs") or {})
    for k in overrides:
        target(k)
    saved: Dict[str, Any] = {}
    for k, v in overrides.items():
        tgt = target(k)
        saved[k] = (tgt, getattr(tgt, k))
        setattr(tgt, k, v)
    return saved


def run_simulation(spec, seed: int, *, buggify: bool = False,
                   config=None, n_workers: int = 7,
                   n_storage_workers: int = 2, timeout: float = 1800.0,
                   audit: bool = True, device=None,
                   backend: Optional[str] = None,
                   **set_kwargs) -> SimRunReport:
    """One seeded simulation run of a test spec on a fresh world: fresh
    deterministic generator, run digest, event loop and SimFdbCluster,
    whose Resolver roles build their sets with `backend` (the spec's or
    the configuration's when None: "torch") on `device` with
    `set_kwargs`.  A device backend with no device given runs on the
    card and raises without one.

    The cyclic collector is off for the run (after a full collection):
    its timing depends on allocations made before the run, and a
    collection firing a finalizer's broken promise mid-run would make
    two same-seed runs diverge.  On the card the kernels are built
    before the run, so no build falls inside a callback."""
    import gc
    import time

    from ..core.buggify import enable_buggify
    from ..core.rng import (DeterministicRandom, reset_run_digest,
                            run_unseed, set_deterministic_random)
    from ..core.scheduler import set_event_loop
    from ..rpc.sim import set_simulator
    from ..server.cluster import SimFdbCluster

    spec = load_spec(spec) if isinstance(spec, str) else spec
    sim_config, n_workers, n_storage_workers = _sim_config(
        spec, n_workers, n_storage_workers, backend)
    if config is None:
        config = sim_config
    if (config.conflict_backend or "torch") in ("torch", "torch-raw",
                                                "sharded"):
        from ..conflict.window import resolve_device
        if resolve_device(device).type == "cuda":
            from .. import kernels
            kernels.build()
    saved_knobs = _knob_overrides(spec)
    gc_was_enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    set_deterministic_random(DeterministicRandom(seed))
    digest = reset_run_digest()
    enable_buggify(buggify)
    auditor = NondeterminismAudit() if audit else None
    # The run's wall seconds, for the report: read outside the audit.
    t0 = time.perf_counter()  # flowlint: disable=FTL001 -- report only
    try:
        if auditor is not None:
            auditor.__enter__()
        try:
            cluster = SimFdbCluster(
                config=config, n_workers=n_workers,
                n_storage_workers=n_storage_workers, device=device,
                **set_kwargs)

            async def go():
                return await run_test(cluster, spec)

            metrics = cluster.run_until(cluster.loop.spawn(go()),
                                        timeout=timeout)
        finally:
            if auditor is not None:
                auditor.__exit__()
        return SimRunReport(
            seed=seed, metrics=metrics, unseed=run_unseed(),
            digest=digest.value, folds=digest.folds,
            checkpoints=digest.checkpoints,
            nondeterminism=auditor.findings if auditor else [],
            slow_tasks=getattr(cluster.loop, "slow_tasks", ()),
            slowest_callback=getattr(cluster.loop, "slowest_callback",
                                     ("", 0.0)),
            wall_s=time.perf_counter() - t0,  # flowlint: disable=FTL001
            virtual_s=cluster.loop.now())
    finally:
        enable_buggify(False)
        set_simulator(None)
        set_event_loop(None)
        for k, (tgt, v) in saved_knobs.items():
            setattr(tgt, k, v)
        if gc_was_enabled:
            gc.enable()


def _divergence_report(r1: SimRunReport, r2: SimRunReport,
                       tail: int = 8) -> str:
    """First-divergence triage of two same-seed runs: align the digest
    checkpoints, find the first that disagrees, show `tail` around it
    from both runs, and list each run's audit findings and SlowTask
    events."""
    lines = [
        f"unseed mismatch for seed {r1.seed}: "
        f"{r1.unseed:#010x} != {r2.unseed:#010x} "
        f"(digest {r1.digest:#010x} vs {r2.digest:#010x}, "
        f"folds {r1.folds} vs {r2.folds})"]
    c1, c2 = r1.checkpoints, r2.checkpoints
    first = None
    for i in range(min(len(c1), len(c2))):
        if c1[i] != c2[i]:
            first = i
            break
    if first is None and len(c1) != len(c2):
        first = min(len(c1), len(c2))
    if first is None:
        lines.append("checkpoints identical -- divergence after the last "
                     "checkpoint (tail of the run)")
    else:
        lines.append(f"first divergent checkpoint: #{first} "
                     f"(~fold {(first + 1) * 1024})")
        lo = max(0, first - tail // 2)
        for run_name, cps in (("run1", c1), ("run2", c2)):
            lines.append(f"  {run_name} checkpoints "
                         f"[{lo}..{min(first + tail // 2, len(cps) - 1)}]:")
            for j in range(lo, min(first + tail // 2 + 1, len(cps))):
                folds, value, last_event, t = cps[j]
                marker = " <-- FIRST DIVERGENCE" if j == first else ""
                lines.append(f"    #{j} folds={folds} "
                             f"digest={value:#010x} t={t:.6f} "
                             f"last_event={last_event!r}{marker}")
    for run_name, r in (("run1", r1), ("run2", r2)):
        if r.nondeterminism:
            lines.append(f"  {run_name} nondeterminism sources flagged:")
            for func, file, lineno in r.nondeterminism:
                lines.append(f"    {func} called from {file}:{lineno}")
        if r.slow_tasks:
            lines.append(f"  {run_name} SlowTask events (not folded):")
            for name, ms in r.slow_tasks:
                lines.append(f"    {name} {ms} ms")
    return "\n".join(lines)


def run_test_twice(spec, seed: int, **kw):
    """Run the same (spec, seed) twice and require equal unseeds, digests
    and fold counts (reference TestHarness unseed check).  On divergence,
    raises AssertionError with _divergence_report's text.  Returns both
    reports."""
    r1 = run_simulation(spec, seed, **kw)
    r2 = run_simulation(spec, seed, **kw)
    if r1.unseed != r2.unseed or r1.digest != r2.digest or \
            r1.folds != r2.folds:
        raise AssertionError(_divergence_report(r1, r2))
    return r1, r2


async def run_test(cluster, spec: Dict[str, Any],
                   db=None) -> Dict[str, Dict[str, float]]:
    """Run every [[test]] entry; returns {workload: metrics}.  Raises
    AssertionError if a workload's check fails."""
    db = db or cluster.database()
    all_metrics: Dict[str, Dict[str, float]] = {}
    for test in spec.get("test", []):
        title = test.get("testTitle", "unnamed")
        TraceEvent("TestStart").detail("Title", title).log()
        instances: List[TestWorkload] = []
        for wconf in test.get("workload", []):
            name = wconf["testName"]
            cls = workload_registry.get(name)
            if cls is None:
                raise KeyError(f"unknown workload {name!r} "
                               f"(registered: {sorted(workload_registry)})")
            instances.append(cls(cluster, db, dict(wconf)))
        # Setup in turn, then every start at once (chaos beside load),
        # quiescence, then every check.
        for w in instances:
            await w.setup()
        await wait_all([spawn(w.start(), f"workload.{w.name}.start")
                        for w in instances])
        await quiet_database(cluster, db)
        for w in instances:
            ok = await w.check()
            TraceEvent("TestCheck",
                       Severity.Info if ok else Severity.Error).detail(
                "Workload", w.name).detail("Ok", ok).log()
            assert ok, f"workload {w.name} check FAILED in test {title!r}"
            all_metrics[w.name] = w.get_metrics()
        TraceEvent("TestComplete").detail("Title", title).log()
    return all_metrics
