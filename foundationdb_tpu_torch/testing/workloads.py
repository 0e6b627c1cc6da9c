"""Built-in workloads (a trimmed copy of
foundationdb_tpu/testing/workloads.py), each registered under its name.

Reference models:
- Cycle         (fdbserver/workloads/Cycle.actor.cpp): a ring of keys;
  transactions swap pointers; the ring must remain a single cycle under
  any interleaving -- the serializability canary.
- ReadWrite     (fdbserver/workloads/ReadWrite.actor.cpp): configurable
  read/write load, reports ops/s.
- Attrition     (MachineAttrition.actor.cpp): kills random stateless
  workers on an interval.
- RandomClogging (RandomClogging.actor.cpp): clogs random process pairs.
- ChaosNemesis: the swizzle, partition, attrition, resolver-attrition,
  coordinator-attrition and disk-fault loops, every draw from the
  deterministic generator.
- NondeterminismCanary and HashOrderCanary: negative controls of the
  unseed check (a wall-clock read, a str set's iteration order).
- ConflictRange (ConflictRange.actor.cpp, simplified): random sets and
  range clears against a dict model, read back as one range.
- ConsistencyCheck (fdbserver/workloads/ConsistencyCheck.actor.cpp):
  every replica of every shard read at one read version, equal rows.

Left out: the nemesis's regionFailover loop (it needs log routers) and
grayClog loop (it needs the controller's peer-health trigger), and the
ApiCorrectness, Rollback, ChangeConfig, RandomMoveKeys, Watches,
tenant, region, backup, sched and read-storm workloads.
"""

from __future__ import annotations

import random
from typing import Dict

from ..core.error import FdbError
from ..core.futures import wait_all
from ..core.scheduler import delay, now, spawn
from .workload import TestWorkload, register_workload


@register_workload
class CycleWorkload(TestWorkload):
    name = "Cycle"

    async def setup(self) -> None:
        n = int(self.config.get("nodeCount", 16))
        prefix = self.config.get("prefix", "cycle/").encode()

        async def populate(t):
            for i in range(n):
                t.set(prefix + b"%06d" % i, prefix + b"%06d" % ((i + 1) % n))
        await self.run_transaction(populate)

    async def start(self) -> None:
        n = int(self.config.get("nodeCount", 16))
        actors = int(self.config.get("actorCount", 4))
        duration = float(self.config.get("testDuration", 10.0))
        prefix = self.config.get("prefix", "cycle/").encode()
        # Progress floor: keep swapping past the deadline until at least
        # this many swaps landed (0 = pure duration semantics, the
        # default).  A hard cap keeps a truly dead cluster from hanging
        # the workload forever.
        min_swaps = int(self.config.get("minSwaps", 0))
        hard_deadline = now() + max(duration * 10, duration + 60.0)
        rng = random.Random(int(self.config.get("seed", 1)))
        deadline = now() + duration
        swaps = [0]

        async def swapper(seed: int) -> None:
            r = random.Random(seed)
            while now() < deadline or (swaps[0] < min_swaps and
                                       now() < hard_deadline):
                async def swap(t):
                    a = prefix + b"%06d" % r.randrange(n)
                    b = await t.get(a)
                    cv = await t.get(b)
                    d = await t.get(cv)
                    t.set(a, cv)
                    t.set(b, d)
                    t.set(cv, b)
                await self.run_transaction(swap)
                swaps[0] += 1
        await wait_all([spawn(swapper(rng.randrange(1 << 30)))
                        for _ in range(actors)])
        self.metrics["swaps"] = swaps[0]

    async def check(self) -> bool:
        n = int(self.config.get("nodeCount", 16))
        prefix = self.config.get("prefix", "cycle/").encode()

        async def walk(t):
            seen, k = set(), prefix + b"%06d" % 0
            for _ in range(n):
                if k in seen:
                    return False
                seen.add(k)
                k = await t.get(k)
                if k is None:
                    return False
            return k == prefix + b"%06d" % 0 and len(seen) == n
        return await self.run_transaction(walk)


@register_workload
class ReadWriteWorkload(TestWorkload):
    name = "ReadWrite"

    async def setup(self) -> None:
        n = int(self.config.get("nodeCount", 100))

        async def populate(t):
            for i in range(n):
                t.set(b"rw/%08d" % i, b"v%08d" % i)
        await self.run_transaction(populate)

    async def start(self) -> None:
        n = int(self.config.get("nodeCount", 100))
        actors = int(self.config.get("actorCount", 4))
        reads = int(self.config.get("readsPerTransaction", 4))
        writes = int(self.config.get("writesPerTransaction", 2))
        duration = float(self.config.get("testDuration", 10.0))
        rng = random.Random(int(self.config.get("seed", 2)))
        deadline = now() + duration
        ops = [0]

        async def worker(seed: int) -> None:
            r = random.Random(seed)
            while now() < deadline:
                async def txn_fn(t):
                    for _ in range(reads):
                        await t.get(b"rw/%08d" % r.randrange(n))
                    for _ in range(writes):
                        t.set(b"rw/%08d" % r.randrange(n),
                              b"u%010d" % r.randrange(1 << 30))
                await self.run_transaction(txn_fn)
                ops[0] += reads + writes
        t0 = now()
        await wait_all([spawn(worker(rng.randrange(1 << 30)))
                        for _ in range(actors)])
        elapsed = max(now() - t0, 1e-9)
        self.metrics["operations"] = ops[0]
        self.metrics["ops_per_sec"] = ops[0] / elapsed

    async def check(self) -> bool:
        async def count(t):
            data = await t.get_range(b"rw/", b"rw0", limit=100000)
            return len(data)
        n = int(self.config.get("nodeCount", 100))
        return await self.run_transaction(count) == n


@register_workload
class AttritionWorkload(TestWorkload):
    """Kills random stateless-worker processes (reference MachineAttrition;
    storage-class workers are spared until data distribution can re-
    replicate lost shards)."""

    name = "Attrition"

    async def start(self) -> None:
        interval = float(self.config.get("testDuration", 10.0)) / max(
            int(self.config.get("machinesToKill", 2)), 1)
        rng = random.Random(int(self.config.get("seed", 3)))
        kills = 0
        for _ in range(int(self.config.get("machinesToKill", 2))):
            await delay(interval * (0.5 + rng.random()))
            victims = [p for _p, w, _cc, _lv in self.cluster.workers
                       if (p := _p).alive and w.process_class == "stateless"]
            # Keep at least two stateless workers alive so recovery can
            # always place a master + its transaction system.
            if len(victims) <= 2:
                continue
            victim = victims[rng.randrange(len(victims))]
            self.cluster.sim.kill_process(victim)
            kills += 1
        self.metrics["kills"] = kills


@register_workload
class RandomCloggingWorkload(TestWorkload):
    """Clogs random process pairs (reference RandomClogging)."""

    name = "RandomClogging"

    async def start(self) -> None:
        duration = float(self.config.get("testDuration", 10.0))
        rng = random.Random(int(self.config.get("seed", 4)))
        deadline = now() + duration
        clogs = 0
        while now() < deadline:
            await delay(duration / 10 * (0.5 + rng.random()))
            procs = self.cluster.sim.alive_processes()
            if len(procs) >= 2:
                a, b = rng.sample(procs, 2)
                self.cluster.sim.clog_pair(a, b,
                                           seconds=rng.random() * 2.0)
                clogs += 1
        self.metrics["clogs"] = clogs


@register_workload
class ChaosNemesisWorkload(TestWorkload):
    """Continuous deterministic nemesis (reference sim2 swizzle clogging +
    MachineAttrition + network partitions, run as one composable
    workload): three concurrent fault loops driven ENTIRELY by the
    deterministic RNG, so a failing (spec, seed) replays its exact fault
    schedule.

    - swizzle: clog a random subset of worker interfaces one at a time,
      then unclog them in REVERSE order (the reference's swizzle —
      staggered recovery stresses different quorum subsets than a single
      clog/unclog would);
    - attrition: rolling reboot / machine power-fail / kill+restart, one
      victim at a time, guarded by the replication policy
      (server/policy.py) so a fault never leaves the survivors unable to
      satisfy log or storage replication ("never break quorum");
    - partition: random worker pair partitions that always heal.

    Off by default:

    - resolverAttrition: kill the worker of a live resolver, then
      restart it;
    - coordinatorAttrition: reboot/hard-restart coordination servers one
      at a time under a quorum guard (all peers up), exercising
      well-known-token CoordinationClientInterface re-pointing;
    - diskFaults: inject a FATAL disk fault (io_error on fsync) into one
      storage worker's machine, wait for the process-death detection
      path, then clear the fault and RESTART the worker — the topology
      heals instead of permanently shrinking.

    start() ends by healing the network and restarting every downed
    worker, so quiescence and the invariant workloads' checks (Cycle,
    ConsistencyCheck) run against a whole cluster."""

    name = "ChaosNemesis"

    async def start(self) -> None:
        duration = float(self.config.get("testDuration", 10.0))
        self._deadline = now() + duration
        loops = []
        if self.config.get("swizzle", True):
            loops.append(spawn(self._swizzle_loop(), "nemesis.swizzle"))
        if self.config.get("attrition", True):
            loops.append(spawn(self._attrition_loop(), "nemesis.attrition"))
        if self.config.get("partitions", True):
            loops.append(spawn(self._partition_loop(), "nemesis.partition"))
        if self.config.get("resolverAttrition", False):
            loops.append(spawn(self._resolver_attrition_loop(),
                               "nemesis.resolverAttrition"))
        if self.config.get("coordinatorAttrition", False):
            loops.append(spawn(self._coordinator_attrition_loop(),
                               "nemesis.coordinatorAttrition"))
        if self.config.get("diskFaults", False):
            loops.append(spawn(self._disk_fault_loop(),
                               "nemesis.diskFaults"))
        await wait_all(loops)
        # Leave the cluster whole: heal every network fault and bring
        # back every downed worker before quiescence.
        self.cluster.sim.heal()
        for i, entry in enumerate(self.cluster.workers):
            if not entry[0].alive:
                self.cluster.restart_worker(i)

    # -- fault loops ---------------------------------------------------------
    def _alive_workers(self):
        return [e[0] for e in self.cluster.workers if e[0].alive]

    async def _swizzle_loop(self) -> None:
        from ..core.coverage import test_coverage
        from ..core.rng import deterministic_random
        rng = deterministic_random()
        sim = self.cluster.sim
        swizzles = 0
        while now() < self._deadline:
            await delay(0.5 + rng.random01() * 2.0)
            procs = self._alive_workers()
            if len(procs) < 2:
                continue
            k = rng.random_int(1, max(2, len(procs) // 2 + 1))
            rng.shuffle(procs)
            victims = procs[:k]
            clogged = []
            for p in victims:
                sim.clog_process(p, seconds=30.0)   # manually unclogged
                clogged.append(p)
                await delay(rng.random01() * 0.3)
            for p in reversed(clogged):
                await delay(rng.random01() * 0.3)
                sim.unclog_process(p)
            swizzles += 1
            test_coverage("ChaosNemesisSwizzle")
        self.metrics["swizzles"] = swizzles

    async def _partition_loop(self) -> None:
        from ..core.coverage import test_coverage
        from ..core.rng import deterministic_random
        rng = deterministic_random()
        sim = self.cluster.sim
        cycles = 0
        while now() < self._deadline:
            await delay(1.0 + rng.random01() * 2.0)
            procs = self._alive_workers()
            if len(procs) < 2:
                continue
            i = rng.random_int(0, len(procs))
            j = rng.random_int(0, len(procs) - 1)
            if j >= i:
                j += 1
            a, b = procs[i], procs[j]
            sim.partition(a, b)
            test_coverage("ChaosNemesisPartition")
            await delay(0.2 + rng.random01() * 1.5)
            sim.heal_pair(a, b)
            cycles += 1
        self.metrics["partitions"] = cycles

    def _safe_to_fail(self, victim) -> bool:
        """Would the survivors still satisfy replication + leave a viable
        control plane?  Consults the replication policy engine
        (server/policy.py) rather than ad-hoc counts."""
        from ..server.policy import policy_from_config
        c = self.cluster
        alive = [e[0] for e in c.workers
                 if e[0].alive and e[0] is not victim]
        stateless = [p for p in alive if p.process_class == "stateless"]
        storage = [p for p in alive if p.process_class == "storage"]
        # Master + transaction system need somewhere to live.
        if len(stateless) < 2:
            return False

        def cands(procs):
            return [(p.name, {"dcid": p.locality.dcid,
                              "zoneid": p.locality.zoneid,
                              "machineid": p.locality.machineid})
                    for p in procs]
        log_pol = policy_from_config(
            getattr(c.config, "log_replication", 1))
        if log_pol.select(cands(stateless)) is None:
            return False
        st_pol = policy_from_config(
            getattr(c.config, "storage_replication", 1))
        if st_pol.select(cands(storage)) is None:
            return False
        return True

    async def _attrition_loop(self) -> None:
        from ..core.coverage import test_coverage
        from ..core.rng import deterministic_random
        rng = deterministic_random()
        sim = self.cluster.sim
        restart_delay = float(self.config.get("restartDelay", 1.5))
        reboots = power_fails = kills = 0
        while now() < self._deadline:
            await delay(1.0 + rng.random01() * 2.5)
            entries = [(i, e[0]) for i, e in enumerate(self.cluster.workers)
                       if e[0].alive]
            if not entries:
                continue
            idx, victim = entries[rng.random_int(0, len(entries))]
            if not self._safe_to_fail(victim):
                continue
            test_coverage("ChaosNemesisAttrition")
            roll = rng.random01()
            if roll < 0.5:
                sim.reboot_process(victim)      # roles respawn via hook
                reboots += 1
            elif roll < 0.8:
                sim.power_fail_machine(victim.locality.machineid)
                power_fails += 1
                await delay(restart_delay)
                self.cluster.restart_worker(idx)
            else:
                sim.kill_process(victim)
                kills += 1
                await delay(restart_delay)
                self.cluster.restart_worker(idx)
            await delay(restart_delay)          # one victim at a time
        self.metrics["reboots"] = reboots
        self.metrics["power_fails"] = power_fails
        self.metrics["kills"] = kills

    async def _resolver_attrition_loop(self) -> None:
        """Targeted resolution-plane attrition: kill the worker
        hosting a RESOLVER of the current generation — the epoch ends,
        recovery recruits a fresh plane (persisted boundaries adopted,
        empty conflict windows behind the recovery_version MVCC floor) —
        then restart the worker.  The Cycle + ConsistencyCheck workloads
        running alongside prove verdict continuity across the plane
        change; generic attrition only hits resolvers by luck."""
        from ..core.coverage import test_coverage
        from ..core.rng import deterministic_random
        rng = deterministic_random()
        sim = self.cluster.sim
        restart_delay = float(self.config.get("restartDelay", 1.5))
        kills = 0
        while now() < self._deadline:
            await delay(2.0 + rng.random01() * 3.0)
            cc = self.cluster.current_cc()
            if cc is None or cc.db_info.recovery_state not in (
                    "accepting_commits", "fully_recovered"):
                continue
            resolvers = list(cc.db_info.resolvers)
            if not resolvers:
                continue
            iface = resolvers[rng.random_int(0, len(resolvers))]
            victim = self.cluster.process_of(iface)
            if victim is None or not victim.alive:
                continue
            idx = next((i for i, e in enumerate(self.cluster.workers)
                        if e[0] is victim), None)
            if idx is None or not self._safe_to_fail(victim):
                continue
            test_coverage("ChaosNemesisResolverKill")
            sim.kill_process(victim)
            kills += 1
            await delay(restart_delay)
            self.cluster.restart_worker(idx)
            await delay(restart_delay)      # one victim at a time
        self.metrics["resolver_kills"] = kills

    async def _coordinator_attrition_loop(self) -> None:
        """Rolling coordination-server restarts: one coordinator at a
        time, a clean reboot or a hard kill and replace on the same
        address, under a quorum guard (every peer up before a new victim
        is taken).  The durable
        generation registers recover from the machine's files, leader
        election re-runs through the survivors, and every client's
        CoordinationClientInterface re-points via the well-known-token
        endpoints without a stuck GRV pipeline."""
        from ..core.coverage import test_coverage
        from ..core.rng import deterministic_random
        rng = deterministic_random()
        c = self.cluster
        restart_delay = float(self.config.get("restartDelay", 1.5))
        restarts = 0
        while now() < self._deadline:
            await delay(2.0 + rng.random01() * 3.0)
            coords = getattr(c, "coordinators", None)
            if not coords:
                return              # static harness: nothing to restart
            # Quorum guard: restart only when every coordinator serves,
            # so at most one is ever down (the port's coordinator
            # recovers its registers before run() returns).
            if not all(p.alive for p, _s in coords):
                continue
            i = rng.random_int(0, len(coords))
            c.restart_coordinator(i, hard=rng.random01() < 0.5)
            test_coverage("ChaosCoordinatorRestart")
            restarts += 1
            await delay(restart_delay)
        self.metrics["coordinator_restarts"] = restarts

    async def _disk_fault_loop(self) -> None:
        """Restart-capable fatal disk faults: arm an io_error-on-fsync
        profile on one storage worker's
        machine, wait for the detection path to kill the process
        (StorageIoErrorDeath / TLogIoErrorDeath), then DISARM the fault
        and restart the worker on the same machine — the harness heals
        instead of permanently shrinking, so a long chaos run keeps its
        full topology."""
        from ..core.coverage import test_coverage
        from ..core.rng import deterministic_random
        from ..server.sim_fs import DiskFaultProfile
        rng = deterministic_random()
        sim = self.cluster.sim
        restart_delay = float(self.config.get("restartDelay", 1.5))
        faults = 0
        while now() < self._deadline:
            await delay(1.0 + rng.random01() * 2.0)
            entries = [(i, e[0]) for i, e in enumerate(self.cluster.workers)
                       if e[0].alive and e[0].process_class == "storage"]
            if not entries:
                continue
            idx, victim = entries[rng.random_int(0, len(entries))]
            if not self._safe_to_fail(victim):
                continue
            fs = sim.fs_for(victim)
            fs.set_fault_profile("", DiskFaultProfile(io_error_sync_p=1.0))
            # Bounded wait for the io_error death; a machine that never
            # fsyncs inside the window just gets the fault disarmed.
            for _ in range(40):
                if not victim.alive:
                    break
                await delay(0.25)
            fs.clear_fault_profiles()
            if not victim.alive:
                faults += 1
                test_coverage("ChaosFatalDiskRestart")
                await delay(restart_delay)
                self.cluster.restart_worker(idx)
            await delay(restart_delay)      # one victim at a time
        self.metrics["disk_fault_restarts"] = faults

    async def check(self) -> bool:
        # The nemesis's own invariant: it put the cluster back together.
        return all(e[0].alive for e in self.cluster.workers)


@register_workload
class NondeterminismCanaryWorkload(TestWorkload):
    """DELIBERATELY nondeterministic workload (negative control for the
    unseed verifier): reads the WALL CLOCK and lets it perturb
    both the deterministic RNG's draw count and the transaction schedule.
    run_test_twice on any spec containing this workload MUST fail its
    unseed check, and the NondeterminismAudit must flag the time.time_ns
    call — a verifier that rubber-stamps this workload is broken.  Never
    include it in a real correctness spec."""

    name = "NondeterminismCanary"

    async def start(self) -> None:
        import time as _time
        from ..core.rng import deterministic_random
        # Two independent wall-clock residues: the chance of BOTH
        # colliding across two runs is ~1e-6, so the negative test is
        # solid without being flaky.
        # The wall-clock read IS this workload's entire purpose (negative
        # control): the verifier must catch it, flowlint must not.
        t = _time.time_ns()  # flowlint: disable=FTL001
        n1 = t % 997
        n2 = (t // 997) % 991
        rng = deterministic_random()
        for _ in range(n1 + n2):
            rng.random01()          # draw count differs => unseed differs
        writes = t % 5 + 1          # schedule differs => digest differs

        async def put(txn):
            for i in range(writes):
                txn.set(b"canary/%02d" % i, b"x")
        await self.run_transaction(put)
        self.metrics["writes"] = writes


@register_workload
class HashOrderCanaryWorkload(TestWorkload):
    """DELIBERATELY PYTHONHASHSEED-sensitive workload (negative control
    for CROSS-process unseed reproduction): iterates a str SET
    and folds the iteration order into both the deterministic RNG's draw
    count and the transaction schedule.  Two runs in processes sharing a
    pinned PYTHONHASHSEED replay bit-identically; different hash seeds
    almost surely (collision ~1e-8: two independent ~1e4 residues) yield
    different unseeds — the divergence scripts/run_chaos.py's pinned
    repro commands exist to rule out.  Never include it in a real
    correctness spec."""

    name = "HashOrderCanary"

    async def start(self) -> None:
        from ..core.rng import deterministic_random
        from ..core.scheduler import delay as sim_delay
        n = int(self.config.get("nodeCount", 32))
        sig = 0
        # The set iteration below is this workload's entire purpose
        # (order-sensitivity canary): flowlint must not flag it, the
        # cross-process verifier must catch it when hash seeds differ.
        for name in set("canary-%03d" % i for i in range(n)):  # flowlint: disable=FTL005
            # Polynomial fold: permutation-sensitive, unlike sum/xor.
            sig = (sig * 1000003 + int(name[-3:])) & 0xFFFFFFFF
        rng = deterministic_random()
        for _ in range(sig % 9973 + 1):
            rng.random01()                  # draw count => unseed differs
        await sim_delay((sig // 9973 % 9973) * 1e-6)   # schedule => digest

        async def put(txn):
            txn.set(b"hash_canary", b"%08x" % sig)
        await self.run_transaction(put)
        self.metrics["order_sig"] = float(sig)


@register_workload
class ConflictRangeWorkload(TestWorkload):
    """Randomized serializability cross-check vs. an in-memory model
    (reference ConflictRange.actor.cpp:31, simplified): one actor applies
    random sets/clears through transactions AND to a local dict; after
    quiescence the database must equal the model exactly."""

    name = "ConflictRange"

    async def start(self) -> None:
        duration = float(self.config.get("testDuration", 5.0))
        rng = random.Random(int(self.config.get("seed", 5)))
        n = int(self.config.get("nodeCount", 50))
        self.model: Dict[bytes, bytes] = {}
        deadline = now() + duration
        while now() < deadline:
            op = rng.random()
            if op < 0.6:
                k = b"cr/%04d" % rng.randrange(n)
                v = b"%08d" % rng.randrange(1 << 20)

                async def do_set(t, k=k, v=v):
                    t.set(k, v)
                await self.run_transaction(do_set)
                self.model[k] = v
            else:
                lo = rng.randrange(n)
                hi = min(n, lo + rng.randrange(1, 8))
                b, e = b"cr/%04d" % lo, b"cr/%04d" % hi

                async def do_clear(t, b=b, e=e):
                    t.clear(b, e)
                await self.run_transaction(do_clear)
                for k in [k for k in self.model if b <= k < e]:
                    del self.model[k]

    async def check(self) -> bool:
        async def read_all(t):
            return dict(await t.get_range(b"cr/", b"cr0", limit=100000))
        actual = await self.run_transaction(read_all)
        return actual == self.model


@register_workload
class ConsistencyCheckWorkload(TestWorkload):
    """The replica audit (reference ConsistencyCheck.actor.cpp:31, its
    core check): for every shard, the whole span read at one read
    version from EVERY replica of its team, the rows required equal.  A
    replica that answers wrong_shard_server or future_version (still
    fetching after a move) is asked again after the shard is located
    again."""

    name = "ConsistencyCheck"

    async def check(self) -> bool:
        from ..rpc.endpoint import RequestStream
        from ..server.interfaces import GetKeyValuesRequest
        shards_audited = 0
        rows = 0
        cursor = b""
        while cursor < b"\xff":
            b, e, ssis = await self.db.get_shard_location(cursor)
            if not ssis:
                cursor = e
                continue
            while True:
                t = self.db.create_transaction()
                try:
                    version = await t._ensure_read_version()
                    replies = []
                    for ssi in ssis:
                        replies.append(await RequestStream.at(
                            ssi.get_key_values.endpoint).get_reply(
                            GetKeyValuesRequest(
                                begin=max(b, cursor), end=min(e, b"\xff"),
                                version=version, limit=1 << 30,
                                limit_bytes=1 << 40)))
                    first = replies[0].data
                    for i, r in enumerate(replies[1:], 1):
                        if r.data != first:
                            raise AssertionError(
                                f"replica divergence in [{b!r},{e!r}): "
                                f"replica 0 has {len(first)} kvs, "
                                f"replica {i} has {len(r.data)}")
                    shards_audited += 1
                    rows += len(first) * len(replies)
                    break
                except FdbError as ex:
                    if ex.name not in ("wrong_shard_server", "future_version",
                                       "broken_promise", "transaction_too_old",
                                       "request_maybe_delivered"):
                        raise
                    await delay(0.1)
                    self.db.invalidate_cache(max(b, cursor))
                    b, e, ssis = await self.db.get_shard_location(cursor)
            cursor = e
        self.metrics["shards_audited"] = shards_audited
        self.metrics["rows_compared"] = rows
        return True
