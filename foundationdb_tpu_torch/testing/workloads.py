"""Built-in workloads (the Cycle, ReadWrite and ConsistencyCheck
workloads of foundationdb_tpu/testing/workloads.py:81-192, :850-898).

Reference models:
- Cycle         (fdbserver/workloads/Cycle.actor.cpp): a ring of keys;
  transactions swap pointers; the ring must remain a single cycle under
  any interleaving -- the serializability canary.
- ReadWrite     (fdbserver/workloads/ReadWrite.actor.cpp): configurable
  read/write load, reports ops/s.
- ConsistencyCheck (fdbserver/workloads/ConsistencyCheck.actor.cpp):
  every replica of every shard read at one read version, equal rows.

Left out: the fault injectors (Attrition, RandomClogging), which need
the simulator, and the other workloads.
"""

from __future__ import annotations

import random

from ..core.error import FdbError
from ..core.futures import wait_all
from ..core.scheduler import delay, now, spawn
from .workload import TestWorkload


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
