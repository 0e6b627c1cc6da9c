"""TestWorkload: composable test units (a copy of
foundationdb_tpu/testing/workload.py).

Reference: fdbserver/workloads/workloads.actor.h:60-82 — every workload
implements setup (populate), start (drive traffic / inject faults), check
(verify invariants after quiescence), getMetrics; workloads compose in one
test spec (e.g. Cycle + RandomClogging + Attrition) and run concurrently
against the same simulated cluster.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Type

from ..core.error import FdbError


class TestWorkload:
    """Base class of a workload; a subclass registers with
    @register_workload under its `name`, which a spec's testName names."""

    name = "base"

    def __init__(self, cluster, db, config: Dict[str, Any]) -> None:
        self.cluster = cluster      # the cluster the workload drives
        self.db = db
        self.config = config
        self.metrics: Dict[str, float] = {}

    async def setup(self) -> None:          # populate initial data
        return

    async def start(self) -> None:          # drive load / chaos
        return

    async def check(self) -> bool:          # verify invariants
        return True

    def get_metrics(self) -> Dict[str, float]:
        return dict(self.metrics)

    # -- helpers shared by workloads -----------------------------------------
    async def run_transaction(self, fn: Callable) -> Any:
        """Retry loop: `await fn(txn)`, commit, retry on retryable errors."""
        txn = self.db.create_transaction()
        while True:
            try:
                result = await fn(txn)
                await txn.commit()
                return result
            except FdbError as e:
                await txn.on_error(e)


workload_registry: Dict[str, Type[TestWorkload]] = {}


def register_workload(cls: Type[TestWorkload]) -> Type[TestWorkload]:
    workload_registry[cls.name] = cls
    return cls
