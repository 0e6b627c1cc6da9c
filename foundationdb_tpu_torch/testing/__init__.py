"""The deterministic-simulation test harness: workloads, specs and the
tester (testing/tester.py run_simulation over SimFdbCluster)."""

from .workload import TestWorkload, register_workload, workload_registry
from .workloads import (ConsistencyCheckWorkload, CycleWorkload,
                        ReadWriteWorkload)
from .tester import (NondeterminismAudit, SimRunReport, load_spec,
                     run_simulation, run_test, run_test_twice)

__all__ = ["ConsistencyCheckWorkload", "CycleWorkload", "ReadWriteWorkload",
           "TestWorkload", "register_workload", "workload_registry",
           "NondeterminismAudit", "SimRunReport", "load_spec",
           "run_simulation", "run_test", "run_test_twice"]
