"""Workloads that drive the port's client (testing/workloads.py)."""

from .workload import TestWorkload
from .workloads import (ConsistencyCheckWorkload, CycleWorkload,
                        ReadWriteWorkload)

__all__ = ["ConsistencyCheckWorkload", "CycleWorkload", "ReadWriteWorkload",
           "TestWorkload"]
