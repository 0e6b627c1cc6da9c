"""Workloads that drive the port's client (testing/workloads.py)."""

from .workload import TestWorkload
from .workloads import CycleWorkload, ReadWriteWorkload

__all__ = ["CycleWorkload", "ReadWriteWorkload", "TestWorkload"]
