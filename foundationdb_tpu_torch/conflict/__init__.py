"""ConflictSet backends: the CPU oracle and the PyTorch + CUDA backend."""

from .api import ConflictSet, new_conflict_set
from .oracle import OracleConflictSet, VersionHistory

__all__ = ["ConflictSet", "new_conflict_set", "OracleConflictSet",
           "VersionHistory"]
