"""Transaction payload types used by the conflict path."""

from .types import (CommitResult, CommitTransactionRef, KeyRange, Version,
                    key_after, single_key_range)

__all__ = ["CommitResult", "CommitTransactionRef", "KeyRange", "Version",
           "key_after", "single_key_range"]
