"""Transaction payload types used by the conflict path and the resolver."""

from .types import (CommitResult, CommitTransactionRef, KeyRange, Mutation,
                    MutationType, Version, key_after, single_key_range)

__all__ = ["CommitResult", "CommitTransactionRef", "KeyRange", "Mutation",
           "MutationType", "Version", "key_after", "single_key_range"]
