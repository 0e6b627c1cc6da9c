"""The client: Database and Transaction with read-your-writes (WriteMap),
the retry loop, and the GRV batcher, read-version lease, location cache
and replica failover behind them."""

from .database import RETRYABLE, Database, Transaction
from .writemap import WriteMap

__all__ = ["Database", "RETRYABLE", "Transaction", "WriteMap"]
