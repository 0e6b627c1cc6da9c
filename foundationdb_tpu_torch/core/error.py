"""Error codes (trimmed to what the conflict path, its supervisor, the
commit proxy's replies, the write path and its recovery, the event loop
and the client raise or retry on).

Mirrors the reference's flow/error_definitions.h error-code contract."""

from __future__ import annotations


class FdbError(Exception):
    """An error with a FoundationDB-compatible numeric code."""

    def __init__(self, code: int, name: str = "", message: str = ""):
        self.code = code
        self.name = name or _CODE_TO_NAME.get(code, f"error_{code}")
        super().__init__(message or self.name)

    def __repr__(self) -> str:  # pragma: no cover
        return f"FdbError({self.code}, {self.name!r})"


ERROR_CODES = {
    "end_of_stream": 1,
    "operation_failed": 1000,
    "wrong_shard_server": 1001,
    "timed_out": 1004,
    "transaction_too_old": 1007,
    "future_version": 1009,
    "not_committed": 1020,
    "commit_unknown_result": 1021,
    "connection_failed": 1026,
    "request_maybe_delivered": 1034,
    "accessed_unreadable": 1036,
    "process_behind": 1037,
    "proxy_memory_limit_exceeded": 1042,
    "broken_promise": 1100,
    "operation_cancelled": 1101,
    "master_recovery_failed": 1201,
    "io_error": 1510,
    "client_invalid_operation": 2000,
    "key_outside_legal_range": 2003,
    "inverted_range": 2005,
    "transaction_too_large": 2101,
    "key_too_large": 2102,
    "value_too_large": 2103,
    "internal_error": 4100,
}

_CODE_TO_NAME = {v: k for k, v in ERROR_CODES.items()}


class ActorCancelled(BaseException):
    """Raised inside an actor coroutine when its future is cancelled.

    Derives from BaseException (like asyncio.CancelledError) so ordinary
    `except Exception` handlers do not swallow cancellation."""


def err(name: str, message: str = "") -> FdbError:
    return FdbError(ERROR_CODES[name], name, message)
