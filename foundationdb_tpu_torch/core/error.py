"""Error codes (trimmed to what the conflict path, its supervisor, the
commit proxy's replies, the write path and its recovery raise).

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
    "operation_failed": 1000,
    "timed_out": 1004,
    "transaction_too_old": 1007,
    "future_version": 1009,
    "not_committed": 1020,
    "connection_failed": 1026,
    "request_maybe_delivered": 1034,
    "broken_promise": 1100,
    "master_recovery_failed": 1201,
    "io_error": 1510,
    "inverted_range": 2005,
    "internal_error": 4100,
}

_CODE_TO_NAME = {v: k for k, v in ERROR_CODES.items()}


def err(name: str, message: str = "") -> FdbError:
    return FdbError(ERROR_CODES[name], name, message)
