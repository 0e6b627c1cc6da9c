"""Core helpers the conflict path needs (errors only)."""

from .error import FdbError, err

__all__ = ["FdbError", "err"]
