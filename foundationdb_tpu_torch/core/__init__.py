"""Core helpers the conflict path needs: errors and the server knobs it
reads."""

from .error import FdbError, err
from .knobs import server_knobs

__all__ = ["FdbError", "err", "server_knobs"]
