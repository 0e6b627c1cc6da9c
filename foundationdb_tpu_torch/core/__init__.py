"""Core helpers the conflict path and its supervisor need: errors, the
server knobs, BUGGIFY sites and their random draws, the hook for a
caller's event loop, trace events and latency histograms."""

from .error import FdbError, err
from .knobs import server_knobs

__all__ = ["FdbError", "err", "server_knobs"]
