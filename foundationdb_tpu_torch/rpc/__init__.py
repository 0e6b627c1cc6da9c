"""Request streams between roles and clients (local delivery only)."""

from .endpoint import TRANSPORT_ERRORS, RequestStream

__all__ = ["RequestStream", "TRANSPORT_ERRORS"]
