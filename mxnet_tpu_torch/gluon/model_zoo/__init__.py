"""Model zoo of the port."""
from . import bert
from . import vision

__all__ = ["bert", "vision"]
