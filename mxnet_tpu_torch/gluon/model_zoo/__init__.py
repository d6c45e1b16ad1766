"""Model zoo of the port."""
from . import bert
from . import ssd
from . import vision

__all__ = ["bert", "ssd", "vision"]
