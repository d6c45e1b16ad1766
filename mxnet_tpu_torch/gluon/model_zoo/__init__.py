"""Model zoo of the port."""
from . import bert

__all__ = ["bert"]
