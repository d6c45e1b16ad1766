"""Operators of the port: attention (with the hand-written flash kernel)
and the nn functions the serving slice calls."""
from . import attention, nn

__all__ = ["attention", "nn"]
