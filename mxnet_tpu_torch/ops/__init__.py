"""Operators of the port: attention (with the hand-written flash kernels),
the nn functions of the serving and training slices, and the registered
ops the imperative front end (``nd``) dispatches to by name."""
from . import registry
from . import attention, nn
from . import creation, elemwise, scalar, reduce, matrix

__all__ = ["registry", "attention", "nn", "creation", "elemwise", "scalar",
           "reduce", "matrix"]
