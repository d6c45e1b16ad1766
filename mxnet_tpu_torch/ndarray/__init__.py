"""`mx.nd` namespace: NDArray and one function per registered op.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``: :func:`_make_op_func`
wraps an op name into a function over NDArrays; every op registered at
import becomes an attribute, and the module ``__getattr__`` resolves ops
registered later (user kernels from ``tpu_kernel.register``) at first
access.
"""
from __future__ import annotations

import sys
from types import ModuleType

from ..ops import registry as _registry
from .ndarray import (NDArray, invoke, array, zeros, ones, full, empty,
                      arange, eye, zeros_like, ones_like, concatenate,
                      waitall)
from .ndarray import stack_arrays as _stack_arrays

__all__ = ["NDArray", "invoke", "array", "zeros", "ones", "full", "empty",
           "arange", "eye", "zeros_like", "ones_like", "concatenate",
           "waitall", "stack", "concat"]


def _make_op_func(opname: str):
    op = _registry.get_op(opname)

    def fn(*args, out=None, **kwargs):
        return invoke(opname, *args, out=out, **kwargs)

    fn.__name__ = opname
    fn.__doc__ = op.doc
    return fn


_this = sys.modules[__name__]
for _name in _registry.list_ops():
    if not hasattr(_this, _name) and _name.isidentifier():
        setattr(_this, _name, _make_op_func(_name))


def stack(*data, axis=0, **kw):
    """MXNet varargs form: ``nd.stack(a, b, axis=0)``; also takes a list."""
    if len(data) == 1 and isinstance(data[0], (list, tuple)):
        data = tuple(data[0])
    return _stack_arrays(data, axis=axis)


def concat(*data, dim=1, axis=None, **kw):
    if len(data) == 1 and isinstance(data[0], (list, tuple)):
        data = tuple(data[0])
    return invoke("concat", *data, dim=dim if axis is None else axis)


Concat = concat

# `nd.random` (reference: python/mxnet/ndarray/random.py)
random = ModuleType(__name__ + ".random")
random.uniform = _make_op_func("_random_uniform")
random.normal = _make_op_func("_random_normal")
random.randn = lambda *shape, **kw: random.normal(shape=shape, **kw)
random.gamma = _make_op_func("_random_gamma")
random.exponential = _make_op_func("_random_exponential")
random.poisson = _make_op_func("_random_poisson")
random.randint = _make_op_func("_random_randint")
random.bernoulli = _make_op_func("_random_bernoulli")
random.multinomial = _make_op_func("_sample_multinomial")
random.shuffle = _make_op_func("shuffle")
sys.modules[random.__name__] = random


def __getattr__(name):
    """An op registered after import (a user kernel) as ``nd.<name>``."""
    if name.startswith("__"):
        raise AttributeError(name)
    try:
        _registry.get_op(name)
    except KeyError:
        raise AttributeError("module %r has no attribute %r"
                             % (__name__, name)) from None
    return _make_op_func(name)
