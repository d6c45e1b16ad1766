"""Gluon ``Block`` and ``HybridBlock`` as ``torch.nn.Module`` subclasses.

Counterpart of ``mxnet_tpu/gluon/block.py``.  What differs, and why:

* Shapes are given at construction; there is no deferred init.  A block is
  built with its parameters on PyTorch's ``meta`` device (shape and dtype,
  no memory) and :meth:`Block.initialize` or :meth:`Block.load_dict`
  materialises them on a device, the GPU unless the caller says otherwise.
* Parameter names are the gluon structural names (``collect_params()``
  keys such as ``encoder.transformer_cells.0.attention.proj.weight``),
  which are the ``torch.nn.Module`` state-dict names as well.
* A block starts in inference mode (``training`` False), as gluon runs a
  forward outside ``autograd.record`` in predict mode; ``train()`` switches
  dropout on.
* :meth:`HybridBlock.hybridize` is a documented no-op for now: PyTorch runs
  eagerly, and CUDA graphs are a later change.
* :func:`functionalize` lifts a block into ``(pure_fn, params)``, the
  bridge ``parallel.TrainStep`` trains through, as in the JAX package.
* A block called with ``NDArray`` inputs (the imperative front end) unwraps
  them, runs with grad enabled only under ``autograd.record()`` and in
  training mode exactly when ``autograd.is_training()``, as gluon blocks
  read it, and returns NDArrays.  Its parameters' gradients are written by
  ``autograd.backward`` with the gluon default ``grad_req='write'`` (a
  parameter's ``grad_req`` attribute, where set, says otherwise; a
  parameter with ``requires_grad`` False gets none).  Such a call in
  training mode also lets the blocks write their aux states (BatchNorm's
  running statistics: ``_write_aux``), as the reference's NDArray
  dispatch does.  A call with plain tensors, as ``Servable`` and
  ``TrainStep`` make them, is ``torch.nn.Module``'s own and writes none.
"""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from .. import autograd
from .. import initializer as _init
from ..base import MXNetError
from ..device import DeviceLike, resolve
from ..ndarray.ndarray import NDArray

__all__ = ["Block", "HybridBlock", "to_dtype", "meta_parameter",
           "functionalize"]

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64}


def to_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a dtype or its name ('float32', 'bfloat16')."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) in _DTYPES:
        return _DTYPES[str(dtype)]
    raise ValueError("unsupported dtype %r" % (dtype,))


def meta_parameter(shape, dtype="float32") -> torch.nn.Parameter:
    """A parameter with shape and dtype but no storage yet."""
    return torch.nn.Parameter(torch.empty(tuple(shape), dtype=to_dtype(dtype),
                                          device="meta"))


class Block(torch.nn.Module):
    """Base building block (gluon ``Block``)."""

    #: True only inside a call on NDArrays (see :meth:`__call__`)
    _write_aux = False

    def __init__(self, **kwargs):
        super().__init__()
        self.training = False

    def register_child(self, block: "Block",
                       name: Optional[str] = None) -> None:
        self.add_module(name if name is not None else str(len(self._modules)),
                        block)

    def collect_params(self, select: Optional[str] = None
                       ) -> "OrderedDict[str, torch.nn.Parameter]":
        """Every parameter of the tree by structural name; ``select`` is a
        regular expression the name must match."""
        pattern = re.compile(select) if select else None
        return OrderedDict((n, p) for n, p in self.named_parameters()
                           if pattern is None or pattern.search(n))

    def initialize(self, init=None, device: DeviceLike = None,
                   generator: Optional[torch.Generator] = None,
                   seed: int = 0) -> "Block":
        """Materialise every parameter on ``device`` (default: the GPU) and
        fill it with ``init`` (default :class:`~..initializer.Uniform`),
        drawing from ``generator`` or, when none is given, from a new
        generator on that device seeded with ``seed``."""
        dev = resolve(device)
        init = _init.create(init)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(int(seed))
        self.to_empty(device=dev)
        for name, p in self.named_parameters():
            init(name, p.data, generator)
        return self

    def load_dict(self, params: Mapping[str, torch.Tensor],
                  device: DeviceLike = None) -> "Block":
        """Materialise the parameters on ``device`` (default: the GPU) and
        copy ``params`` in by structural name; a missing or extra name
        raises (``strict=True``)."""
        dev = resolve(device)
        self.to_empty(device=dev)
        self.load_state_dict(dict(params), strict=True)
        return self

    def cast(self, dtype) -> "Block":
        """Cast every floating-point parameter to ``dtype``."""
        return self.to(dtype=to_dtype(dtype))

    def hybridize(self, active: bool = True, **kwargs) -> None:
        """No-op: PyTorch runs eagerly; CUDA graphs are a later change."""

    def __call__(self, *args, **kwargs):
        if not any(isinstance(a, NDArray)
                   for a in args + tuple(kwargs.values())):
            return super().__call__(*args, **kwargs)
        args = tuple(a.data if isinstance(a, NDArray) else a for a in args)
        kwargs = {k: v.data if isinstance(v, NDArray) else v
                  for k, v in kwargs.items()}
        modes = [(m, m.training, getattr(m, "_write_aux", False))
                 for m in self.modules()]
        self.train(autograd.is_training())
        for m, _, _ in modes:
            m._write_aux = True
        try:
            with (torch.enable_grad() if autograd.is_recording()
                  else torch.no_grad()):
                out = super().__call__(*args, **kwargs)
        finally:
            for m, mode, write in modes:
                m.training = mode
                m._write_aux = write
        return _wrap(out)


def _wrap(out):
    """A forward's tensors (alone, or in a tuple or list) as NDArrays."""
    if isinstance(out, torch.Tensor):
        return NDArray(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap(o) for o in out)
    return out


class HybridBlock(Block):
    """Gluon ``HybridBlock``; see :meth:`Block.hybridize`."""


def functionalize(block: torch.nn.Module
                  ) -> Tuple[Callable, "OrderedDict[str, torch.Tensor]"]:
    """Lift a block into ``(pure_fn, params)``.

    ``params`` holds the block's parameter tensors (detached) by structural
    name.  ``pure_fn(params, *inputs, training=False)`` runs the block's
    forward with the given tensors in place of its parameters
    (``torch.func.functional_call``; every name must be given) and in
    training or inference mode as asked, restoring the block's own modes
    afterwards.  Parameters must be materialised (``initialize`` or
    ``load_dict``) first."""
    named = list(block.named_parameters())
    unset = [n for n, p in named if p.is_meta]
    if unset:
        raise MXNetError("functionalize: parameters %s have no storage; "
                         "call initialize() or load_dict() first"
                         % unset[:3])
    params = OrderedDict((n, p.detach()) for n, p in named)

    def pure_fn(param_values: Mapping[str, torch.Tensor], *inputs,
                training: bool = False):
        modes = [(m, m.training) for m in block.modules()]
        block.train(training)
        try:
            return torch.func.functional_call(
                block, dict(param_values), inputs, strict=True)
        finally:
            for m, mode in modes:
                m.training = mode

    return pure_fn, params
