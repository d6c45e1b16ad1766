"""Gluon ``Block`` and ``HybridBlock`` as ``torch.nn.Module`` subclasses.

Counterpart of ``mxnet_tpu/gluon/block.py``.  What differs, and why:

* A block is built with its parameters on PyTorch's ``meta`` device
  (shape and dtype, no memory).  :meth:`Block.initialize` or
  :meth:`Block.load_dict` materialises them on a device, the GPU unless
  the caller says otherwise.  A size not given at construction (a
  layer's ``in_units`` or ``in_channels`` of 0) is inferred at the
  block's first call, as the reference's deferred init does: the layer's
  ``infer_shape`` sets it from the input, then the parameter is
  materialised on the device ``initialize`` recorded and filled by the
  recorded initializer, outside any autograd recording.
* Parameter names are the gluon structural names (``collect_params()``
  keys such as ``encoder.transformer_cells.0.attention.proj.weight``),
  which are the ``torch.nn.Module`` state-dict names as well.
  ``collect_params()`` gives gluon :class:`~.parameter.Parameter` handles
  (``data()``, ``grad()``, ``grad_req``, ``lr_mult``, ``wd_mult``) in a
  :class:`~.parameter.ParameterDict`; the port's own code reads the
  tensors through ``named_parameters()``.
* A block starts in inference mode (``training`` False), as gluon runs a
  forward outside ``autograd.record`` in predict mode; ``train()`` switches
  dropout on.
* :meth:`HybridBlock.hybridize` is a documented no-op for now: PyTorch runs
  eagerly, and CUDA graphs are a later change.
* :func:`functionalize` lifts a block into ``(pure_fn, params)``, the
  bridge ``parallel.TrainStep`` trains through, as in the JAX package.
* ``save_parameters`` / ``load_parameters`` (and the v1.x
  ``save_params`` / ``load_params``) write and read the reference's
  ``.params`` file (``nd.save``'s byte format, keyed by structural name),
  so a file of either package loads in the other.  ``share_parameters``
  makes slots hold one parameter; ``params`` and ``summary`` are the
  reference's.  Constructors take the reference's ``prefix`` and
  ``params`` keywords and raise its ``TypeError`` on any other.
* A block called with ``NDArray`` inputs (the imperative front end; also
  in lists or tuples, as a recurrent layer's states come) unwraps
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
* Parameters with a copy on each of several contexts
  (``initialize(ctx=[c0, c1])``): a call on NDArrays runs on the copies of
  its first NDArray input's context (the reference's ``p.data(ctx)``), by
  ``torch.func.functional_call`` over those copies when the context is
  not the first, so that backward writes that copy's gradient and a
  training call that copy's BatchNorm statistics; its outputs carry that
  context.  A child whose deferred parameters the call materialises runs
  on its own new copies the same way.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Mapping, Optional, Tuple

import torch

from .. import autograd
from ..base import MXNetError
from ..device import Context, DeviceLike, resolve
from ..ndarray.ndarray import NDArray
from .parameter import (DeferredInitializationError, ParameterDict, assign,
                        collect, ctx_copies, load_host, meta_parameter,
                        param_handle, param_slots)

__all__ = ["Block", "HybridBlock", "to_dtype", "meta_parameter",
           "functionalize"]

#: the context a call on NDArrays runs in, for the children it reaches
_CALL = threading.local()

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64}


def to_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a dtype or its name ('float32', 'bfloat16')."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) in _DTYPES:
        return _DTYPES[str(dtype)]
    raise ValueError("unsupported dtype %r" % (dtype,))


class Block(torch.nn.Module):
    """Base building block (gluon ``Block``)."""

    #: True only inside a call on NDArrays (see :meth:`__call__`)
    _write_aux = False

    def __init__(self, prefix: Optional[str] = None, params=None):
        super().__init__()
        self.training = False
        self._prefix = prefix or ""
        self._shared_params = params

    def __getattr__(self, name: str):
        # a parameter attribute (``net.weight``) is its gluon Parameter, as
        # in the reference; the layers' forwards read the tensor from
        # ``self._parameters``, where ``functional_call`` swaps its own in
        params = self.__dict__.get("_parameters")
        if params is not None and name in params:
            return None if params[name] is None else param_handle(self, name)
        return super().__getattr__(name)

    def register_child(self, block: "Block",
                       name: Optional[str] = None) -> None:
        self.add_module(name if name is not None else str(len(self._modules)),
                        block)

    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        """Every parameter of the tree by structural name, as gluon
        :class:`~.parameter.Parameter` handles; ``select`` is a regular
        expression the name must match."""
        return collect(self, select)

    def sharding_spec(self, layout):
        """Per-parameter partition specs for sharded training (the
        :class:`~..parallel.speclayout.SpecLayout` hook): called by
        ``SpecLayout.resolve`` on every block of the tree; return
        ``{parameter attribute name or Parameter: PartitionSpec}`` to pin
        this block's own parameters (``"weight"``), or an empty mapping
        to take the layout's defaults (embeddings and linears split on
        ``tp``, everything else sheet-sharded on ``fsdp``).  A
        ``PartitionSpec()`` replicates; an axis the mesh lacks, or one
        that does not divide the dimension, drops out."""
        return {}

    def initialize(self, init=None, ctx: DeviceLike = None,
                   verbose: bool = False, force_reinit: bool = False, *,
                   device: DeviceLike = None,
                   generator: Optional[torch.Generator] = None,
                   seed: int = 0) -> "Block":
        """Materialise every parameter on ``device`` (or ``ctx``: a context
        or a list of them, a copy on each; default: the GPU) and fill it
        with ``init`` (default
        :class:`~..initializer.Uniform`), in ``named_parameters()`` order,
        drawing from ``generator`` or, when none is given, from a new
        generator on that device seeded with ``seed``.  A parameter already
        initialised keeps its value unless ``force_reinit``; one whose size
        is not known yet is materialised at the block's first call, from
        the same generator."""
        if ctx is not None and device is not None:
            raise ValueError("initialize: pass ctx or device, not both")
        self.collect_params().initialize(
            init, device=ctx if device is None else device,
            force_reinit=force_reinit, generator=generator, seed=seed)
        return self

    def reset_ctx(self, ctx) -> None:
        """Move every parameter to ``ctx`` (a context or a list of them,
        a copy on each)."""
        self.collect_params().reset_ctx(ctx)

    def load_dict(self, params: Mapping[str, torch.Tensor],
                  device: DeviceLike = None) -> "Block":
        """Materialise the parameters on ``device`` (default: the GPU) and
        copy ``params`` in by structural name, in each parameter's dtype; a
        missing or extra name, or a size that disagrees, raises.  A
        parameter whose size is not known yet takes it from ``params``."""
        dev = resolve(device)
        slots = list(param_slots(self))
        names = [n for n, _, _ in slots]
        missing = [n for n in names if n not in params]
        extra = [k for k in params if k not in set(names)]
        if missing or extra:
            raise RuntimeError(
                "Error(s) in loading parameters for %s: missing %s, "
                "unexpected %s" % (type(self).__name__,
                                   ", ".join('"%s"' % n for n in missing),
                                   ", ".join('"%s"' % n for n in extra)))
        with torch.no_grad():
            for name, owner, attr in slots:
                value = torch.as_tensor(params[name])
                p = param_handle(owner, attr)
                old = p._tensor()
                if old.is_meta:
                    p.shape = value.shape
                elif tuple(old.shape) != tuple(value.shape):
                    raise RuntimeError(
                        "size mismatch for %s: the parameter is %s, the "
                        "value %s" % (name, tuple(old.shape),
                                      tuple(value.shape)))
                p._replace(torch.empty(tuple(value.shape), dtype=old.dtype,
                                       device=dev)).copy_(value)
                for t in list(p._tensors().values())[1:]:
                    t.copy_(value)
                p._set_pending(None)
        return self

    @property
    def params(self) -> ParameterDict:
        """This block's own parameters (not its children's), keyed by the
        block's prefix and the attribute name (the v1.x surface)."""
        out = ParameterDict(self._prefix, shared=self._shared_params)
        for attr, t in self._parameters.items():
            if t is not None:
                out[self._prefix + attr] = param_handle(self, attr)
        return out

    def _all_slots(self):
        """``(structural name, handle)`` of every parameter slot of the
        tree, a slot that shares another's parameter included (the
        reference's ``_iter_params``)."""
        for name, owner, attr in param_slots(self, shared=True):
            yield name, param_handle(owner, attr)

    def share_parameters(self, shared) -> "Block":
        """Make the slots named in ``shared`` (structural name ->
        :class:`~.parameter.Parameter`, or a ``ParameterDict``) hold those
        parameters, as the reference's 2.x ``share_parameters`` grafts
        them; a name with no slot here is ignored."""
        slots = {name: (owner, attr)
                 for name, owner, attr in param_slots(self, shared=True)}
        for name, param in shared.items():
            if name not in slots:
                continue
            owner, attr = slots[name]
            if (owner, attr) in param._slots():
                continue
            setattr(owner, attr, param._tensor())
            owner.__dict__.setdefault("_gluon_params", {})[attr] = param
            param._aliases.append((owner, attr))
            pending = owner.__dict__.setdefault("_pending", set())
            pending.discard(attr)
            if param._deferred is not None:
                pending.add(attr)
        return self

    def save_parameters(self, filename: str,
                        deduplicate: bool = False) -> None:
        """Write every parameter (the mean of its copies) to ``filename``
        by structural name in ``nd.save``'s format, the reference's
        ``.params`` file; with ``deduplicate`` a parameter that several
        slots share is written once, under its first name."""
        from ..ndarray.serialize import save
        arg, seen = OrderedDict(), set()
        for name, p in self._all_slots():
            if deduplicate and id(p) in seen:
                continue
            seen.add(id(p))
            arg[name] = p._reduce()
        save(filename, arg)

    def load_parameters(self, filename: str, ctx: DeviceLike = None,
                        allow_missing: bool = False,
                        ignore_extra: bool = False, cast_dtype: bool = False,
                        dtype_source: str = "current") -> "Block":
        """Copy a :meth:`save_parameters` (or ``nd.save``) file's arrays
        into the parameters of the same structural names (``arg:`` /
        ``aux:`` dropped), into every copy.  A parameter not initialised
        yet is initialised on ``ctx`` (default: the current context, the
        GPU unless the caller says otherwise) and takes its shape from the
        file.  A missing or extra name raises the reference's
        ``AssertionError`` unless ``allow_missing`` / ``ignore_extra``;
        ``cast_dtype`` with ``dtype_source`` 'current' casts the values to
        the parameters' dtypes, with 'saved' the parameters to the
        file's."""
        loaded = OrderedDict(
            (k[4:] if k.startswith(("arg:", "aux:")) else k, v)
            for k, v in load_host(filename).items())
        params = OrderedDict(self._all_slots())
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise AssertionError(
                        "Parameter %s is missing in %s. Set "
                        "allow_missing=True to ignore missing parameters"
                        % (name, filename))
        for name, value in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise AssertionError(
                        "Parameter %s loaded from %s is not present in the "
                        "Block. Set ignore_extra=True to ignore"
                        % (name, filename))
                continue
            assign(params[name], value, cast_dtype, dtype_source, init=True,
                   ctx=ctx)
        return self

    save_params = save_parameters       # the v1.x names
    load_params = load_parameters

    def summary(self, *inputs) -> None:
        """Print each block of the tree with its type and its own
        parameters' count, then the total (reference: ``Block.summary``;
        ``inputs`` are accepted and not run)."""
        rows = []
        for name, m in self.named_modules():
            depth = name.count(".") + 1 if name else 0
            label = name.rsplit(".", 1)[-1] if name else type(self).__name__
            n = sum(t.numel() for t in m._parameters.values()
                    if t is not None)
            rows.append(("  " * depth + label, type(m).__name__, n))
        total = sum(r[2] for r in rows)
        lines = ["%-40s %-20s %12s" % ("Layer", "Type", "Params"),
                 "-" * 74]
        lines += ["%-40s %-20s %12d" % r for r in rows]
        lines += ["-" * 74, "Total params: %d" % total]
        print("\n".join(lines))

    def zero_grad(self, set_to_none: bool = False) -> None:
        """Zero every parameter's gradient in place (gluon's
        ``zero_grad``, not ``torch.nn.Module``'s)."""
        self.collect_params().zero_grad()

    def setattr(self, name: str, value) -> None:
        """Set attribute ``name`` of every parameter (``grad_req``,
        ``lr_mult``, ...)."""
        self.collect_params().setattr(name, value)

    def infer_shape(self, *args) -> None:
        """Set the sizes of this block's own deferred parameters from its
        inputs; layers with deferred sizes override this."""
        raise DeferredInitializationError(
            "%s has parameters with unknown shape and does not implement "
            "infer_shape" % type(self).__name__)

    def _finish_deferred(self, args) -> None:
        """Infer this block's pending parameters' shapes from ``args`` and
        materialise them as ``initialize`` recorded, unrecorded."""
        self.infer_shape(*args)
        with torch.no_grad():
            for attr in [a for a in self._parameters if a in self._pending]:
                param_handle(self, attr)._finish_deferred_init()

    def cast(self, dtype) -> "Block":
        """Cast every floating-point parameter (every copy) to
        ``dtype``."""
        self.to(dtype=to_dtype(dtype))
        for p in self.collect_params().values():
            if p._copies and p._tensor().is_floating_point():
                p._cast_copies(to_dtype(dtype))
        return self

    def hybridize(self, active: bool = True, **kwargs) -> None:
        """No-op: PyTorch runs eagerly; CUDA graphs are a later change."""

    def __call__(self, *args, **kwargs):
        if self.__dict__.get("_pending"):
            self._finish_deferred(_unwrap(args))
            outer = getattr(_CALL, "ctx", None)
            own = None if outer is None else \
                ctx_copies(self, outer, recurse=False)
            if own is not None and not any(
                    _has_ndarray(a) for a in args + tuple(kwargs.values())):
                # materialised inside a call on another context's copies
                return torch.func.functional_call(self, own, tuple(args),
                                                  kwargs, strict=False)
        if not any(_has_ndarray(a) for a in args + tuple(kwargs.values())):
            return super().__call__(*args, **kwargs)
        ctx = _first_ctx(args + tuple(kwargs.values()))
        copies = ctx_copies(self, ctx)
        args = _unwrap(args)
        kwargs = {k: _unwrap(v) for k, v in kwargs.items()}
        modes = [(m, m.training, getattr(m, "_write_aux", False))
                 for m in self.modules()]
        self.train(autograd.is_training())
        for m, _, _ in modes:
            m._write_aux = True
        outer = getattr(_CALL, "ctx", None)
        _CALL.ctx = ctx
        try:
            with (torch.enable_grad() if autograd.is_recording()
                  else torch.no_grad()):
                if copies is None:
                    out = super().__call__(*args, **kwargs)
                else:
                    out = torch.func.functional_call(
                        self, copies, tuple(args), kwargs, strict=False)
        finally:
            _CALL.ctx = outer
            for m, mode, write in modes:
                m.training = mode
                m._write_aux = write
        return _wrap(out, ctx)


def _has_ndarray(a) -> bool:
    if isinstance(a, (tuple, list)):
        return any(_has_ndarray(x) for x in a)
    return isinstance(a, NDArray)


def _first_ctx(args) -> Optional[Context]:
    """The context of the first NDArray among ``args`` (also inside
    tuples and lists)."""
    for a in args:
        if isinstance(a, NDArray):
            return a.context
        if isinstance(a, (tuple, list)):
            c = _first_ctx(a)
            if c is not None:
                return c
    return None


def _unwrap(a):
    """An input's NDArrays (alone, or in nested tuples or lists, such as
    a recurrent layer's states) as their tensors."""
    if isinstance(a, NDArray):
        return a.data
    if isinstance(a, (tuple, list)):
        return type(a)(_unwrap(x) for x in a)
    return a


def _wrap(out, ctx=None):
    """A forward's tensors (alone, or in a tuple or list) as NDArrays of
    ``ctx``."""
    if isinstance(out, torch.Tensor):
        return NDArray(out, ctx)
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap(o, ctx) for o in out)
    return out


class HybridBlock(Block):
    """Gluon ``HybridBlock``; see :meth:`Block.hybridize`."""

    def __init__(self, prefix: Optional[str] = None, params=None):
        # its own signature, so that an unknown keyword raises the
        # reference's TypeError ("HybridBlock.__init__() got an ...")
        super().__init__(prefix, params)


def functionalize(block: torch.nn.Module
                  ) -> Tuple[Callable, "OrderedDict[str, torch.Tensor]"]:
    """Lift a block into ``(pure_fn, params)``.

    ``params`` holds the block's parameter tensors (detached) by structural
    name.  ``pure_fn(params, *inputs, training=False)`` runs the block's
    forward with the given tensors in place of its parameters
    (``torch.func.functional_call``; every name must be given) and in
    training or inference mode as asked, restoring the block's own modes
    afterwards.  Parameters must be materialised (``initialize`` or
    ``load_dict``, and a first call for deferred sizes) first."""
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
