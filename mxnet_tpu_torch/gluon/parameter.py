"""Gluon ``Parameter``, ``Constant`` and ``ParameterDict``.

Counterpart of ``mxnet_tpu/gluon/parameter.py`` (reference:
python/mxnet/gluon/parameter.py).  What differs, and why:

* A port block keeps its weights as ``torch.nn.Parameter`` attributes
  (``block.weight``), the form ``torch.nn.Module``, ``functionalize``,
  ``TrainStep`` and the serving path read.  A gluon :class:`Parameter`
  cannot subclass ``torch.nn.Parameter`` (a tensor's ``data`` is an
  attribute, gluon's ``data()`` a method), so it is a handle to a slot:
  the owning module and the attribute name.  ``data()``, ``grad()``,
  ``set_data()`` and ``zero_grad()`` reach the tensor that sits in the
  slot when they are called, so a handle survives ``initialize``,
  ``load_dict``, ``cast`` and deferred materialisation replacing it.
  ``Block.collect_params`` gives one handle per slot and keeps it on the
  owner, so ``lr_mult``, ``wd_mult`` and ``init`` set on a handle stay.
* A free ``Parameter('w', shape=...)`` (and :class:`Constant`) owns a
  one-slot holder module.
* A slot with an unknown size holds a placeholder on PyTorch's ``meta``
  device with 0 in each unknown dimension (the reference's convention).
  ``initialize`` on such a parameter records ``(init, device,
  generator)`` and the owning block's first call infers the shape and
  materialises it (``Block.__call__``); until then ``data()`` raises
  :class:`DeferredInitializationError`.
* ``data()`` is an ``NDArray`` over the live tensor (shared storage).
  ``grad()`` reads the tensor's ``.grad`` when called: ``autograd.backward``
  puts a new tensor there on every ``'write'`` pass.  Initialising a
  parameter whose ``grad_req`` is not ``'null'`` gives it a zero
  gradient, as the reference's ``_init_grad`` does; ``grad()`` makes one
  for a parameter loaded without it (``load_dict``).
* ``grad_req`` lives on the tensor (its ``grad_req`` attribute and
  ``requires_grad``), where ``autograd.backward`` reads it.
* A copy on each of several contexts (``initialize(ctx=[c0, c1])``, the
  reference's ``_data`` dict): the slot holds the first context's copy,
  so ``functionalize``, ``TrainStep``, ``state_dict`` and the serving
  path read what they read with one context, and the handle keeps the
  other contexts' copies (``torch.nn.Parameter`` tensors of their own,
  each with its ``.grad``).  ``data(ctx)``/``grad(ctx)`` pick a copy by
  the reference's ``_check_and_get`` rules, ``list_*`` give them all, and
  ``set_data``, ``zero_grad``, ``cast`` and ``reset_ctx`` act on every
  one.  A block called on NDArrays of a context runs on that context's
  copies (``Block.__call__``).
* ``ParameterDict.save``/``load`` and ``Block.save_parameters`` /
  ``load_parameters`` write and read ``nd.save``'s file (the reference's
  byte format); a parameter with copies is saved as their mean
  (:meth:`Parameter._reduce`) and loaded into every copy.
* ``Block.share_parameters`` makes two slots hold one parameter: the
  handle keeps the other slots (``_aliases``) and puts every new tensor in
  all of them.
"""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import initializer as init_mod
from ..base import MXNetError, dtype_name, torch_dtype
from ..device import (Context, DeviceLike, as_context, cpu, current_context,
                      resolve)
from ..ndarray.ndarray import NDArray

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict", "meta_parameter", "param_handle", "set_inits",
           "param_slots", "collect", "context_list", "ctx_copies"]

_GRAD_REQS = ("write", "add", "null")


class DeferredInitializationError(MXNetError):
    """A parameter was used before its deferred shape was known."""


def meta_parameter(shape, dtype="float32",
                   requires_grad: bool = True) -> torch.nn.Parameter:
    """A parameter with shape and dtype but no storage yet; a 0 in
    ``shape`` is a size to infer at the first forward."""
    return torch.nn.Parameter(
        torch.empty(tuple(int(d) for d in shape), dtype=torch_dtype(dtype),
                    device="meta"), requires_grad=requires_grad)


def _complete(shape) -> bool:
    return all(int(d) > 0 for d in shape)


def param_slots(module: torch.nn.Module, shared: bool = False):
    """``(structural name, owner, attribute)`` of every parameter of
    ``module``'s tree, in ``named_parameters()`` order: a tensor held by
    two slots counts once, or under each slot's name with ``shared`` (the
    reference's walk, which ``save_parameters`` and ``share_parameters``
    take)."""
    seen = set()
    for prefix, owner in module.named_modules(remove_duplicate=not shared):
        for attr, t in owner._parameters.items():
            if t is None or (id(t) in seen and not shared):
                continue
            seen.add(id(t))
            yield (prefix + "." + attr if prefix else attr), owner, attr


def param_handle(owner: torch.nn.Module, attr: str) -> "Parameter":
    """The one :class:`Parameter` handle of ``owner``'s slot ``attr``."""
    handles = owner.__dict__.setdefault("_gluon_params", {})
    p = handles.get(attr)
    if p is None:
        p = Parameter.__new__(Parameter)
        p._setup(owner, attr, attr, lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=True)
        handles[attr] = p
    return p


def set_inits(owner: torch.nn.Module, **inits) -> None:
    """Give each of ``owner``'s slots named in ``inits`` that holds a
    parameter its own initializer (an ``Initializer``, a name such as
    'zeros', or None for the caller's default), as a layer's
    ``*_initializer`` keyword does."""
    for attr, init in inits.items():
        if owner._parameters.get(attr) is not None:
            param_handle(owner, attr).init = init


class _Holder(torch.nn.Module):
    """The owner of a free parameter's one slot, ``value``."""


def _param_census_tensors(p) -> List[torch.Tensor]:
    """One parameter's tensors for the buffer census: read through the
    slot (a parameter is a handle), every context's copy and its
    gradient."""
    try:
        tensors = list(p._tensors().values())
    except (AttributeError, KeyError):
        return []
    out = []
    for t in tensors:
        out.append(t)
        if t.grad is not None:
            out.append(t.grad)
    return out


class Parameter:
    """A weight, bias or state of a block (reference: gluon.Parameter).

    ``Parameter(name, grad_req, shape, dtype, lr_mult, wd_mult, init,
    allow_deferred_init, differentiable)`` makes a free parameter; a
    block's own parameters come from ``Block.collect_params``.  A 0 (or
    None) in ``shape`` is a size to infer."""

    def __init__(self, name: Optional[str] = None, grad_req: str = "write",
                 shape=None, dtype="float32", lr_mult: float = 1.0,
                 wd_mult: float = 1.0, init=None,
                 allow_deferred_init: bool = False,
                 differentiable: bool = True, stype: str = "default",
                 grad_stype: str = "default"):
        if stype != "default" or grad_stype != "default":
            raise MXNetError("Parameter: sparse storage is not ported "
                             "(stype=%r, grad_stype=%r)"
                             % (stype, grad_stype))
        if isinstance(shape, int):
            shape = (shape,)
        shape = tuple(0 if d is None or int(d) < 0 else int(d)
                      for d in (shape or ()))
        if not differentiable:
            grad_req = "null"
        holder = _Holder()
        holder.value = meta_parameter(shape, dtype)
        self._setup(holder, "value", name or "param", lr_mult=lr_mult,
                    wd_mult=wd_mult, init=init,
                    allow_deferred_init=allow_deferred_init)
        self.grad_req = grad_req

    def _setup(self, owner, attr, name, *, lr_mult, wd_mult, init,
               allow_deferred_init):
        self._owner = owner
        self._attr = attr
        self._name = name
        self._structural_name = None
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        #: (init, contexts, generator) recorded by initialize() for a
        #: shape still unknown
        self._deferred: Optional[Tuple] = None
        #: the contexts of the copies, the slot's first (None: the slot's
        #: device's), and the copies of the contexts after the first
        self._ctxs: Optional[List[Context]] = None
        self._copies: "OrderedDict[Context, torch.nn.Parameter]" = \
            OrderedDict()
        #: other (owner, attribute) slots that share this parameter
        #: (``Block.share_parameters``): they hold the same tensor
        self._aliases: List[Tuple[torch.nn.Module, str]] = []
        # the buffer census: the slot's tensor and every copy, with their
        # gradients, under the "params" owner
        from .. import programs as _programs
        _programs.track_buffers("params", self, _param_census_tensors)

    # -- the slot ----------------------------------------------------------
    def _tensor(self) -> torch.nn.Parameter:
        return self._owner._parameters[self._attr]

    def _replace(self, new: torch.Tensor) -> torch.nn.Parameter:
        """Put ``new`` in the slot as a parameter carrying the old one's
        ``grad_req``; returns it."""
        param = self._leaf(new)
        for owner, attr in self._slots():
            setattr(owner, attr, param)
        return param

    def _slots(self) -> List[Tuple[torch.nn.Module, str]]:
        """The slot and every slot that shares it."""
        return [(self._owner, self._attr)] + self._aliases

    def _leaf(self, value: torch.Tensor) -> torch.nn.Parameter:
        """``value`` as a parameter tensor carrying this one's
        ``grad_req``."""
        req = self.grad_req
        param = torch.nn.Parameter(value, requires_grad=req != "null")
        param.grad_req = req
        return param

    def _contexts(self) -> List[Context]:
        """The contexts of the copies, the slot's first: the recorded ones
        while the slot lies on the first, else the slot's device's."""
        t = self._tensor()
        if self._ctxs and self._ctxs[0].holds(t.device):
            return list(self._ctxs)
        return [Context.from_torch(t.device)]

    def _tensors(self) -> "OrderedDict[Context, torch.nn.Parameter]":
        """Every copy by context, the slot first."""
        ctxs = self._contexts()
        out = OrderedDict([(ctxs[0], self._tensor())])
        for c in ctxs[1:]:
            out[c] = self._copies[c]
        return out

    def _spread(self, ctxs: List[Context]) -> None:
        """Record ``ctxs`` and make each later context's copy from the
        slot's value (with a zero gradient unless ``grad_req`` is
        'null')."""
        t = self._tensor()
        self._ctxs = list(ctxs)
        self._copies = OrderedDict()
        with torch.no_grad():
            for c in ctxs[1:]:
                cp = self._leaf(t.detach().to(resolve(c), copy=True))
                if self.grad_req != "null":
                    cp.grad = torch.zeros_like(cp)
                self._copies[c] = cp

    def _set_pending(self, record) -> None:
        self._deferred = record
        for owner, attr in self._slots():
            pending = owner.__dict__.setdefault("_pending", set())
            if record is None:
                pending.discard(attr)
            else:
                pending.add(attr)

    # -- identity ----------------------------------------------------------
    @property
    def name(self) -> str:
        return self._structural_name or self._name

    @name.setter
    def name(self, value):
        self._name = value

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                      self.dtype)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._tensor().shape)

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(int(d) for d in new_shape)
        old = self.shape
        if len(old) != len(new_shape) or any(
                o not in (0, n) for o, n in zip(old, new_shape)):
            raise AssertionError(
                "Expected shape %s is incompatible with given shape %s for "
                "Parameter %s" % (new_shape, old, self.name))
        if new_shape != old:
            t = self._tensor()
            self._replace(torch.empty(new_shape, dtype=t.dtype,
                                      device="meta"))

    @property
    def dtype(self):
        t = self._tensor()
        if t.dtype == torch.bfloat16:
            return "bfloat16"
        return np.dtype(dtype_name(t.dtype))

    @property
    def grad_req(self) -> str:
        t = self._tensor()
        return getattr(t, "grad_req", "write" if t.requires_grad else "null")

    @grad_req.setter
    def grad_req(self, req: str):
        if req not in _GRAD_REQS:
            raise ValueError("grad_req must be 'write', 'add' or 'null', "
                             "got %r" % (req,))
        for t in [self._tensor()] + list(
                getattr(self, "_copies", {}).values()):
            t.requires_grad_(req != "null")
            t.grad_req = req
            if req == "null":
                t.grad = None
            elif not t.is_meta and t.grad is None:
                t.grad = torch.zeros_like(t)

    @property
    def stype(self) -> str:
        return "default"

    # -- initialisation ----------------------------------------------------
    def initialize(self, init=None, ctx: DeviceLike = None,
                   default_init=None, force_reinit: bool = False, *,
                   device: DeviceLike = None,
                   generator: Optional[torch.Generator] = None,
                   seed: int = 0) -> None:
        """Materialise on ``device`` (or ``ctx``: a context or a list of
        them, one copy each; default: the GPU) and fill with ``init``, else
        this parameter's own ``init``, else ``default_init`` (default
        :class:`~...initializer.Uniform`), drawing from ``generator``
        (default: a new one on the first context's device seeded with
        ``seed``); every copy holds the first's value.  An initialised
        parameter is left as it is unless ``force_reinit``; one whose shape
        is not known yet records the request for its block's first forward
        when ``allow_deferred_init`` and raises otherwise."""
        if not self._tensor().is_meta and not force_reinit:
            return
        ctxs = context_list(ctx if device is None else device)
        if init is None:
            init = self.init if self.init is not None else default_init
        if generator is None:
            generator = torch.Generator(
                device=resolve(ctxs[0])).manual_seed(int(seed))
        if not _complete(self.shape):
            if not self.allow_deferred_init:
                raise ValueError(
                    "Cannot initialize Parameter %s because it has invalid "
                    "shape %s and deferred init is not allowed"
                    % (self.name, self.shape))
            self._set_pending((init, ctxs, generator))
            return
        self._init_impl(init, ctxs, generator)

    def _init_impl(self, init, ctxs: List[Context],
                   generator: torch.Generator) -> None:
        t = self._tensor()
        with torch.no_grad():
            new = self._replace(torch.empty(t.shape, dtype=t.dtype,
                                            device=resolve(ctxs[0])))
            # the reference's name rule, a parameter's own init included
            init_mod.create(init)(self.name, new.data, generator)
            if self.grad_req != "null":
                new.grad = torch.zeros_like(new)
        self._spread(ctxs)
        self._set_pending(None)

    def _finish_deferred_init(self) -> None:
        """Materialise a parameter whose shape is now known with the
        recorded ``(init, contexts, generator)``."""
        if self._deferred is None:
            raise DeferredInitializationError(
                "Parameter %s was not initialized" % self.name)
        if not _complete(self.shape):
            raise DeferredInitializationError(
                "Parameter %s has unknown shape %s; run a forward pass "
                "first" % (self.name, self.shape))
        self._init_impl(*self._deferred)

    def _check_initialized(self) -> torch.nn.Parameter:
        t = self._tensor()
        if t.is_meta:
            if self._deferred is not None:
                raise DeferredInitializationError(
                    "Parameter %s has not been initialized yet because its "
                    "shape is unknown; run a forward pass first" % self.name)
            raise RuntimeError(
                "Parameter %s has not been initialized. You should "
                "initialize parameters with Block.initialize() before use"
                % self.name)
        return t

    # -- access ------------------------------------------------------------
    def _check_and_get(self, arrays, ctx):
        """The reference's rules: ``ctx`` None takes the only copy, or the
        current context's among several; a context without a copy
        raises."""
        if ctx is None:
            if len(arrays) == 1:
                return next(iter(arrays.items()))
            ctx = current_context()
        ctx = as_context(ctx)
        if ctx in arrays:
            return ctx, arrays[ctx]
        raise RuntimeError("Parameter %s was not initialized on context %s "
                           "(it lives on %s)"
                           % (self.name, ctx, list(arrays)))

    def data(self, ctx: Optional[Context] = None) -> NDArray:
        """The value of ``ctx``'s copy, as an NDArray sharing its storage."""
        self._check_initialized()
        c, t = self._check_and_get(self._tensors(), ctx)
        return NDArray(t, c)

    def list_data(self) -> List[NDArray]:
        """Every copy's value, the first context's first."""
        self._check_initialized()
        return [NDArray(t, c) for c, t in self._tensors().items()]

    def _grads(self) -> "OrderedDict[Context, torch.Tensor]":
        self._check_initialized()
        if self.grad_req == "null":
            raise RuntimeError("Cannot get gradient array for Parameter %s "
                               "because grad_req='null'" % self.name)
        out = OrderedDict()
        for c, t in self._tensors().items():
            if t.grad is None:
                t.grad = torch.zeros_like(t)
            out[c] = t.grad
        return out

    def grad(self, ctx: Optional[Context] = None) -> NDArray:
        """The gradient the last ``backward`` wrote into ``ctx``'s copy
        (zeros before any)."""
        c, g = self._check_and_get(self._grads(), ctx)
        return NDArray(g, c)

    def list_grad(self) -> List[NDArray]:
        return [NDArray(g, c) for c, g in self._grads().items()]

    def list_ctx(self) -> List[Context]:
        t = self._tensor()
        if t.is_meta:
            if self._deferred is not None:
                return list(self._deferred[1])
            raise RuntimeError("Parameter %s has not been initialized"
                               % self.name)
        return self._contexts()

    def set_data(self, data) -> None:
        """Copy ``data`` (an NDArray, tensor or array) into every copy; a
        parameter waiting for its shape takes ``data``'s and is
        materialised on its recorded contexts."""
        src = data.data if isinstance(data, NDArray) else \
            torch.as_tensor(np.asarray(data)) \
            if not isinstance(data, torch.Tensor) else data
        self.shape = src.shape
        if self._tensor().is_meta:
            if self._deferred is None:
                raise RuntimeError("initialize Parameter %s first"
                                   % self.name)
            self._init_impl(init_mod.Zero(), *self._deferred[1:])
        with torch.no_grad():
            for t in self._tensors().values():
                t.copy_(src)

    def zero_grad(self) -> None:
        if self.grad_req == "null" or self._tensor().is_meta:
            return
        with torch.no_grad():
            for t in self._tensors().values():
                if t.grad is not None:
                    t.grad.zero_()

    def reset_ctx(self, ctx) -> None:
        """Move the value (or the deferred request) to ``ctx``, a context
        or a list of them: one copy each, of the first copy's value."""
        ctxs = context_list(ctx)
        t = self._tensor()
        if not t.is_meta:
            with torch.no_grad():
                new = self._replace(t.detach().to(resolve(ctxs[0]),
                                                  copy=True))
                if self.grad_req != "null":
                    new.grad = torch.zeros_like(new)
            self._spread(ctxs)
        elif self._deferred is not None:
            init, _, _ = self._deferred
            self._set_pending((init, ctxs,
                               torch.Generator(device=resolve(ctxs[0]))))
        else:
            raise ValueError("Cannot reset context for uninitialized "
                             "Parameter %s" % self.name)

    def cast(self, dtype) -> None:
        """Cast every copy (and give each a zero gradient of the new
        dtype)."""
        with torch.no_grad():
            new = self._replace(self._tensor().detach().to(
                torch_dtype(dtype)))
            if not new.is_meta and self.grad_req != "null":
                new.grad = torch.zeros_like(new)
        self._cast_copies(dtype)

    def _reduce(self) -> NDArray:
        """The mean of every copy's value, taken in float64 and cast back
        to this parameter's dtype, on the CPU (reference:
        ``Parameter._reduce``; what ``save_parameters`` writes)."""
        self._check_initialized()
        tensors = list(self._tensors().values())
        if len(tensors) == 1:
            # the mean of one value is that value
            return NDArray(tensors[0].detach().to("cpu", copy=True), cpu())
        values = [t.detach().to("cpu", torch.float64) for t in tensors]
        out = values[0].clone()
        for v in values[1:]:
            out += v
        out /= len(values)
        return NDArray(out.to(self._tensor().dtype), cpu())

    def _cast_copies(self, dtype) -> None:
        """Cast the copies after the first, each its own value (a
        BatchNorm's copies hold statistics of their own)."""
        for c in self._contexts()[1:]:
            with torch.no_grad():
                cp = self._leaf(self._copies[c].detach().to(
                    torch_dtype(dtype)))
                if self.grad_req != "null":
                    cp.grad = torch.zeros_like(cp)
            self._copies[c] = cp


def context_list(ctx) -> List[Context]:
    """``ctx`` (a device, a context, None for the current one, or a list
    of them) as a list of distinct contexts, in order; an empty list
    raises."""
    ctxs = list(ctx) if isinstance(ctx, (list, tuple)) else [ctx]
    if not ctxs:
        raise MXNetError("no context given")
    return list(OrderedDict.fromkeys(as_context(c) for c in ctxs))


def ctx_copies(module: torch.nn.Module, ctx: Context, recurse: bool = True
               ) -> Optional[Dict[str, torch.Tensor]]:
    """``{structural name: ctx's copy}`` of every parameter of
    ``module``'s tree (``recurse`` False: its own) that has copies and
    whose first context is not ``ctx``, for ``functional_call`` (None when
    there is none); a parameter with copies but none on ``ctx`` raises,
    as :meth:`Parameter.data` does."""
    out = {}
    for prefix, m in (module.named_modules() if recurse
                      else [("", module)]):
        handles = m.__dict__.get("_gluon_params")
        if not handles:
            continue
        for attr, h in handles.items():
            if not h._copies or m._parameters.get(attr) is None:
                continue
            tensors = h._tensors()
            if len(tensors) < 2 or next(iter(tensors)) == ctx:
                continue
            out[(prefix + "." if prefix else "") + attr] = \
                h._check_and_get(tensors, ctx)[1]
    return out or None


class Constant(Parameter):
    """A value that is not trained (reference: gluon.Constant)."""

    def __init__(self, value, name: Optional[str] = None):
        if isinstance(value, NDArray):
            value = value.asnumpy()
        value = np.asarray(value)
        self.value = value
        super().__init__(name=name, grad_req="null", shape=value.shape,
                         dtype=value.dtype,
                         init=init_mod.Constant(value))


class ParameterDict:
    """Ordered name -> :class:`Parameter` mapping (reference:
    gluon.ParameterDict): the mapping protocol, ``get``, ``update``, the
    bulk ``initialize``, ``zero_grad``, ``reset_ctx`` and ``setattr``, and
    ``save`` / ``load``."""

    def __init__(self, prefix: str = "", shared=None):
        self._prefix = prefix
        self._params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._shared = shared

    def __getitem__(self, key) -> Parameter:
        return self._params[key]

    def __setitem__(self, key, value):
        self._params[key] = value

    def __contains__(self, key):
        return key in self._params

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __repr__(self):
        body = "\n".join("  %s" % p for p in self._params.values())
        return "ParameterDict(\n%s\n)" % body

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self) -> str:
        return self._prefix

    def get(self, name: str, **kwargs) -> Parameter:
        """The parameter ``prefix + name``, made (free, with ``kwargs``) if
        missing; a given ``shape`` fills in unknown sizes."""
        full = self._prefix + name
        if full in self._params:
            param = self._params[full]
            if kwargs.get("shape") is not None:
                param.shape = kwargs["shape"]
            return param
        if self._shared is not None and full in self._shared:
            self._params[full] = self._shared[full]
            return self._params[full]
        param = Parameter(full, **kwargs)
        self._params[full] = param
        return param

    def update(self, other) -> None:
        if isinstance(other, ParameterDict):
            other = other._params
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError("Cannot update: duplicate Parameter name %s"
                                 % k)
            self._params[k] = v

    def initialize(self, init=None, ctx: DeviceLike = None,
                   verbose: bool = False, force_reinit: bool = False, *,
                   device: DeviceLike = None,
                   generator: Optional[torch.Generator] = None,
                   seed: int = 0) -> None:
        """Initialise every parameter on ``device`` (or ``ctx``: a context
        or a list of them, a copy on each) with ``init`` (default
        :class:`~...initializer.Uniform`) where it has no initializer of
        its own, in order, all drawing from one ``generator`` (default: a
        new one on the first context's device seeded with ``seed``)."""
        ctxs = context_list(ctx if device is None else device)
        default = init_mod.create(init)
        if generator is None:
            generator = torch.Generator(
                device=resolve(ctxs[0])).manual_seed(int(seed))
        for param in self._params.values():
            param.initialize(None, device=ctxs, default_init=default,
                             force_reinit=force_reinit, generator=generator)

    def zero_grad(self) -> None:
        for p in self._params.values():
            p.zero_grad()

    def reset_ctx(self, ctx) -> None:
        for p in self._params.values():
            p.reset_ctx(ctx)

    def setattr(self, name: str, value) -> None:
        for p in self._params.values():
            setattr(p, name, value)

    def save(self, filename: str, strip_prefix: str = "") -> None:
        """Write every parameter's value (the mean of its copies,
        :meth:`Parameter._reduce`) to ``filename`` in ``nd.save``'s format,
        keyed by ``Parameter.name`` less ``strip_prefix``."""
        from ..ndarray.serialize import save
        arg = OrderedDict()
        for p in self._params.values():
            name = p.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg[name] = p._reduce()
        save(filename, arg)

    def load(self, filename: str, ctx: DeviceLike = None,
             allow_missing: bool = False, ignore_extra: bool = False,
             restore_prefix: str = "", cast_dtype: bool = False,
             dtype_source: str = "current") -> None:
        """Copy a :meth:`save` (or ``nd.save``) file's arrays into the
        parameters of the same names (``restore_prefix`` put before each
        file name, ``arg:`` / ``aux:`` dropped), into every copy.  A
        parameter not initialised yet is initialised on ``ctx`` first when
        ``ctx`` is given."""
        loaded = OrderedDict(
            (restore_prefix + (k[4:] if k.startswith(("arg:", "aux:"))
                               else k), v)
            for k, v in load_host(filename).items())
        if not allow_missing:
            for name in self.keys():
                if name not in loaded:
                    raise AssertionError(
                        "Parameter %s is missing in file %s"
                        % (name, filename))
        for name, value in loaded.items():
            if name not in self._params:
                if not ignore_extra:
                    raise AssertionError(
                        "Parameter %s loaded from %s is not present in "
                        "this ParameterDict" % (name, filename))
                continue
            assign(self._params[name], value, cast_dtype, dtype_source,
                   init=ctx is not None, ctx=ctx)


def load_host(filename: str) -> "OrderedDict[str, NDArray]":
    """A parameter file's arrays by name, on the CPU (a file of a bare
    list has no names and raises)."""
    from ..ndarray.serialize import load
    with cpu():
        loaded = load(filename)
    if not isinstance(loaded, dict):
        raise MXNetError("%s holds a list of %d arrays without names, not "
                         "parameters" % (filename, len(loaded)))
    return OrderedDict(loaded)


def assign(param: Parameter, value: NDArray, cast_dtype: bool,
           dtype_source: str, init: bool, ctx: DeviceLike = None) -> None:
    """Copy a loaded ``value`` into every copy of ``param``, as the
    reference's loaders do: under ``cast_dtype`` the parameter takes the
    saved dtype (``dtype_source='saved'``) or the value takes the
    parameter's; a parameter never initialised is first initialised on
    ``ctx`` when ``init``, and one whose shape is unknown takes the
    value's."""
    if cast_dtype:
        if dtype_source == "saved":
            param.cast(value.dtype)
        else:
            value = value.astype(param.dtype)
    if init and param._tensor().is_meta and param._deferred is None:
        param.initialize(init_mod.Zero(), ctx=ctx)
    param.set_data(value)


def collect(module: torch.nn.Module,
            select: Optional[str] = None) -> ParameterDict:
    """Every slot of ``module``'s tree as a :class:`Parameter` by structural
    name (``select``: a regular expression the name must match)."""
    pattern = re.compile(select) if select else None
    out = ParameterDict()
    for name, owner, attr in param_slots(module):
        if pattern is not None and not pattern.search(name):
            continue
        p = param_handle(owner, attr)
        p._structural_name = name
        out[name] = p
    return out

