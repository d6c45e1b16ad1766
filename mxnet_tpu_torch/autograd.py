"""Imperative autograd, mapped onto torch autograd.

Counterpart of ``mxnet_tpu/autograd.py`` (reference:
python/mxnet/autograd.py).  The reference keeps a tape of its own (one
``jax.vjp`` closure per recorded op); here torch autograd is the tape:

* :func:`record` / :func:`pause` / :func:`train_mode` / :func:`predict_mode`
  set this thread's recording and training flags.  ``ndarray.invoke`` runs a
  differentiable op under ``torch.enable_grad()`` while recording and under
  ``torch.no_grad()`` otherwise, so only what runs inside ``record()``
  carries a graph.  Gluon blocks read :func:`is_training` for their mode.
* :func:`backward` finds the leaves that the heads depend on by walking
  the graph to its ``AccumulateGrad`` nodes, asks ``torch.autograd.grad``
  for exactly those, and writes each by its ``grad_req`` (a recorded head
  that reaches no leaf, such as the sum of ``nd.topk``'s values, writes
  nothing; a head computed outside ``record()`` raises): 'write'
  overwrites (torch's own ``.backward()`` would add), 'add' accumulates,
  'null' gets nothing (reference ``_write_leaf``).  A leaf attached with
  ``NDArray.attach_grad`` keeps its buffer and request on its tensor
  (``_mx_grad``, ``grad_req``); any other leaf (a block's parameter) is
  written to its ``.grad`` with its ``grad_req`` attribute, 'write' by
  default as in gluon.  Leaves the heads do not reach keep their gradient.
  Heads on several contexts (one per copy of a block whose parameters
  have a copy on each, :mod:`.gluon.parameter`) go through one call: each
  copy is a leaf of its own, so its gradient lands on it, and a copy no
  head reaches keeps its gradient.
  A 'write' leaf with post-accumulate-grad hooks (a ``gluon.Trainer``
  whose exchange overlaps backward hooks its parameters) is written the
  moment torch has its gradient, while the rest of the backward runs, and
  then its hooks run, as torch's own ``backward()`` runs them (the
  reference fires its ``_grad_hook`` the same way).
* :func:`grad` returns gradients without writing them; ``create_graph``
  makes them differentiable (higher-order gradients).
* :class:`Function` is a ``torch.autograd.Function`` underneath.
"""
from __future__ import annotations

import functools
import threading
from typing import List, Optional

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward",
           "grad", "mark_variables", "Function"]

_state = threading.local()

#: the tensor attribute that ``ndarray.invoke`` sets on the outputs of a
#: differentiable op run while recording
RECORDED = "_mx_recorded"


def is_recording() -> bool:
    return getattr(_state, "recording", False)


def is_training() -> bool:
    return getattr(_state, "training", False)


def set_recording(flag: bool) -> bool:
    old = is_recording()
    _state.recording = bool(flag)
    return old


def set_training(flag: bool) -> bool:
    old = is_training()
    _state.training = bool(flag)
    return old


class _Scope:
    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._rec = recording
        self._train = training
        self._old = None

    def __enter__(self):
        self._old = (is_recording(), is_training())
        if self._rec is not None:
            set_recording(self._rec)
        if self._train is not None:
            set_training(self._train)
        return self

    def __exit__(self, *exc):
        set_recording(self._old[0])
        set_training(self._old[1])
        return False


def record(train_mode: bool = True) -> _Scope:
    return _Scope(True, train_mode)


def pause(train_mode: bool = False) -> _Scope:
    return _Scope(False, train_mode)


def train_mode() -> _Scope:
    return _Scope(None, True)


def predict_mode() -> _Scope:
    return _Scope(None, False)


def mark_variables(variables, gradients, grad_reqs="write") -> None:
    """Make ``variables`` leaves whose gradients go into ``gradients``
    (reference: autograd.mark_variables)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v.attach_grad(req)
        v._data._mx_grad = g._data


def _tensors(xs) -> List[torch.Tensor]:
    from .ndarray.ndarray import NDArray
    if isinstance(xs, (NDArray, torch.Tensor)):
        xs = [xs]
    return [x._data if isinstance(x, NDArray) else x for x in xs]


def _head_grads(heads, head_grads):
    if head_grads is None:
        return [torch.ones_like(h) for h in heads]
    hgs = _tensors(head_grads)
    return [torch.ones_like(h) if g is None else g.to(h.dtype)
            for h, g in zip(heads, hgs)]


def _check_heads(heads) -> List[int]:
    """The positions of the heads that carry a graph.  A head computed
    outside ``record()`` raises, as in the reference; a recorded head that
    reached no leaf through a differentiable op (``nd.topk(x).sum()``, or
    ``nd.ones(2) * 3``) carries none, and the reference walks its tape to
    no leaf: such a head contributes nothing."""
    for h in heads:
        if not (h.requires_grad or getattr(h, RECORDED, False)):
            raise MXNetError("cannot differentiate a head that was not "
                             "computed while autograd was recording")
    return [i for i, h in enumerate(heads) if h.requires_grad]


def _leaves(heads) -> List[torch.Tensor]:
    """Every leaf tensor that requires a gradient and that the heads
    depend on, in the order the walk meets them."""
    out = [h for h in heads if h.grad_fn is None and h.requires_grad]
    seen = set()
    stack = [h.grad_fn for h in heads if h.grad_fn is not None]
    while stack:
        fn = stack.pop()
        if fn in seen:
            continue
        seen.add(fn)
        leaf = getattr(fn, "variable", None)     # AccumulateGrad
        if leaf is not None:
            out.append(leaf)
        stack.extend(nf for nf, _ in fn.next_functions if nf is not None)
    return out


def _hooked(t: torch.Tensor) -> bool:
    """A 'write' parameter leaf with post-accumulate-grad hooks."""
    return bool(getattr(t, "_post_accumulate_grad_hooks", None)) and \
        getattr(t, "grad_req", "write") == "write" and \
        getattr(t, "_mx_grad", None) is None


def _write_hooked(t: torch.Tensor, g: torch.Tensor) -> None:
    """Write a hooked leaf's gradient as torch hands it over, then run
    the leaf's post-accumulate-grad hooks."""
    _write_leaf(t, g)
    for hook in list(t._post_accumulate_grad_hooks.values()):
        hook(t)


def _write_leaf(t: torch.Tensor, g: Optional[torch.Tensor]) -> None:
    if g is None:
        return
    req = getattr(t, "grad_req", "write")
    buf = getattr(t, "_mx_grad", None)
    with torch.no_grad():
        if buf is not None:             # an attach_grad variable
            if req == "add":
                buf.add_(g.to(buf.dtype))
            else:
                buf.copy_(g)
        elif req == "add" and t.grad is not None:
            t.grad.add_(g.to(t.grad.dtype))
        else:
            # a gradient may come back as a broadcast view (the gradient of
            # a sum): a .grad that a later 'add' writes into must own its
            # memory
            t.grad = g.to(t.dtype) if g.is_contiguous() \
                else g.to(t.dtype).contiguous()


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True) -> None:
    """Compute the gradients of ``heads`` (default head gradient: ones)
    with respect to every leaf they reach, and write them by each leaf's
    ``grad_req`` (the ``backward`` phase of the step's telemetry)."""
    from . import telemetry as _telemetry
    with _telemetry.phase("backward"):
        _backward(heads, head_grads, retain_graph)


def _backward(heads, head_grads, retain_graph) -> None:
    heads = _tensors(heads)
    live = _check_heads(heads)
    hgs = _head_grads(heads, head_grads)
    heads, hgs = [heads[i] for i in live], [hgs[i] for i in live]
    leaves = [t for t in _leaves(heads)
              if getattr(t, "grad_req", "write") != "null"]
    if not leaves:
        return
    hooked = [t for t in leaves if _hooked(t)]
    handles = [t.register_hook(functools.partial(_write_hooked, t))
               for t in hooked]
    try:
        grads = torch.autograd.grad(heads, leaves, hgs,
                                    retain_graph=retain_graph,
                                    allow_unused=True)
    finally:
        for h in handles:
            h.remove()
    written = {id(t) for t in hooked}
    for t, g in zip(leaves, grads):
        if id(t) not in written:
            _write_leaf(t, g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph: bool = False, train_mode: bool = True):
    """The gradients of ``heads`` with respect to ``variables`` (NDArrays),
    returned as NDArrays and not written anywhere.  With ``create_graph``
    they are themselves differentiable."""
    from .ndarray.ndarray import NDArray
    heads = _tensors(heads)
    _check_heads(heads)
    if retain_graph is None:
        retain_graph = create_graph
    try:
        got = torch.autograd.grad(heads, _tensors(variables),
                                  _head_grads(heads, head_grads),
                                  retain_graph=retain_graph,
                                  create_graph=create_graph)
    except RuntimeError as e:
        raise MXNetError("autograd.grad: %s (a variable does not require "
                         "gradient or is unreachable from the heads)"
                         % e) from e
    ctxs = [v.context if isinstance(v, NDArray) else None
            for v in (variables if isinstance(variables, (list, tuple))
                      else [variables])]
    return [NDArray(g, c) for g, c in zip(got, ctxs)]


class _FunctionBridge(torch.autograd.Function):
    """Runs a user :class:`Function`'s forward and backward, over NDArrays,
    as one node of torch's graph."""

    @staticmethod
    def forward(ctx, func, *xs):
        from .ndarray.ndarray import NDArray
        ctx.func = func
        with pause():
            outs = func.forward(*[NDArray(x) for x in xs])
        ctx.single = not isinstance(outs, (list, tuple))
        outs = (outs,) if ctx.single else tuple(outs)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *cts):
        from .ndarray.ndarray import NDArray
        with pause():
            gr = ctx.func.backward(*[NDArray(c) for c in cts])
        if not isinstance(gr, (list, tuple)):
            gr = (gr,)
        return (None,) + tuple(g._data if isinstance(g, NDArray) else g
                               for g in gr)


class Function:
    """A user-defined differentiable function (reference:
    autograd.Function): subclass and implement ``forward(self, *inputs)``
    and ``backward(self, *output_grads)``, both over NDArrays; the backward
    returns one gradient per input.  Both run with recording paused."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        if not is_recording():
            with pause():
                return self.forward(*inputs)
        outs = _FunctionBridge.apply(self, *_tensors(list(inputs)))
        wrapped = [NDArray(o) for o in outs]
        return wrapped[0] if len(wrapped) == 1 else wrapped
