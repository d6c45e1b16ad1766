"""mx.amp: automatic mixed precision.

Counterpart of ``mxnet_tpu/amp/__init__.py`` (reference:
``python/mxnet/contrib/amp/amp.py``: init, init_trainer, scale_loss,
unscale, convert_hybrid_block; the op lists of :mod:`.lists`).

Every registered op the port computes, whether called as ``nd.<op>``,
from a gluon block's forward, under ``functionalize``/``TrainStep`` or in
``serve.Servable``, goes through one route,
:func:`mxnet_tpu_torch.ops.registry.dispatch` (``ndarray.invoke`` runs
the same cast), and that route applies the policy of
:func:`current_state` to the op's floating inputs, keyed by the op's
registered name: an op on the target list gets them in the target dtype,
an op on the fp32 list (or the conditional list, for the listed attribute
values) gets half-precision inputs widened to float32, and an op on the
widest list gets every floating input in the widest of their dtypes.
Integer and bool inputs (indices, masks) keep their dtype.  The cast is an
autograd op, so an fp32 parameter used in bf16 gets an fp32 gradient.

Eager PyTorch does not fuse the casts as XLA fuses the reference's: each
cast of an fp32 weight is a kernel of its own.  Cast weights are not
cached, as the reference caches none.

The default target dtype is ``bfloat16``, with float32's exponent range,
so its loss scale is pinned at 1 (:class:`_StaticScaler`); ``float16``
takes the reference's dynamic loss scaling (:class:`LossScaler`).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

import torch

from . import lists

__all__ = ["init", "init_trainer", "scale_loss", "unscale", "LossScaler",
           "convert_hybrid_block", "lists", "current_state", "state_scope",
           "make_state", "turn_off", "active"]

#: the process-wide policy; None is AMP off
STATE: Optional["_AmpState"] = None

# a thread's scoped policies (state_scope), innermost last
_TLS = threading.local()

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_NARROW = (torch.bfloat16, torch.float16)


def current_state() -> Optional["_AmpState"]:
    """The policy in force for this thread: the innermost scoped one, else
    the process-wide :data:`STATE`."""
    stack = getattr(_TLS, "stack", None)
    if stack:
        return stack[-1]
    return STATE


class state_scope:
    """Push a scoped policy (or None to switch AMP off inside the scope)
    for the calling thread only."""

    def __init__(self, state: Optional["_AmpState"]):
        self._state = state

    def __enter__(self):
        if not hasattr(_TLS, "stack"):
            _TLS.stack = []
        _TLS.stack.append(self._state)
        return self

    def __exit__(self, *exc):
        _TLS.stack.pop()
        return False


class _AmpState:
    __slots__ = ("target_dtype", "target_ops", "fp32_ops", "widest_ops",
                 "conditional_fp32")

    def __init__(self, target_dtype, target_ops, fp32_ops, widest_ops,
                 conditional_fp32):
        self.target_dtype = target_dtype
        self.target_ops = frozenset(target_ops)
        self.fp32_ops = frozenset(fp32_ops)
        self.widest_ops = frozenset(widest_ops)
        # {op_name: (param_name, frozenset(values))}
        self.conditional_fp32 = {name: (pname, frozenset(vals))
                                 for name, pname, vals in conditional_fp32}

    def cast_inputs(self, op_name: str, params: dict, inputs) -> list:
        """Apply the policy of op ``op_name`` (its registered name) to its
        inputs; non-tensors and non-floating tensors pass unchanged."""
        if op_name in self.target_ops:
            return [self._to(x, self.target_dtype) for x in inputs]
        if op_name in self.fp32_ops:
            return [self._up(x) for x in inputs]
        cond = self.conditional_fp32.get(op_name)
        if cond is not None and str(params.get(cond[0])) in cond[1]:
            return [self._up(x) for x in inputs]
        if op_name in self.widest_ops:
            floats = {x.dtype for x in inputs
                      if isinstance(x, torch.Tensor) and
                      x.is_floating_point()}
            if len(floats) > 1:
                widest = floats.pop()
                for d in floats:
                    widest = torch.promote_types(widest, d)
                return [self._to(x, widest) for x in inputs]
        return inputs

    @staticmethod
    def _to(x, dtype):
        if isinstance(x, torch.Tensor) and x.is_floating_point() and \
                x.dtype != dtype:
            return x.to(dtype)
        return x

    @staticmethod
    def _up(x):
        if isinstance(x, torch.Tensor) and x.dtype in _NARROW:
            return x.float()
        return x


def _target(target_dtype) -> torch.dtype:
    if isinstance(target_dtype, torch.dtype) and target_dtype in _NARROW:
        return target_dtype
    name = getattr(target_dtype, "__name__", None) or str(target_dtype)
    if name not in _DTYPES:
        raise ValueError("AMP target_dtype must be bfloat16 or float16, "
                         "got %s" % (target_dtype,))
    return _DTYPES[name]


def make_state(target_dtype="bfloat16", target_dtype_ops=None, fp32_ops=None,
               widest_dtype_ops=None, conditional_fp32_ops=None
               ) -> "_AmpState":
    """A policy, not installed (:func:`init` installs one; a scope pushes
    one with :class:`state_scope`)."""
    return _AmpState(
        _target(target_dtype),
        lists.TARGET_DTYPE_OPS if target_dtype_ops is None
        else target_dtype_ops,
        lists.FP32_OPS if fp32_ops is None else fp32_ops,
        lists.WIDEST_TYPE_CASTS if widest_dtype_ops is None
        else widest_dtype_ops,
        lists.CONDITIONAL_FP32_OPS if conditional_fp32_ops is None
        else conditional_fp32_ops)


def init(target_dtype="bfloat16", target_dtype_ops=None, fp32_ops=None,
         widest_dtype_ops=None, conditional_fp32_ops=None):
    """Turn AMP on (reference: amp.init).  ``target_dtype`` is 'bfloat16'
    (the default) or 'float16'; the ``*_ops`` arguments replace the lists
    of :mod:`.lists`."""
    global STATE
    STATE = make_state(target_dtype, target_dtype_ops, fp32_ops,
                       widest_dtype_ops, conditional_fp32_ops)


def turn_off():
    """Switch AMP off (no reference equivalent; for tests)."""
    global STATE
    STATE = None


def active() -> bool:
    return STATE is not None


# -- loss scaling -------------------------------------------------------------

def _all_finite(grads) -> bool:
    """Whether every entry of every tensor in ``grads`` is finite: the max
    norm of each (grouped by dtype and device, ``torch._foreach_norm``),
    one ``isfinite`` over them all, one host read."""
    groups = {}
    for g in grads:
        groups.setdefault((g.dtype, g.device), []).append(g)
    norms = [n.float() for group in groups.values()
             for n in torch._foreach_norm(group, float("inf"))]
    return bool(torch.isfinite(torch.stack(norms)).all())


class LossScaler:
    """Dynamic loss scaling (reference: amp.loss_scaler.LossScaler).

    The loss is multiplied by ``loss_scale`` before backward and the
    gradients divided by it in the update (the trainer's ``_scale``); a
    step with a non-finite gradient is skipped and halves the scale, and
    ``scale_window`` clean steps in a row double it, up to 2^24."""

    def __init__(self, init_scale=2. ** 16, scale_factor=2.,
                 scale_window=2000):
        self.loss_scale = float(init_scale)
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0
        self._max_scale = 2. ** 24

    def has_overflow(self, params) -> bool:
        """Whether any gradient of ``params`` holds an inf or a NaN."""
        grads = [g.data for p in params for g in p.list_grad()]
        if not grads:
            return False
        return not _all_finite(grads)

    def update_scale(self, overflow: bool):
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale = min(self.loss_scale * self._scale_factor,
                                      self._max_scale)
                self._unskipped = 0


class _StaticScaler(LossScaler):
    """bf16 needs no scaling: the scale is pinned at 1 and the overflow
    check skipped (bf16 has float32's exponent range; a non-finite
    gradient there means divergence, not underflow)."""

    def __init__(self):
        super().__init__(init_scale=1.0)

    def has_overflow(self, params) -> bool:
        return False

    def update_scale(self, overflow: bool):
        pass


def init_trainer(trainer):
    """Give a gluon ``Trainer`` a loss scaler (reference:
    amp.init_trainer): its update is wrapped so that a step with a
    non-finite gradient leaves every weight and optimizer state as it
    was and backs the scale off."""
    if STATE is None:
        raise RuntimeError("amp.init() must be called before init_trainer()")
    if getattr(trainer, "_amp_loss_scaler", None) is not None:
        return
    scaler = _StaticScaler() if STATE.target_dtype == torch.bfloat16 \
        else LossScaler()
    trainer._amp_loss_scaler = scaler
    trainer._amp_original_scale = trainer._scale
    orig_update = trainer._update

    def _amp_update(ignore_stale_grad=False):
        live = [p for p in trainer._params if p.grad_req != "null"]
        overflow = scaler.has_overflow(live)
        if not overflow:
            orig_update(ignore_stale_grad)
        scaler.update_scale(overflow)

    trainer._update = _amp_update


@contextmanager
def scale_loss(loss, trainer):
    """Scale the loss up before ``backward()`` (reference:
    amp.scale_loss)::

        with amp.scale_loss(loss, trainer) as scaled:
            scaled.backward()
        trainer.step(batch_size)
    """
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        yield loss
        return
    trainer._scale = trainer._amp_original_scale / scaler.loss_scale
    if isinstance(loss, (list, tuple)):
        yield type(loss)(l * scaler.loss_scale for l in loss)
    else:
        yield loss * scaler.loss_scale


def unscale(trainer):
    """Divide the current gradients by the loss scale in place (reference:
    amp.unscale), for work on the gradients between backward and step; the
    trainer then divides by nothing more."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None or scaler.loss_scale == 1.0:
        return
    inv = 1.0 / scaler.loss_scale
    with torch.no_grad():
        for p in trainer._params:
            if p.grad_req == "null":
                continue
            for g in p.list_grad():
                g.data.mul_(inv)
    trainer._scale = trainer._amp_original_scale


def convert_hybrid_block(block, target_dtype="bfloat16",
                         cast_optional_params=False):
    """Cast a block for narrow-dtype inference (reference:
    amp.convert_hybrid_block): every parameter to ``target_dtype`` except
    those of the normalization layers (gamma, beta, running statistics),
    which stay float32; the fp32 list widens their inputs at dispatch."""
    from ..gluon import nn as _nn
    norm_types = (_nn.BatchNorm, _nn.LayerNorm, _nn.GroupNorm,
                  _nn.InstanceNorm)
    block.cast(_target(target_dtype))
    for child in block.modules():
        if isinstance(child, norm_types):
            child.cast("float32")
    return block
