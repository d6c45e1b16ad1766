"""Optimizer update ops.

Counterpart of ``mxnet_tpu/ops/optimizer.py`` (reference:
src/operator/optimizer_op.cc and src/operator/contrib/adamw.cc).  Each
registered op is the reference's per-tensor update: it computes the new
weight (and state) from its inputs, and dispatch writes them back in place
through the registry's ``mutates_input`` (the weight) and
``aux_writeback`` (the state buffers), so ``nd.sgd_mom_update(w, g, m,
out=w, ...)`` updates ``w`` and ``m`` as in the reference.

The arithmetic is the reference's, op for op and in its dtypes: each
product and sum rounds to its operands' dtype, and a Python scalar is
first rounded to the dtype of the tensor it meets
(:func:`_scalar`), as JAX's weakly typed scalars are; torch alone would
keep such a scalar in float32 against a bfloat16 tensor.  So a bfloat16
weight without multi-precision rounds where the reference's does.

:func:`tree_apply` is the fused multi-tensor update behind
``Optimizer.fused_update`` (the reference's jitted pytree apply): one call
per parameter group, in place, over ``torch._foreach_*`` lists (PyTorch's
multi-tensor apply), with each leaf's arithmetic in the order of the
per-tensor op.  The update ops are elementwise compositions, which the
reference left to XLA, so no hand-written kernel stands behind them.

The four ``_sparse_*`` updates (a row-sparse weight) are registered and
raise: sparse storage is Queue 1 item 8.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch

from ..base import MXNetError
from .registry import register

__all__ = ["tree_apply"]


@functools.lru_cache(maxsize=4096)
def _rounded(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def _scalar(value, dtype: torch.dtype) -> float:
    """``value`` as an array of ``dtype`` holds it: a float16 or bfloat16
    tensor meets the scalar rounded to its own type (JAX's weak typing);
    float32 and float64 kernels convert it themselves."""
    if dtype in (torch.float16, torch.bfloat16):
        return _rounded(float(value), dtype)
    return float(value)


def _clipping(clip_gradient) -> bool:
    return clip_gradient is not None and clip_gradient > 0


def _prep(grad, rescale_grad, clip_gradient, wd=0.0, weight=None):
    """``grad * rescale_grad``, clipped to +-``clip_gradient`` when that is
    positive, plus ``wd * weight`` only when ``wd`` is nonzero."""
    g = grad * _scalar(rescale_grad, grad.dtype)
    if _clipping(clip_gradient):
        c = _scalar(clip_gradient, g.dtype)
        g = g.clamp(-c, c)
    if wd and weight is not None:
        g = g + weight * _scalar(wd, weight.dtype)
    return g


def _mul(t, value):
    return t * _scalar(value, t.dtype)


def _lerp(state, beta, g):
    """``beta * state + (1 - beta) * g`` as the reference rounds it."""
    return _mul(state, beta) + _mul(g, 1.0 - beta)


def _lerp_sq(state, beta, g):
    """``beta * state + (1 - beta) * g * g``."""
    return _mul(state, beta) + _mul(g, 1.0 - beta) * g


# ---------------------------------------------------------------------------
# single-tensor updates
# ---------------------------------------------------------------------------

@register("sgd_update", differentiable=False, mutates_input=0)
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=True):
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    return weight - _mul(g.to(weight.dtype), lr)


@register("sgd_mom_update", differentiable=False, num_outputs=2,
          mutates_input=0, aux_writeback={1: 2})
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = _mul(mom, momentum) - _mul(g.to(mom.dtype), lr)
    return weight + new_mom.to(weight.dtype), new_mom


@register("mp_sgd_update", differentiable=False, num_outputs=2,
          mutates_input=0, aux_writeback={1: 2})
def _mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True):
    g = _prep(grad.float(), rescale_grad, clip_gradient, wd, weight32)
    new_w32 = weight32 - _mul(g, lr)
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update", differentiable=False, num_outputs=3,
          mutates_input=0, aux_writeback={1: 2, 2: 3})
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=True):
    g = _prep(grad.float(), rescale_grad, clip_gradient, wd, weight32)
    new_mom = _mul(mom, momentum) - _mul(g, lr)
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


@register("nag_mom_update", differentiable=False, num_outputs=2,
          mutates_input=0, aux_writeback={1: 2})
def _nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight).to(mom.dtype)
    new_mom = _mul(mom, momentum) + g
    update = _mul(new_mom, momentum) + g
    return weight - _mul(update.to(weight.dtype), lr), new_mom


@register("mp_nag_mom_update", differentiable=False, num_outputs=3,
          mutates_input=0, aux_writeback={1: 2, 2: 3})
def _mp_nag_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad.float(), rescale_grad, clip_gradient, wd, weight32)
    new_mom = _mul(mom, momentum) + g
    new_w32 = weight32 - _mul(g + _mul(new_mom, momentum), lr)
    return new_w32.to(weight.dtype), new_mom, new_w32


def _adam_step(mean, var, g, lr, beta1, beta2, epsilon):
    """New moments and ``lr * new_mean / (sqrt(new_var) + epsilon)``."""
    new_mean = _lerp(mean, beta1, g)
    new_var = _lerp_sq(var, beta2, g)
    update = _mul(new_mean, lr) / (new_var.sqrt() + _scalar(epsilon,
                                                              var.dtype))
    return update, new_mean, new_var


@register("adam_update", differentiable=False, num_outputs=3,
          mutates_input=0, aux_writeback={1: 2, 2: 3})
def _adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 lazy_update=True):
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight).to(mean.dtype)
    update, new_mean, new_var = _adam_step(mean, var, g, lr, beta1, beta2,
                                           epsilon)
    return weight - update.to(weight.dtype), new_mean, new_var


@register("adamw_update", aliases=["_adamw_update", "_contrib_adamw_update"],
          differentiable=False, num_outputs=3, mutates_input=0,
          aux_writeback={1: 2, 2: 3})
def _adamw_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                  epsilon=1e-8, wd=0.0, eta=1.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    """Decoupled weight decay: ``eta * (adam step + wd * weight)``."""
    g = _prep(grad, rescale_grad, clip_gradient).to(mean.dtype)
    step, new_mean, new_var = _adam_step(mean, var, g, lr, beta1, beta2,
                                         epsilon)
    update = _mul(step + _mul(weight.to(mean.dtype), wd), eta)
    return weight - update.to(weight.dtype), new_mean, new_var


@register("mp_adamw_update", aliases=["_mp_adamw_update"],
          differentiable=False, num_outputs=4, mutates_input=0,
          aux_writeback={1: 2, 2: 3, 3: 4})
def _mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad,
                     lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                     wd=0.0, eta=1.0, clip_gradient=-1.0):
    """``rescale_grad`` is a tensor here (a loss scale), as in the
    reference."""
    g = grad.float() * rescale_grad.float()
    if _clipping(clip_gradient):
        g = g.clamp(-float(clip_gradient), float(clip_gradient))
    step, new_mean, new_var = _adam_step(mean, var, g, lr, beta1, beta2,
                                         epsilon)
    new_w32 = weight32 - _mul(step + _mul(weight32, wd), eta)
    return new_w32.to(weight.dtype), new_mean, new_var, new_w32


def _lamb_direction(g, weight, mean, var, beta1, beta2, epsilon, t,
                    bias_correction, wd):
    new_mean = _lerp(mean, beta1, g)
    new_var = _lerp_sq(var, beta2, g)
    m, v = new_mean, new_var
    if bias_correction:
        m = m / _scalar(1.0 - beta1 ** t, m.dtype)
        v = v / _scalar(1.0 - beta2 ** t, v.dtype)
    update = m / (v.sqrt() + _scalar(epsilon, v.dtype)) + \
        _mul(weight.to(mean.dtype), wd)
    return update, new_mean, new_var


@register("lamb_update_phase1", differentiable=False, num_outputs=3,
          aux_writeback={1: 2, 2: 3})
def _lamb_phase1(grad, weight, mean, var, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0):
    """Phase 1 gives the raw update direction; phase 2 applies the trust
    ratio."""
    g = _prep(grad, rescale_grad, clip_gradient).to(mean.dtype)
    return _lamb_direction(g, weight, mean, var, beta1, beta2, epsilon, t,
                           bias_correction, wd)


def _norm32(x):
    return x.float().square().sum().sqrt()


def _trust_ratio(r1, r2):
    return torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))


@register("lamb_update_phase2", differentiable=False, mutates_input=0)
def _lamb_phase2(weight, g_update, r1=None, r2=None, lr=0.01,
                 lower_bound=-1.0, upper_bound=-1.0):
    r1 = _norm32(weight) if r1 is None else r1.float()
    r2 = _norm32(g_update) if r2 is None else r2.float()
    if lower_bound is not None and lower_bound > 0:
        r1 = r1.clamp_min(float(lower_bound))
    if upper_bound is not None and upper_bound > 0:
        r1 = r1.clamp_max(float(upper_bound))
    step = (_trust_ratio(r1, r2) * float(lr)).to(torch.float32)
    return weight - (step * g_update.float()).to(weight.dtype)


@register("mp_lamb_update_phase1", differentiable=False, num_outputs=3,
          aux_writeback={1: 2, 2: 3})
def _mp_lamb_phase1(grad, weight32, mean, var, beta1=0.9, beta2=0.999,
                    epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad.float(), rescale_grad, clip_gradient)
    return _lamb_direction(g, weight32, mean, var, beta1, beta2, epsilon, t,
                           bias_correction, wd)


@register("mp_lamb_update_phase2", differentiable=False, num_outputs=2,
          mutates_input=0, aux_writeback={1: 4})
def _mp_lamb_phase2(weight, g_update, r1, r2, weight32, lr=0.01,
                    lower_bound=-1.0, upper_bound=-1.0):
    r1, r2 = r1.float(), r2.float()
    if lower_bound >= 0:
        r1 = r1.clamp_min(float(lower_bound))
    if upper_bound >= 0:
        r1 = r1.clamp_max(float(upper_bound))
    new_w32 = weight32 - (_trust_ratio(r1, r2) * float(lr)) * g_update
    return new_w32.to(weight.dtype), new_w32


# ---------------------------------------------------------------------------
# multi-tensor updates: (w, g, state...) * num_weights in one call
# ---------------------------------------------------------------------------

def _groups(arrays, stride):
    return [tuple(arrays[i * stride:(i + 1) * stride])
            for i in range(len(arrays) // stride)]


def _per_weight(v, n, default):
    if v is None:
        return (default,) * n
    if isinstance(v, (int, float)):
        return (float(v),) * n
    return tuple(float(x) for x in v)


def _stride_map(stride, pairs):
    """The write-back map of a multi op: for weight i, output
    ``len(pairs) * i + k`` goes to input ``stride * i + pairs[k]``."""
    def aux(params):
        n = int(params.get("num_weights", 1))
        return {len(pairs) * i + k: stride * i + j
                for i in range(n) for k, j in enumerate(pairs)}
    return aux


@register("multi_sgd_update", differentiable=False, num_outputs=0,
          aux_writeback=_stride_map(2, (0,)))
def _multi_sgd_update(*arrays, lrs=None, wds=None, rescale_grad=1.0,
                      clip_gradient=-1.0, num_weights=1):
    lrs = _per_weight(lrs, num_weights, 0.01)
    wds = _per_weight(wds, num_weights, 0.0)
    return tuple(_sgd_update(w, g, lrs[i], wds[i], rescale_grad,
                             clip_gradient)
                 for i, (w, g) in enumerate(_groups(arrays, 2)))


@register("multi_sgd_mom_update", differentiable=False, num_outputs=0,
          aux_writeback=_stride_map(3, (0, 2)))
def _multi_sgd_mom_update(*arrays, lrs=None, wds=None, momentum=0.0,
                          rescale_grad=1.0, clip_gradient=-1.0,
                          num_weights=1):
    lrs = _per_weight(lrs, num_weights, 0.01)
    wds = _per_weight(wds, num_weights, 0.0)
    outs = []
    for i, (w, g, m) in enumerate(_groups(arrays, 3)):
        outs.extend(_sgd_mom_update(w, g, m, lrs[i], momentum, wds[i],
                                    rescale_grad, clip_gradient))
    return tuple(outs)


@register("multi_mp_sgd_update", differentiable=False, num_outputs=0,
          aux_writeback=_stride_map(3, (0, 2)))
def _multi_mp_sgd_update(*arrays, lrs=None, wds=None, rescale_grad=1.0,
                         clip_gradient=-1.0, num_weights=1):
    lrs = _per_weight(lrs, num_weights, 0.01)
    wds = _per_weight(wds, num_weights, 0.0)
    outs = []
    for i, (w, g, w32) in enumerate(_groups(arrays, 3)):
        outs.extend(_mp_sgd_update(w, g, w32, lrs[i], wds[i], rescale_grad,
                                   clip_gradient))
    return tuple(outs)


@register("multi_mp_sgd_mom_update", differentiable=False, num_outputs=0,
          aux_writeback=_stride_map(4, (0, 2, 3)))
def _multi_mp_sgd_mom_update(*arrays, lrs=None, wds=None, momentum=0.0,
                             rescale_grad=1.0, clip_gradient=-1.0,
                             num_weights=1):
    lrs = _per_weight(lrs, num_weights, 0.01)
    wds = _per_weight(wds, num_weights, 0.0)
    outs = []
    for i, (w, g, m, w32) in enumerate(_groups(arrays, 4)):
        outs.extend(_mp_sgd_mom_update(w, g, m, w32, lrs[i], momentum,
                                       wds[i], rescale_grad, clip_gradient))
    return tuple(outs)


@register("multi_sum_sq", differentiable=False)
def _multi_sum_sq(*arrays, num_arrays=1):
    """The sum of squares of each input, stacked into one (N,) vector."""
    return torch.stack([(a.float() * a.float()).sum() for a in arrays])


@register("reset_arrays", differentiable=False, num_outputs=0,
          aux_writeback=lambda p: {i: i for i in range(
              int(p.get("num_arrays", 1)))})
def _reset_arrays(*arrays, num_arrays=1):
    """Zero every input (written back in place by dispatch)."""
    return tuple(torch.zeros_like(a) for a in arrays)


def _multi_adamw(groups, rescale, lrs, wds, etas, beta1, beta2, epsilon,
                 clip_gradient, mp):
    outs = []
    for i, grp in enumerate(groups):
        w, g, m, v = grp[:4]
        target = grp[4] if mp else w
        gg = g.float() * rescale
        if _clipping(clip_gradient):
            gg = gg.clamp(-float(clip_gradient), float(clip_gradient))
        step, new_m, new_v = _adam_step(m, v, gg, lrs[i], beta1, beta2,
                                        epsilon)
        new_t = target - _mul(step + _mul(target, wds[i]), etas[i])
        outs.extend([new_t.to(w.dtype), new_m, new_v] +
                    ([new_t] if mp else []))
    return tuple(outs)


@register("multi_adamw_update", aliases=["_multi_adamw_update"],
          differentiable=False, num_outputs=0,
          aux_writeback=_stride_map(4, (0, 2, 3)))
def _multi_adamw_update(*arrays, lrs=None, wds=None, etas=None, beta1=0.9,
                        beta2=0.999, epsilon=1e-8, clip_gradient=-1.0,
                        num_weights=1):
    """Inputs (w, g, mean, var) * N, then the rescale tensor."""
    return _multi_adamw(_groups(arrays[:-1], 4), arrays[-1].float(),
                        _per_weight(lrs, num_weights, 0.001),
                        _per_weight(wds, num_weights, 0.0),
                        _per_weight(etas, num_weights, 1.0), beta1, beta2,
                        epsilon, clip_gradient, mp=False)


@register("multi_mp_adamw_update", aliases=["_multi_mp_adamw_update"],
          differentiable=False, num_outputs=0,
          aux_writeback=_stride_map(5, (0, 2, 3, 4)))
def _multi_mp_adamw_update(*arrays, lrs=None, wds=None, etas=None,
                           beta1=0.9, beta2=0.999, epsilon=1e-8,
                           clip_gradient=-1.0, num_weights=1):
    """Inputs (w, g, mean, var, w32) * N, then the rescale tensor."""
    return _multi_adamw(_groups(arrays[:-1], 5), arrays[-1].float(),
                        _per_weight(lrs, num_weights, 0.001),
                        _per_weight(wds, num_weights, 0.0),
                        _per_weight(etas, num_weights, 1.0), beta1, beta2,
                        epsilon, clip_gradient, mp=True)


# ---------------------------------------------------------------------------
# the adaptive single-tensor updates (RMSProp, AdaGrad, Ftrl, FTML, the sign
# family) and row-wise AdaGrad
# ---------------------------------------------------------------------------

def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        c = _scalar(clip_weights, w.dtype)
        w = w.clamp(-c, c)
    return w


@register("rmsprop_update", differentiable=False, num_outputs=2,
          mutates_input=0, aux_writeback={1: 2})
def _rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight).to(n.dtype)
    new_n = _mul(g, 1.0 - gamma1) * g + _mul(n, gamma1)
    step = _mul(g, lr) / (new_n + _scalar(epsilon, n.dtype)).sqrt()
    return _clip_weights(weight - step.to(weight.dtype), clip_weights), new_n


@register("rmspropalex_update", differentiable=False, num_outputs=4,
          mutates_input=0, aux_writeback={1: 2, 2: 3, 3: 4})
def _rmspropalex_update(weight, grad, n, g_buf, delta, lr=0.001, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0):
    """Centred RMSProp with momentum (Graves 2013)."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight).to(n.dtype)
    new_n = _mul(g, 1.0 - gamma1) * g + _mul(n, gamma1)
    new_g = _mul(g, 1.0 - gamma1) + _mul(g_buf, gamma1)
    new_delta = _mul(delta, gamma2) - _mul(g, lr) / (
        new_n - new_g * new_g + _scalar(epsilon, n.dtype)).sqrt()
    new_w = _clip_weights(weight + new_delta.to(weight.dtype), clip_weights)
    return new_w, new_n, new_g, new_delta


@register("adagrad_update", differentiable=False, num_outputs=2,
          mutates_input=0, aux_writeback={1: 2})
def _adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    new_h = history + g * g
    update = g / (new_h + _scalar(epsilon, new_h.dtype)).sqrt() + \
        _mul(weight, wd)
    return (weight - _mul(update, lr)).to(weight.dtype), new_h


@register("ftrl_update", differentiable=False, num_outputs=3,
          mutates_input=0, aux_writeback={1: 2, 2: 3})
def _ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient).to(z.dtype)
    new_n = n + g * g
    sigma = (new_n.sqrt() - n.sqrt()) / _scalar(lr, z.dtype)
    new_z = z + g - sigma * weight.to(z.dtype)
    shrunk = (torch.sign(new_z) * _scalar(lamda1, z.dtype) - new_z) / (
        (new_n.sqrt() + _scalar(beta, z.dtype)) / _scalar(lr, z.dtype)
        + _scalar(wd, z.dtype))
    new_w = torch.where(new_z.abs() <= _scalar(lamda1, z.dtype),
                        torch.zeros_like(new_z), shrunk)
    return new_w.to(weight.dtype), new_z, new_n


@register("ftml_update", differentiable=False, num_outputs=4,
          mutates_input=0, aux_writeback={1: 2, 2: 3, 3: 4})
def _ftml_update(weight, grad, d, v, z, lr=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                 clip_grad=-1.0):
    g = _prep(grad, rescale_grad, clip_grad, wd, weight)
    v_new = _lerp_sq(v, beta2, g)
    d_new = _mul((v_new / _scalar(1.0 - beta2 ** t, v_new.dtype)).sqrt()
                 + _scalar(epsilon, v_new.dtype), (1.0 - beta1 ** t) / lr)
    sigma = d_new - _mul(d, beta1)
    z_new = _lerp(z, beta1, g) - sigma * weight
    return (-z_new / d_new).to(weight.dtype), d_new, v_new, z_new


@register("signsgd_update", differentiable=False, mutates_input=0)
def _signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    return weight - _mul((torch.sign(g) + _mul(weight, wd)).to(weight.dtype),
                         lr)


@register("signum_update", differentiable=False, num_outputs=2,
          mutates_input=0, aux_writeback={1: 2})
def _signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = _mul(mom, momentum) - _mul(g.to(mom.dtype), 1.0 - momentum)
    new_w = _mul(weight, 1.0 - lr * wd_lh) + \
        _mul(torch.sign(new_mom).to(weight.dtype), lr)
    return new_w, new_mom


@register("_contrib_group_adagrad_update", aliases=["group_adagrad_update"],
          differentiable=False, num_outputs=2, mutates_input=0,
          aux_writeback={1: 2})
def _group_adagrad_update(weight, grad, history, lr=0.01, rescale_grad=1.0,
                          clip_gradient=-1.0, epsilon=1e-5):
    """AdaGrad with one accumulator a row (the mean square of the row's
    gradient)."""
    g = _prep(grad, rescale_grad, clip_gradient)
    sq = (g * g).mean(dim=tuple(range(1, g.dim())), keepdim=True) \
        if g.dim() > 1 else g * g
    new_h = history + sq
    step = _mul(g, lr) / (new_h.sqrt() + _scalar(epsilon, new_h.dtype))
    return (weight - step).to(weight.dtype), new_h


def _not_sparse(name):
    def fn(*arrays, **params):
        raise MXNetError("%s updates a row-sparse weight: sparse storage is "
                         "Queue 1 item 8" % name)
    fn.__name__ = name
    return fn


for _name in ("_sparse_sgd_update", "_sparse_sgd_mom_update",
              "_sparse_adam_update", "_sparse_adagrad_update"):
    register(_name, _not_sparse(_name), differentiable=False)


# ---------------------------------------------------------------------------
# LARS: the lrs from stacked per-layer norms, and the multi-SGD updates that
# read lrs and wds from tensors ("preloaded")
# ---------------------------------------------------------------------------

@register("multi_lars", differentiable=False)
def _multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001,
                eps=1e-8, rescale_grad=1.0):
    """Each layer's lr times its trust ratio ``eta * |w| / (|g| + wd *
    |w| + eps)`` (1 where a norm is 0)."""
    w_norm = weights_sum_sq.sqrt()
    g_norm = _mul(grads_sum_sq.sqrt(), rescale_grad)
    ratio = _mul(w_norm, eta) / (g_norm + wds * w_norm +
                                 _scalar(eps, w_norm.dtype))
    trust = torch.where((w_norm > 0) & (g_norm > 0), ratio,
                        torch.ones_like(ratio))
    return lrs * trust


def _preloaded(arrays, stride):
    """``(groups of stride, lrs, wds)`` of a preloaded multi op's
    inputs; lr and wd of weight i are the tensors' entries i."""
    return _groups(arrays[:-2], stride), arrays[-2], arrays[-1]


@register("preloaded_multi_sgd_update", differentiable=False,
          num_outputs=0, aux_writeback=_stride_map(2, (0,)))
def _preloaded_multi_sgd_update(*arrays, rescale_grad=1.0,
                                clip_gradient=-1.0, num_weights=1):
    groups, lrs, wds = _preloaded(arrays, 2)
    return tuple(w - lrs[i] * (_prep(g, rescale_grad, clip_gradient)
                               + wds[i] * w).to(w.dtype)
                 for i, (w, g) in enumerate(groups))


@register("preloaded_multi_sgd_mom_update", differentiable=False,
          num_outputs=0, aux_writeback=_stride_map(3, (0, 2)))
def _preloaded_multi_sgd_mom_update(*arrays, momentum=0.0, rescale_grad=1.0,
                                    clip_gradient=-1.0, num_weights=1):
    groups, lrs, wds = _preloaded(arrays, 3)
    outs = []
    for i, (w, g, m) in enumerate(groups):
        gg = _prep(g, rescale_grad, clip_gradient) + wds[i] * w
        new_m = _mul(m, momentum) - lrs[i] * gg.to(m.dtype)
        outs.extend([w + new_m.to(w.dtype), new_m])
    return tuple(outs)


@register("preloaded_multi_mp_sgd_update", differentiable=False,
          num_outputs=0, aux_writeback=_stride_map(3, (0, 2)))
def _preloaded_multi_mp_sgd_update(*arrays, rescale_grad=1.0,
                                   clip_gradient=-1.0, num_weights=1):
    groups, lrs, wds = _preloaded(arrays, 3)
    outs = []
    for i, (w, g, w32) in enumerate(groups):
        gg = _prep(g.float(), rescale_grad, clip_gradient) + wds[i] * w32
        new_w32 = w32 - lrs[i] * gg
        outs.extend([new_w32.to(w.dtype), new_w32])
    return tuple(outs)


@register("preloaded_multi_mp_sgd_mom_update", differentiable=False,
          num_outputs=0, aux_writeback=_stride_map(4, (0, 2, 3)))
def _preloaded_multi_mp_sgd_mom_update(*arrays, momentum=0.0,
                                       rescale_grad=1.0, clip_gradient=-1.0,
                                       num_weights=1):
    groups, lrs, wds = _preloaded(arrays, 4)
    outs = []
    for i, (w, g, m, w32) in enumerate(groups):
        gg = _prep(g.float(), rescale_grad, clip_gradient) + wds[i] * w32
        new_m = _mul(m, momentum) - lrs[i] * gg
        new_w32 = w32 + new_m
        outs.extend([new_w32.to(w.dtype), new_m, new_w32])
    return tuple(outs)


# ---------------------------------------------------------------------------
# the LAMB and LANS fleets: (w, g, mean, var[, w32]) * N in one call, in
# float32
# ---------------------------------------------------------------------------

def _fleet_moments(g32, m, v, beta1, beta2, t, bias_correction):
    new_m = _lerp(m, beta1, g32)
    new_v = _lerp_sq(v, beta2, g32)
    mh, vh = new_m, new_v
    if bias_correction:
        mh = mh / _scalar(1.0 - beta1 ** t, mh.dtype)
        vh = vh / _scalar(1.0 - beta2 ** t, vh.dtype)
    return new_m, new_v, mh, vh


def _bounded(x, lower_bound, upper_bound):
    if lower_bound is not None and lower_bound > 0:
        x = x.clamp_min(float(lower_bound))
    if upper_bound is not None and upper_bound > 0:
        x = x.clamp_max(float(upper_bound))
    return x


def _lamb_member(g, m, v, w32, lr, wd, beta1, beta2, epsilon, t,
                 bias_correction, lower_bound, upper_bound, clip_gradient,
                 rescale_grad):
    """One LAMB fleet member: the Adam direction, then one trust ratio a
    layer on the whole update; ``(new w32, new mean, new var)``."""
    g32 = _prep(g.float(), rescale_grad, clip_gradient)
    new_m, new_v, mh, vh = _fleet_moments(g32, m, v, beta1, beta2, t,
                                          bias_correction)
    upd = mh / (vh.sqrt() + _scalar(epsilon, vh.dtype)) + _mul(w32, wd)
    wnorm = _bounded(_norm32(w32), lower_bound, upper_bound)
    ratio = _trust_ratio(wnorm, _norm32(upd))
    return w32 - (ratio * float(lr)) * upd, new_m, new_v


def _lans_member(g, m, v, w32, lr, wd, beta1, beta2, epsilon, t,
                 bias_correction, lower_bound, upper_bound, clip_gradient,
                 rescale_grad):
    """One LANS fleet member: the gradient normalised by its norm, and a
    trust ratio each on the momentum and the gradient terms."""
    g32 = _mul(g.float(), rescale_grad)
    g32 = g32 / _norm32(g32).clamp_min(1e-12)
    if _clipping(clip_gradient):
        g32 = g32.clamp(-float(clip_gradient), float(clip_gradient))
    new_m, new_v, mh, vh = _fleet_moments(g32, m, v, beta1, beta2, t,
                                          bias_correction)
    wnorm = _norm32(w32)

    def trust(upd):
        ratio = _trust_ratio(wnorm, _norm32(upd))
        return _bounded(ratio, lower_bound, upper_bound) * upd

    denom = vh.sqrt() + _scalar(epsilon, vh.dtype)
    upd = _mul(trust(mh / denom + _mul(w32, wd)), beta1) + \
        _mul(trust(g32 / denom + _mul(w32, wd)), 1.0 - beta1)
    return w32 - _mul(upd, lr), new_m, new_v


def _fleet(member, arrays, mp, learning_rates, wds, num_weights, **kw):
    lrs = _per_weight(learning_rates, num_weights, 0.001)
    wds = _per_weight(wds, num_weights, 0.0)
    outs = []
    for i, grp in enumerate(_groups(arrays, 5 if mp else 4)):
        w, g, m, v = grp[:4]
        new_w32, new_m, new_v = member(g, m, v, grp[4] if mp else w.float(),
                                       lrs[i], wds[i], **kw)
        outs.extend([new_w32.to(w.dtype), new_m, new_v] +
                    ([new_w32] if mp else []))
    return tuple(outs)


def _fleet_op(name, aliases, member, mp):
    def op(*arrays, learning_rates=None, wds=None, beta1=0.9, beta2=0.999,
           epsilon=1e-6, t=1, bias_correction=True, lower_bound=-1.0,
           upper_bound=-1.0, clip_gradient=-1.0, rescale_grad=1.0,
           num_weights=1):
        return _fleet(member, arrays, mp, learning_rates, wds, num_weights,
                      beta1=beta1, beta2=beta2, epsilon=epsilon, t=t,
                      bias_correction=bias_correction,
                      lower_bound=lower_bound, upper_bound=upper_bound,
                      clip_gradient=clip_gradient, rescale_grad=rescale_grad)
    op.__name__ = name
    op.__doc__ = "%s over (w, g, mean, var%s) * num_weights." % (
        "LAMB" if member is _lamb_member else "LANS", ", w32" if mp else "")
    register(name, op, aliases=aliases, differentiable=False, num_outputs=0,
             aux_writeback=_stride_map(5, (0, 2, 3, 4)) if mp
             else _stride_map(4, (0, 2, 3)))


_fleet_op("multi_lamb_update", ["_contrib_multi_lamb_update"], _lamb_member,
          False)
_fleet_op("multi_mp_lamb_update", ["_contrib_multi_mp_lamb_update"],
          _lamb_member, True)
_fleet_op("multi_lans_update", ["_multi_lans_update"], _lans_member, False)
_fleet_op("multi_mp_lans_update", ["_multi_mp_lans_update"], _lans_member,
          True)


# ---------------------------------------------------------------------------
# the fused apply of Optimizer.fused_update
# ---------------------------------------------------------------------------

def _scalars(values, tensors) -> List[float]:
    return [_scalar(v, t.dtype) for v, t in zip(values, tensors)]


def _each(value, tensors) -> List[float]:
    return [_scalar(value, t.dtype) for t in tensors]


def _fused_prep(grads, weights, wds, rescale_grad, clip_gradient, mp):
    """:func:`_prep` over lists: new gradient tensors (the inputs
    survive), float32 first under multi-precision."""
    if mp:
        grads = [g.float() for g in grads]
    g = torch._foreach_mul(grads, _each(rescale_grad, grads))
    if _clipping(clip_gradient):
        torch._foreach_clamp_min_(g, _each(-clip_gradient, g))
        torch._foreach_clamp_max_(g, _each(clip_gradient, g))
    decayed = [i for i, wd in enumerate(wds) if wd]
    if decayed:
        ws = [weights[i] for i in decayed]
        torch._foreach_add_([g[i] for i in decayed], torch._foreach_mul(
            ws, _scalars([wds[i] for i in decayed], ws)))
    return g


def _cast_to(tensors, like):
    return [t if t.dtype == o.dtype else t.to(o.dtype)
            for t, o in zip(tensors, like)]


def tree_apply(kind: str, arrays: Sequence, lrs: Sequence[float],
               decays: Optional[Sequence[float]] = None, *, wds=(),
               rescale_grad: float = 1.0, clip_gradient: float = -1.0,
               mp: bool = False, momentum: float = 0.0, beta1: float = 0.9,
               beta2: float = 0.999, epsilon: float = 1e-8) -> None:
    """Apply one fused update of ``kind`` ('sgd', 'sgd_mom', 'nag_mom',
    'adam', 'adamw') to a parameter group, in place.

    ``arrays`` holds the kind's tensor lists in the reference's order:
    weights, grads, the state columns (none; the momenta; the means and
    the variances), then the float32 masters under ``mp`` (else None).
    ``lrs``, ``wds`` and, for 'adamw', ``decays`` (``lr * wd``, applied to
    the new weight) hold one Python float per leaf.  Under ``mp`` the
    update runs on the masters with the gradients cast to float32 and the
    weights receive the masters cast back.  One apply counts one dispatch
    (``engine.dispatch_count``), as the reference's jitted tree update
    does."""
    from ..engine import engine as _engine
    _engine.count_dispatch()
    weights, grads = list(arrays[0]), list(arrays[1])
    states = [list(col) for col in arrays[2:-1]]
    masters = list(arrays[-1]) if mp else None
    target = masters if mp else weights
    wds = tuple(wds) or (0.0,) * len(weights)
    with torch.no_grad():
        decay_in_g = wds if kind != "adamw" else (0.0,) * len(weights)
        g = _fused_prep(grads, target, decay_in_g, rescale_grad,
                        clip_gradient, mp)
        if kind == "sgd":
            torch._foreach_sub_(target, torch._foreach_mul(
                _cast_to(g, target), _scalars(lrs, target)))
        elif kind in ("sgd_mom", "nag_mom"):
            (moms,) = states
            gm = _cast_to(g, moms)
            torch._foreach_mul_(moms, _each(momentum, moms))
            if kind == "sgd_mom":
                torch._foreach_sub_(moms, torch._foreach_mul(
                    gm, _scalars(lrs, moms)))
                torch._foreach_add_(target, _cast_to(moms, target))
            else:
                torch._foreach_add_(moms, gm)
                update = torch._foreach_mul(moms, _each(momentum, moms))
                torch._foreach_add_(update, gm)
                torch._foreach_sub_(target, torch._foreach_mul(
                    _cast_to(update, target), _scalars(lrs, target)))
        elif kind in ("adam", "adamw"):
            means, variances = states
            gm = _cast_to(g, means)
            torch._foreach_mul_(means, _each(beta1, means))
            torch._foreach_add_(means, torch._foreach_mul(
                gm, _each(1.0 - beta1, gm)))
            torch._foreach_mul_(variances, _each(beta2, variances))
            sq = torch._foreach_mul(gm, _each(1.0 - beta2, gm))
            torch._foreach_mul_(sq, gm)
            torch._foreach_add_(variances, sq)
            update = torch._foreach_mul(means, _scalars(lrs, means))
            denom = torch._foreach_sqrt(variances)
            torch._foreach_add_(denom, _each(epsilon, denom))
            torch._foreach_div_(update, denom)
            torch._foreach_sub_(target, _cast_to(update, target))
            if kind == "adamw":
                decayed = [i for i, wd in enumerate(wds) if wd]
                if decayed:
                    ts = [target[i] for i in decayed]
                    torch._foreach_sub_(ts, torch._foreach_mul(
                        ts, _scalars([decays[i] for i in decayed], ts)))
        else:
            raise ValueError("tree_apply: unknown kind %r" % (kind,))
        if mp:
            torch._foreach_copy_(weights, masters)
