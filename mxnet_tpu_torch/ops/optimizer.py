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

Not ported yet: the sparse (``_sparse_*``), ``rmsprop*``, ``ftrl``,
``signsgd``/``signum``, ``ftml``, ``group_adagrad``, ``adagrad``,
``preloaded_multi_*``, ``multi_lars``, ``multi_lamb`` and ``multi_lans``
updates.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch

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
    weights receive the masters cast back."""
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
