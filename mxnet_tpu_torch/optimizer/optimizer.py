"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py`` (reference:
python/mxnet/optimizer/optimizer.py): the ``Optimizer`` base (registry,
``create``, ``lr_mult``/``wd_mult`` read from ``param_dict`` first,
per-index update counts and ``num_update``, ``multi_precision`` with a
float32 master copy of a float16/bfloat16 weight, ``aggregate_num``
chunking and the fused apply), ``SGD``, ``NAG``, ``Adam``, ``AdamW``,
``LAMB``, the reference's other thirteen (``RMSProp``, ``AdaGrad``,
``AdaDelta``, ``Ftrl``, ``LARS``, ``SignSGD``, ``Signum``, ``DCASGD``,
``Test``, ``FTML``, ``Adamax``, ``Nadam``, ``SGLD``), ``Updater`` and
``get_updater``.

An update on one parameter dispatches the registered op of
``ops/optimizer.py`` on NDArrays (``invoke("sgd_mom_update", ...)``), as
the reference does; an ``Updater`` called with a group applies it with
one :func:`~..ops.optimizer.tree_apply` per ``aggregate_num`` chunk
(``torch._foreach_*`` lists) where the optimizer has a fused form (SGD,
NAG, Adam, AdamW; LAMB has none in the reference either).  States are
NDArrays on their weight's device.

Those thirteen update one parameter at a time, through their registered
ops or as compositions of ``nd`` ops, as the reference's do (they have no
fused form there either).

Not ported yet: sparse gradients; the whole-step compiled lane's
``_compiled_spec`` (it waits for the CUDA-graph step).
"""
from __future__ import annotations

import math
import pickle
from typing import Any, Dict

import torch

from ..base import get_env
from ..ndarray.ndarray import NDArray, invoke, zeros
from ..ops.optimizer import tree_apply

__all__ = ["Optimizer", "Updater", "get_updater", "register", "create",
           "SGD", "NAG", "Adam", "AdamW", "LAMB", "RMSProp", "AdaGrad",
           "AdaDelta", "Ftrl", "LARS", "SignSGD", "Signum", "DCASGD", "Test",
           "FTML", "Adamax", "Nadam", "SGLD"]

_LOW_PRECISION = (torch.float16, torch.bfloat16)


def _aggregate_default(n):
    """The default ``aggregate_num`` of an optimizer with a fused form;
    ``MX_OPTIMIZER_AGGREGATE`` overrides it (0: one update per
    parameter)."""
    v = get_env("MX_OPTIMIZER_AGGREGATE", None, int)
    if not isinstance(v, int) or v < 0:
        return n
    return v


def _chunks(seq, n):
    if n <= 0 or n >= len(seq):
        yield seq
        return
    for i in range(0, len(seq), n):
        yield seq[i:i + n]


def _clip(value):
    return -1.0 if value is None else value


def _zeros_like(weight: NDArray) -> NDArray:
    return zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)


class Optimizer:
    """Base optimizer (reference: class Optimizer)."""

    opt_registry: Dict[str, type] = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, aggregate_num=0, use_fused_step=True):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._all_index_update_counts = {0: {}}
        self._index_update_count = self._all_index_update_counts[0]
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.aggregate_num = aggregate_num
        if param_idx2name is None:
            param_idx2name = {}
        assert isinstance(param_idx2name, dict), \
            "param_idx2name should be a dict of param indexes to names."
        self.idx2name = param_idx2name.copy()
        self.param_dict = param_dict if param_dict else {}

    # -- registry ----------------------------------------------------------
    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    # -- state -------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """The state of ``weight``; under ``multi_precision`` a float16 or
        bfloat16 weight gets ``(state of its float32 copy, that copy)``."""
        if self.multi_precision and weight.data.dtype in _LOW_PRECISION:
            master = weight.astype("float32")
            return (self.create_state(index, master), master)
        return self.create_state(index, weight)

    # -- update ------------------------------------------------------------
    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def _is_mp_state(self, weight, state):
        """A ``(state, float32 master)`` pair of a low-precision weight."""
        return (self.multi_precision and isinstance(state, tuple) and
                len(state) == 2 and isinstance(state[1], NDArray) and
                state[1].data.dtype == torch.float32 and
                weight.data.dtype != torch.float32)

    def update_multi_precision(self, index, weight, grad, state):
        """Update the float32 master with the gradient cast to float32 and
        give the weight the master cast back, or update ``weight``
        itself."""
        if self._is_mp_state(weight, state):
            inner, weight32 = state
            self.update(index, weight32, grad.astype("float32"), inner)
            with torch.no_grad():
                weight.data.copy_(weight32.data)
        else:
            self.update(index, weight, grad, state)

    # -- fused multi-tensor apply ------------------------------------------
    def fused_update(self, indices, weights, grads, states):
        """Apply a whole group at once; False when this optimizer has no
        fused form (the caller then updates one parameter at a time)."""
        return False

    def _fused_apply(self, kind, indices, weights, grads, states, unpack,
                     lr_fn=None, decay_fn=None, **static):
        """The bookkeeping of a fused update (update counts, each leaf's
        lr and wd, multi-precision and device groups, ``aggregate_num``
        chunks), then one :func:`tree_apply` per chunk, in place.

        ``unpack(state, mp) -> (state columns, float32 master or None)``;
        ``lr_fn(pos, lr)`` and ``decay_fn(pos, lr, wd)`` (``pos`` indexes
        ``indices``) fold the Adam family's bias correction and decoupled
        decay into each leaf's scalars as the per-parameter update does."""
        self._update_count(indices)
        lrs = self._get_lrs(indices)
        wds = self._get_wds(indices)
        groups: Dict[Any, list] = {}
        for pos in range(len(indices)):
            mp = self._is_mp_state(weights[pos], states[pos])
            dev = (weights[pos].data.device, grads[pos].data.device)
            groups.setdefault((mp, dev), []).append(pos)
        for (mp, _), poss in groups.items():
            for chunk in _chunks(poss, self.aggregate_num):
                inners, masters = zip(*(unpack(states[p], mp)
                                        for p in chunk))
                arrays = [[weights[p].data for p in chunk],
                          [grads[p].data for p in chunk]]
                arrays += [[s.data for s in col] for col in zip(*inners)]
                arrays.append([m.data for m in masters] if mp else None)
                tree_apply(
                    kind, arrays,
                    [lr_fn(p, lrs[p]) if lr_fn else lrs[p] for p in chunk],
                    [decay_fn(p, lrs[p], wds[p]) for p in chunk]
                    if decay_fn else None,
                    wds=tuple(wds[p] for p in chunk),
                    rescale_grad=self.rescale_grad,
                    clip_gradient=_clip(self.clip_gradient), mp=mp,
                    **static)
        return True

    # -- lr / wd -----------------------------------------------------------
    @property
    def learning_rate(self):
        """The base lr: the scheduler's value, without per-parameter
        multipliers."""
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined. Note that set_learning_rate can "
                              "mutate the value of the learning rate of the "
                              "optimizer only when the LRScheduler of the "
                              "optimizer is undefined.")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = args_lr_mult.copy()

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith(".weight")):
                self.wd_mult[n] = 0.0
        self.wd_mult.update(args_wd_mult)

    def _set_current_context(self, device_id):
        if device_id not in self._all_index_update_counts:
            self._all_index_update_counts[device_id] = {}
        self._index_update_count = self._all_index_update_counts[device_id]

    def _update_count(self, index):
        if not isinstance(index, (list, tuple)):
            index = [index]
        for idx in index:
            if idx not in self._index_update_count:
                self._index_update_count[idx] = self.begin_num_update
            self._index_update_count[idx] += 1
            self.num_update = max(self._index_update_count[idx],
                                  self.num_update)

    def _get_lrs(self, indices):
        lr = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
        lrs = [lr for _ in indices]
        for i, index in enumerate(indices):
            if index in self.param_dict:
                lrs[i] *= self.param_dict[index].lr_mult
            elif index in self.lr_mult:
                lrs[i] *= self.lr_mult[index]
            elif index in self.idx2name:
                lrs[i] *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lrs

    def _get_lr(self, index):
        return self._get_lrs([index])[0]

    def _get_wds(self, indices):
        wds = [self.wd for _ in indices]
        for i, index in enumerate(indices):
            if index in self.param_dict:
                wds[i] *= self.param_dict[index].wd_mult
            elif index in self.wd_mult:
                wds[i] *= self.wd_mult[index]
            elif index in self.idx2name:
                wds[i] *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wds

    def _get_wd(self, index):
        return self._get_wds([index])[0]

    def __getstate__(self):
        # ``param_dict`` holds handles to the model's slots; the Trainer
        # gives a loaded optimizer its own again (load_states)
        ret = self.__dict__.copy()
        ret["param_dict"] = {}
        return ret

    def __setstate__(self, state):
        self.__dict__.update(state)


register = Optimizer.register


def create(name, **kwargs):
    """An optimizer by name (or an instance, returned as is)."""
    if isinstance(name, Optimizer):
        return name
    return Optimizer.create_optimizer(name, **kwargs)


def _momentum_unpack(has_mom):
    def unpack(state, mp):
        inner = state[0] if mp else state
        return ((inner,) if has_mom else ()), (state[1] if mp else None)
    return unpack


def _moments_unpack(state, mp):
    mean, var = state[0] if mp else state
    return (mean, var), (state[1] if mp else None)


@register
class SGD(Optimizer):
    """SGD with momentum (reference: optimizer.SGD -> sgd_update /
    sgd_mom_update)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=True,
                 **kwargs):
        kwargs.setdefault("aggregate_num", _aggregate_default(64))
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def fused_update(self, indices, weights, grads, states):
        has_mom = self.momentum != 0.0
        extra = {"momentum": self.momentum} if has_mom else {}
        return self._fused_apply("sgd_mom" if has_mom else "sgd", indices,
                                 weights, grads, states,
                                 _momentum_unpack(has_mom), **extra)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad,
                  clip_gradient=_clip(self.clip_gradient))
        if state is not None:
            invoke("sgd_mom_update", weight, grad, state,
                   momentum=self.momentum, **kw)
        else:
            invoke("sgd_update", weight, grad, **kw)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (reference: optimizer.NAG)."""

    def __init__(self, learning_rate=0.1, momentum=0.0, **kwargs):
        kwargs.setdefault("aggregate_num", _aggregate_default(64))
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad,
                  clip_gradient=_clip(self.clip_gradient))
        if state is not None:
            invoke("nag_mom_update", weight, grad, state,
                   momentum=self.momentum, **kw)
        else:
            invoke("sgd_update", weight, grad, **kw)

    def fused_update(self, indices, weights, grads, states):
        has_mom = self.momentum != 0.0
        extra = {"momentum": self.momentum} if has_mom else {}
        return self._fused_apply("nag_mom" if has_mom else "sgd", indices,
                                 weights, grads, states,
                                 _momentum_unpack(has_mom), **extra)


class _AdamBase(Optimizer):
    def __init__(self, learning_rate, beta1, beta2, epsilon, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _corrected(self, index, lr):
        """``lr`` times the bias correction at this index's count, on the
        host in float64 (the reference's)."""
        t = self._index_update_count[index]
        return lr * math.sqrt(1.0 - self.beta2 ** t) / \
            (1.0 - self.beta1 ** t)


@register
class Adam(_AdamBase):
    """Adam (reference: optimizer.Adam -> adam_update), the bias
    correction folded into the lr on the host as the reference does."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        kwargs.setdefault("aggregate_num", _aggregate_default(64))
        super().__init__(learning_rate, beta1, beta2, epsilon, **kwargs)
        self.lazy_update = lazy_update

    def fused_update(self, indices, weights, grads, states):
        return self._fused_apply(
            "adam", indices, weights, grads, states, _moments_unpack,
            lr_fn=lambda pos, lr: self._corrected(indices[pos], lr),
            beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._corrected(index, self._get_lr(index))
        mean, var = state
        invoke("adam_update", weight, grad, mean, var, lr=lr,
               wd=self._get_wd(index), beta1=self.beta1, beta2=self.beta2,
               epsilon=self.epsilon, rescale_grad=self.rescale_grad,
               clip_gradient=_clip(self.clip_gradient))


@register
class AdamW(_AdamBase):
    """Adam with decoupled weight decay (reference: optimizer.AdamW): the
    bias correction scales the Adam step only, and the decay
    ``weight -= lr * wd * weight`` uses the raw lr."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, correct_bias=True, **kwargs):
        kwargs.setdefault("aggregate_num", _aggregate_default(64))
        super().__init__(learning_rate, beta1, beta2, epsilon, **kwargs)
        self.correct_bias = correct_bias

    def _step_lr(self, index, lr):
        return self._corrected(index, lr) if self.correct_bias else lr

    def fused_update(self, indices, weights, grads, states):
        return self._fused_apply(
            "adamw", indices, weights, grads, states, _moments_unpack,
            lr_fn=lambda pos, lr: self._step_lr(indices[pos], lr),
            decay_fn=lambda pos, lr, wd: lr * wd,
            beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        mean, var = state
        invoke("adamw_update", weight, grad, mean, var,
               lr=self._step_lr(index, lr), wd=0.0, eta=1.0,
               beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
               rescale_grad=self.rescale_grad,
               clip_gradient=_clip(self.clip_gradient))
        if wd:
            weight -= lr * wd * weight


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments, BERT's pretraining optimizer
    (reference: optimizer.LAMB -> lamb_update_phase1 / phase2)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        mean, var = state
        g_update = invoke("lamb_update_phase1", grad, weight, mean, var,
                          beta1=self.beta1, beta2=self.beta2,
                          epsilon=self.epsilon, t=t,
                          bias_correction=self.bias_correction, wd=wd,
                          rescale_grad=self.rescale_grad,
                          clip_gradient=_clip(self.clip_gradient))
        invoke("lamb_update_phase2", weight, g_update, lr=lr,
               lower_bound=_clip(self.lower_bound),
               upper_bound=_clip(self.upper_bound))


@register
class RMSProp(Optimizer):
    """RMSProp (reference: optimizer.RMSProp -> rmsprop_update; centred,
    with momentum, -> rmspropalex_update)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return tuple(_zeros_like(weight) for _ in range(3))
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad, gamma1=self.gamma1,
                  epsilon=self.epsilon,
                  clip_gradient=_clip(self.clip_gradient),
                  clip_weights=_clip(self.clip_weights))
        if self.centered:
            invoke("rmspropalex_update", weight, grad, *state,
                   gamma2=self.gamma2, **kw)
        else:
            invoke("rmsprop_update", weight, grad, state, **kw)


def _prepped(opt, grad):
    """``grad * rescale_grad``, clipped when the optimizer clips."""
    grad = grad * opt.rescale_grad
    if opt.clip_gradient is not None:
        grad = grad.clip(-opt.clip_gradient, opt.clip_gradient)
    return grad


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference: optimizer.AdaGrad): the history sums g^2, the
    decay stays outside the adaptive denominator."""

    def __init__(self, learning_rate=0.01, eps=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        grad = _prepped(self, grad)
        state += grad * grad
        div = grad / (state + self.float_stable_eps).sqrt()
        weight -= lr * (div + wd * weight)


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference: optimizer.AdaDelta); its two accumulators
    are float32 whatever the weight's dtype, as the reference's."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, ctx=weight.context),
                zeros(weight.shape, ctx=weight.context))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        grad = _prepped(self, grad) + wd * weight
        acc_g, acc_delta = state
        acc_g[:] = self.rho * acc_g + (1.0 - self.rho) * grad * grad
        current_delta = ((acc_delta + self.epsilon).sqrt() /
                         (acc_g + self.epsilon).sqrt()) * grad
        acc_delta[:] = self.rho * acc_delta + \
            (1.0 - self.rho) * current_delta * current_delta
        weight -= current_delta


@register
class Ftrl(Optimizer):
    """Follow the regularised leader (reference: optimizer.Ftrl ->
    ftrl_update); states z and n in float32."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (zeros(weight.shape, ctx=weight.context),
                zeros(weight.shape, ctx=weight.context))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        z, n = state
        invoke("ftrl_update", weight, grad, z, n, lr=self._get_lr(index),
               lamda1=self.lamda1, beta=self.beta, wd=self._get_wd(index),
               rescale_grad=self.rescale_grad,
               clip_gradient=_clip(self.clip_gradient))


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling (reference: optimizer.LARS): the
    lr scaled by ``eta * |w| / (|g| + wd * |w| + epsilon)``, read on the
    host, then SGD (with momentum)."""

    def __init__(self, learning_rate=0.1, momentum=0.0, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        w_norm = float(invoke("norm", weight).asscalar())
        g_norm = float(invoke("norm", _prepped(self, grad)).asscalar())
        if w_norm > 0 and g_norm > 0:
            lr = lr * self.eta * w_norm / \
                (g_norm + wd * w_norm + self.epsilon)
        kw = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                  clip_gradient=_clip(self.clip_gradient))
        if state is not None:
            invoke("sgd_mom_update", weight, grad, state,
                   momentum=self.momentum, **kw)
        else:
            invoke("sgd_update", weight, grad, **kw)


@register
class SignSGD(Optimizer):
    """SGD on the gradient's sign (reference: optimizer.SignSGD ->
    signsgd_update)."""

    def __init__(self, learning_rate=0.01, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        invoke("signsgd_update", weight, grad, lr=self._get_lr(index),
               wd=self._get_wd(index), rescale_grad=self.rescale_grad,
               clip_gradient=_clip(self.clip_gradient))


@register
class Signum(Optimizer):
    """The sign of a momentum (reference: optimizer.Signum ->
    signum_update; SignSGD's update without momentum)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad,
                  clip_gradient=_clip(self.clip_gradient))
        if state is not None:
            invoke("signum_update", weight, grad, state,
                   momentum=self.momentum, wd_lh=self.wd_lh, **kw)
        else:
            invoke("signsgd_update", weight, grad, **kw)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (reference: optimizer.DCASGD):
    the state keeps the momentum (None without one) and the previous
    weight."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = None if self.momentum == 0.0 else _zeros_like(weight)
        return (mom, weight.copy())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        grad = _prepped(self, grad)
        mom, previous_weight = state
        delta = -lr * (grad + wd * weight + self.lamda *
                       grad * grad * (weight - previous_weight))
        if mom is not None:
            mom[:] = self.momentum * mom + delta
            delta = mom
        previous_weight[:] = weight
        weight += delta


@register
class Test(Optimizer):
    """The reference's test optimizer: ``weight += grad * rescale_grad``,
    and the state keeps the new weight."""

    def create_state(self, index, weight):
        return zeros(weight.shape, ctx=weight.context)

    def update(self, index, weight, grad, state):
        weight += grad * self.rescale_grad
        state[:] = weight


@register
class FTML(Optimizer):
    """Follow the moving leader (reference: optimizer.FTML ->
    ftml_update); states d, v, z."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return tuple(_zeros_like(weight) for _ in range(3))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        d, v, z = state
        invoke("ftml_update", weight, grad, d, v, z,
               lr=self._get_lr(index), beta1=self.beta1, beta2=self.beta2,
               epsilon=self.epsilon, t=self._index_update_count[index],
               wd=self._get_wd(index), rescale_grad=self.rescale_grad,
               clip_grad=_clip(self.clip_gradient))


@register
class Adamax(Optimizer):
    """Adam on the infinity norm (reference: optimizer.Adamax, an update
    of nd ops)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index) / (1.0 - self.beta1 ** t)
        grad = grad * self.rescale_grad + self._get_wd(index) * weight
        if self.clip_gradient is not None:
            grad = grad.clip(-self.clip_gradient, self.clip_gradient)
        m, u = state
        m[:] = self.beta1 * m + (1.0 - self.beta1) * grad
        u[:] = invoke("maximum", self.beta2 * u, invoke("abs", grad))
        weight[:] = weight - lr * m / (u + 1e-8)


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum and a momentum schedule (reference:
    optimizer.Nadam, an update of nd ops).  ``m_schedule`` is one product
    over every update of every parameter, as in the reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index)
        grad = grad * self.rescale_grad + self._get_wd(index) * weight
        if self.clip_gradient is not None:
            grad = grad.clip(-self.clip_gradient, self.clip_gradient)
        mu_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        mu_tp1 = self.beta1 * (1.0 - 0.5 * 0.96 ** ((t + 1)
                                                    * self.schedule_decay))
        self.m_schedule = self.m_schedule * mu_t
        m_schedule_next = self.m_schedule * mu_tp1
        m, v = state
        m[:] = self.beta1 * m + (1.0 - self.beta1) * grad
        v[:] = self.beta2 * v + (1.0 - self.beta2) * grad * grad
        g_prime = grad / (1.0 - self.m_schedule)
        m_prime = m / (1.0 - m_schedule_next)
        v_prime = v / (1.0 - self.beta2 ** t)
        m_bar = (1.0 - mu_t) * g_prime + mu_tp1 * m_prime
        weight[:] = weight - lr * m_bar / (v_prime.sqrt() + self.epsilon)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference: optimizer.SGLD):
    a half-lr gradient step plus N(0, lr) noise.  The noise comes from
    ``generator`` (a ``torch.Generator`` on the weight's device) when one
    is given, else from ``mx.random``'s stream; its bits cannot match the
    reference's JAX keys."""

    def __init__(self, learning_rate=0.01, generator=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.generator = generator

    def create_state(self, index, weight):
        return None

    def _noise(self, weight, lr):
        if self.generator is None:
            return invoke("_random_normal", loc=0.0, scale=math.sqrt(lr),
                          shape=weight.shape, ctx=weight.context)
        draw = torch.randn(weight.shape, generator=self.generator,
                           device=weight.data.device)
        return NDArray(draw * math.sqrt(lr), weight.context)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        grad = _prepped(self, grad) + self._get_wd(index) * weight
        weight[:] = weight - lr / 2.0 * grad + self._noise(weight, lr)

    def __getstate__(self):
        ret = super().__getstate__()
        ret["generator"] = None
        return ret


def _state_tensors(state, out) -> None:
    if state is None:
        return
    if isinstance(state, (list, tuple)):
        for s in state:
            _state_tensors(s, out)
        return
    t = getattr(state, "_data", state)
    if isinstance(t, torch.Tensor):
        out.append(t)


def _updater_census_tensors(u):
    """One updater's slot-state tensors for the buffer census."""
    out: list = []
    for st in list(u.states.values()):
        _state_tensors(st, out)
    return out


class Updater:
    """Apply an optimizer to ``(index, grad, weight)`` triples, keeping each
    index's state (reference: class Updater).  Called with lists (one
    Trainer step), an optimizer with ``aggregate_num > 0`` and a fused form
    applies the whole group in one :func:`tree_apply` per chunk."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}
        self.states_synced: Dict[Any, bool] = {}
        # the buffer census: slot states (momenta, moments, fp32 masters)
        # under the "optimizer_state" owner
        from .. import programs as _programs
        _programs.track_buffers("optimizer_state", self,
                                _updater_census_tensors)

    @property
    def aggregate_updates(self):
        return self.optimizer.aggregate_num > 0

    def __call__(self, index, grad, weight):
        if not isinstance(index, (list, tuple)):
            index, grad, weight = [index], [grad], [weight]
        # update counts per device, as the reference's Updater keeps them
        ctx = weight[0].context
        self.optimizer._set_current_context((ctx.device_type, ctx.device_id))
        for i, w in zip(index, weight):
            if i not in self.states:
                self.states[i] = \
                    self.optimizer.create_state_multi_precision(i, w)
                self.states_synced[i] = True
            elif not self.states_synced.get(i, True):
                # loaded states go to their weight's context first (the
                # reference's sync_state_context): a Trainer gives every
                # context's updater the first context's states
                self.states[i] = _on_context(self.states[i], w.context)
                self.states_synced[i] = True
        todo = list(zip(index, grad, weight))
        if self.aggregate_updates and len(todo) > 1 and \
                self.optimizer.fused_update(
                    [i for i, _, _ in todo], [w for _, _, w in todo],
                    [g for _, g, _ in todo],
                    [self.states[i] for i, _, _ in todo]):
            return
        for i, g, w in todo:
            self.optimizer.update_multi_precision(i, w, g, self.states[i])

    def get_states(self, dump_optimizer=False):
        if dump_optimizer:
            return pickle.dumps((self.states, self.optimizer))
        return pickle.dumps(self.states)

    def set_states(self, states):
        loaded = pickle.loads(states)
        if isinstance(loaded, tuple) and len(loaded) == 2 and \
                isinstance(loaded[1], Optimizer):
            self.states, self.optimizer = loaded
        else:
            self.states = loaded
        self.states_synced = dict.fromkeys(self.states.keys(), False)


def _on_context(state, ctx):
    """An updater state (an NDArray, or nested tuples or lists of them)
    on ``ctx``."""
    if isinstance(state, NDArray):
        return state.as_in_context(ctx)
    if isinstance(state, (tuple, list)):
        return type(state)(_on_context(s, ctx) for s in state)
    return state


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
