"""Basic gluon layers as ``torch.nn.Module``s.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``, with the gluon
parameter names (``weight``, ``bias``, ``gamma``, ``beta``,
``running_mean``, ``running_var``).  ``in_units`` / ``in_channels`` of 0
(the default, as in the reference) leave the size to the first forward:
the layer's ``infer_shape`` reads it from the input (``Block.__call__``).
Each layer computes its op through ``registry.dispatch`` under the
reference's op name (``FullyConnected``, ``LayerNorm``, ``GroupNorm``,
``InstanceNorm``, ``Embedding``, ``Activation``, ``LeakyReLU``,
``flatten``, ``concat``, ``sigmoid``; a ``Lambda`` named by a string,
its op), where the
AMP policy casts the op's inputs.  The ``*_initializer`` keywords are the
reference's; each becomes its parameter's own ``init``, which the
reference's name rule applies (``initializer.Initializer.__call__``), so
``BatchNorm(gamma_initializer='zeros')`` keeps gamma at ones in both
packages.  Inside
``parallel.tensor.placement_scope`` a ``Dense`` or ``Embedding`` whose
weight is split over tp computes column-, row- or vocab-parallel; ``BatchNorm`` computes its op in parts
and takes the same cast (``registry.amp_cast``).
A parameter whose gluon ``grad_req`` is 'null' (BatchNorm's running
statistics; gamma without ``scale``, beta without ``center``) has
``requires_grad`` False, so ``backward`` on NDArrays writes it no
gradient and ``gluon.Trainer`` skips it; ``TrainStep`` still updates it
by its gradient, as the reference's step does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ... import initializer
from ...base import MXNetError
from ...ops import nn as _ops
from ...ops.registry import amp_cast, dispatch, get_op
from ...parallel import collectives as _coll
from ...parallel import tensor as _tensor
from ..block import Block, HybridBlock
from ..parameter import meta_parameter, param_handle, set_inits

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm",
           "Embedding", "Flatten", "Identity", "Lambda", "HybridLambda",
           "Concatenate", "HybridConcatenate", "GELU", "Activation",
           "LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "SiLU",
           "set_dropout_generator"]


class _Stack:
    """What ``Sequential`` and ``HybridSequential`` share: children named
    '0', '1', ... run in order; a slice of the stack is a new stack."""

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)
        return self

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x, *args)
            args = ()
        return x

    def __getitem__(self, key):
        layers = list(self._modules.values())
        if isinstance(key, slice):
            net = type(self)()
            net.add(*layers[key])
            return net
        return layers[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(_Stack, Block):
    """Stack of blocks run in order (gluon ``nn.Sequential``)."""


class HybridSequential(_Stack, HybridBlock):
    """Hybridizable stack of blocks (gluon ``nn.HybridSequential``)."""


class Dense(HybridBlock):
    """Fully connected layer; weight (units, in_units) as in gluon."""

    def __init__(self, units: int, activation=None, use_bias: bool = True,
                 flatten: bool = True, dtype="float32",
                 weight_initializer=None, bias_initializer="zeros",
                 in_units: int = 0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._act = activation
        self.weight = meta_parameter((units, in_units), dtype)
        self.bias = meta_parameter((units,), dtype) if use_bias else None
        set_inits(self, weight=weight_initializer, bias=bias_initializer)

    def infer_shape(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        param_handle(self, "weight").shape = (self._units, in_units)

    def forward(self, x):
        p = self._parameters
        bias = p.get("bias")
        place = _tensor.placement(self, "weight")
        if place is None:
            out = dispatch("FullyConnected", x, p["weight"], bias,
                           num_hidden=self._units, no_bias=bias is None,
                           flatten=self._flatten)
        else:
            out = _tensor.dense_forward(x, p["weight"], bias, self._units,
                                        self._flatten, place)
        if self._act:
            out = dispatch("Activation", out, act_type=self._act)
        return out

    def extra_repr(self):
        return "%d -> %d, %s" % (self.weight.shape[1], self._units,
                                 self._act or "linear")


class Dropout(HybridBlock):
    """Dropout with rate ``rate``, active only in training mode: each entry
    is kept with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``;
    ``axes`` share one draw along those axes.

    Masks are drawn from ``generator`` (a ``torch.Generator`` on the
    input's device, given here or by :func:`set_dropout_generator`), never
    from torch's global RNG, so a seed fixes every mask.  A training forward
    with ``rate > 0`` and no generator raises."""

    def __init__(self, rate: float, axes=(), generator=None, **kwargs):
        super().__init__(**kwargs)
        self._rate = float(rate)
        self._axes = tuple(axes)
        self.generator: Optional[torch.Generator] = generator

    def forward(self, x):
        if not self.training or self._rate == 0:
            return x
        if self.generator is None:
            raise MXNetError("Dropout(%g) in training mode needs a "
                             "torch.Generator: pass generator= or call "
                             "set_dropout_generator(net, generator)"
                             % self._rate)
        shape = list(x.shape)
        for a in self._axes:
            shape[a] = 1
        keep = 1.0 - self._rate
        mask = torch.rand(shape, generator=self.generator, device=x.device) \
            < keep
        return x * mask.to(x.dtype) / keep

    def extra_repr(self):
        return "p = %s, axes=%s" % (self._rate, self._axes)


def set_dropout_generator(block: torch.nn.Module,
                          generator: torch.Generator) -> torch.nn.Module:
    """Give every :class:`Dropout` and every recurrent layer
    (``gluon.rnn.RNN``, ``LSTM``, ``GRU``: their dropout between layers) in
    ``block``'s tree the one ``generator``, so their masks are successive
    draws of one seeded stream; returns ``block``."""
    from ..rnn.rnn_layer import _RNNLayer
    for m in block.modules():
        if isinstance(m, (Dropout, _RNNLayer)):
            m.generator = generator
    return block


class BatchNorm(HybridBlock):
    """Batch normalisation over ``axis`` (the channels) with parameters
    ``gamma``, ``beta``, ``running_mean`` (zeros at init) and
    ``running_var`` (ones).

    In training mode, unless ``use_global_stats``, a forward normalises by
    the batch's statistics; otherwise by the running ones.  The running
    statistics are written (``momentum * old + (1 - momentum) * batch``,
    biased variance, in their own dtype) only by a training forward called
    on NDArrays (:meth:`Block.__call__` under ``autograd`` training), as
    the reference writes them; a forward on tensors, as ``functionalize``
    and ``TrainStep`` run it, leaves them as they are.  Inside a
    :class:`~...parallel.collectives.batch_stats_scope` (the dp
    ``TrainStep`` over more than one rank) the batch statistics are the
    whole batch's, over the ranks of the scope's axis."""

    def __init__(self, axis: int = 1, momentum: float = 0.9,
                 epsilon: float = 1e-5, center: bool = True,
                 scale: bool = True, use_global_stats: bool = False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones",
                 in_channels: int = 0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._eps = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        self.gamma = meta_parameter((in_channels,), requires_grad=scale)
        self.beta = meta_parameter((in_channels,), requires_grad=center)
        self.running_mean = meta_parameter((in_channels,),
                                           requires_grad=False)
        self.running_var = meta_parameter((in_channels,),
                                          requires_grad=False)
        set_inits(self, gamma=gamma_initializer, beta=beta_initializer,
                  running_mean=running_mean_initializer,
                  running_var=running_variance_initializer)

    def infer_shape(self, x, *args):
        for attr in ("gamma", "beta", "running_mean", "running_var"):
            param_handle(self, attr).shape = (x.shape[self._axis],)

    _OP = get_op("BatchNorm")

    def forward(self, x):
        batch = self.training and not self._use_global_stats
        p = self._parameters
        x, gamma, beta, mean, var = amp_cast(
            self._OP, {}, (x, p["gamma"], p["beta"], p["running_mean"],
                           p["running_var"]))
        line = _coll.batch_stats_line() if batch else None
        if line is not None:
            g = gamma if self._scale else torch.ones_like(gamma)
            out, b_mean, b_var = _coll.global_batch_norm(
                x, g, beta, self._eps, self._axis, *line.line)
            line.stats.append((b_mean, b_var))
            if self._write_aux:
                m = self._momentum
                with torch.no_grad():
                    p["running_mean"].copy_(m * mean + (1.0 - m) * b_mean)
                    p["running_var"].copy_(m * var + (1.0 - m) * b_var)
            return out
        out = _ops.batch_norm_out(x, gamma, beta, mean, var, self._eps,
                                  not self._scale, batch, self._axis)
        if batch and self._write_aux:
            mean, var = _ops.batch_norm_stats(x, mean, var, self._momentum,
                                              self._axis)
            with torch.no_grad():
                p["running_mean"].copy_(mean)
                p["running_var"].copy_(var)
        return out

    def extra_repr(self):
        return "axis=%s, eps=%s, momentum=%s, in_channels=%d" % (
            self._axis, self._eps, self._momentum, self.gamma.shape[0])


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm (reference: ``contrib.nn.SyncBatchNorm``):
    :class:`BatchNorm` outside the dp step, so that in the eager loop over
    several contexts each copy normalises by its own slice of the batch,
    as in the reference; inside the dp ``TrainStep`` over more than one
    rank it (like every BatchNorm there) normalises by the global batch's
    statistics.  ``num_devices`` is kept and not read."""

    def __init__(self, in_channels: int = 0, num_devices=None, **kwargs):
        super().__init__(in_channels=in_channels, **kwargs)
        self._num_devices = num_devices


class LayerNorm(HybridBlock):
    """Layer normalisation over ``axis``; parameters ``gamma``/``beta``
    (``grad_req`` 'null' without ``scale`` / ``center``)."""

    def __init__(self, axis: int = -1, epsilon: float = 1e-5,
                 center: bool = True, scale: bool = True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels: int = 0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._eps = epsilon
        self.gamma = meta_parameter((in_channels,), requires_grad=scale)
        self.beta = meta_parameter((in_channels,), requires_grad=center)
        set_inits(self, gamma=gamma_initializer, beta=beta_initializer)

    def infer_shape(self, x, *args):
        for attr in ("gamma", "beta"):
            param_handle(self, attr).shape = (x.shape[self._axis],)

    def forward(self, x):
        p = self._parameters
        return dispatch("LayerNorm", x, p["gamma"], p["beta"],
                        axis=self._axis, eps=self._eps)


class _ChannelNorm(HybridBlock):
    """What GroupNorm and InstanceNorm share: ``gamma`` (ones) and
    ``beta`` (zeros) per channel (axis 1), ``grad_req`` 'null' without
    ``scale`` / ``center``."""

    def __init__(self, epsilon, center, scale, in_channels, **kwargs):
        super().__init__(**kwargs)
        self._eps = epsilon
        self.gamma = meta_parameter((in_channels,), requires_grad=scale)
        self.beta = meta_parameter((in_channels,), requires_grad=center)

    def infer_shape(self, x, *args):
        for attr in ("gamma", "beta"):
            param_handle(self, attr).shape = (x.shape[1],)


class GroupNorm(_ChannelNorm):
    """Group normalisation: the channels in ``num_groups`` groups, each
    normalised over its channels and the spatial axes."""

    def __init__(self, num_groups: int = 1, epsilon: float = 1e-5,
                 center: bool = True, scale: bool = True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels: int = 0, **kwargs):
        super().__init__(epsilon, center, scale, in_channels, **kwargs)
        set_inits(self, gamma=gamma_initializer, beta=beta_initializer)
        self._groups = num_groups

    def forward(self, x):
        p = self._parameters
        return dispatch("GroupNorm", x, p["gamma"], p["beta"],
                        num_groups=self._groups, eps=self._eps)


class InstanceNorm(_ChannelNorm):
    """Instance normalisation: each channel of each example over its
    spatial axes; ``scale`` is off by default, and it takes no initializer
    keywords, as in the reference."""

    def __init__(self, axis: int = 1, epsilon: float = 1e-5,
                 center: bool = True, scale: bool = False,
                 in_channels: int = 0, **kwargs):
        super().__init__(epsilon, center, scale, in_channels, **kwargs)

    def forward(self, x):
        p = self._parameters
        return dispatch("InstanceNorm", x, p["gamma"], p["beta"],
                        eps=self._eps)


class Embedding(HybridBlock):
    """Lookup table (input_dim, output_dim).  ``sparse_grad=True`` (a
    row-sparse gradient) raises: sparse storage is Queue 1 item 8."""

    def __init__(self, input_dim: int, output_dim: int, dtype="float32",
                 weight_initializer=None, sparse_grad: bool = False,
                 **kwargs):
        if sparse_grad:
            raise MXNetError("Embedding(sparse_grad=True): row-sparse "
                             "gradients wait for sparse storage (Queue 1 "
                             "item 8)")
        super().__init__(**kwargs)
        self._dims = (input_dim, output_dim)
        self.weight = meta_parameter((input_dim, output_dim), dtype)
        set_inits(self, weight=weight_initializer)

    def forward(self, x):
        place = _tensor.placement(self, "weight")
        if place is not None:
            return _tensor.embedding_forward(x, self._parameters["weight"],
                                             place)
        return dispatch("Embedding", x, self._parameters["weight"],
                        input_dim=self._dims[0], output_dim=self._dims[1])


class Flatten(HybridBlock):
    """All axes but the first folded into one (the ``flatten`` op)."""

    def forward(self, x):
        return dispatch("flatten", x)


class Identity(HybridBlock):
    """The input, unchanged."""

    def forward(self, x):
        return x


class Lambda(Block):
    """A function as a block: ``function`` takes and gives the forward's
    tensors; a string names an ``nd`` function (a registered op), which
    runs through ``registry.dispatch``."""

    def __init__(self, function, **kwargs):
        super().__init__(**kwargs)
        if isinstance(function, str):
            get_op(function)            # an unknown name raises here
            self._func = lambda *args, _name=function: dispatch(_name, *args)
            self._name = function
        else:
            self._func = function
            self._name = getattr(function, "__name__", "lambda")

    def forward(self, *args):
        return self._func(*args)

    def extra_repr(self):
        return self._name


class HybridLambda(Lambda, HybridBlock):
    """:class:`Lambda` under the reference's hybrid name."""


class _Concat:
    """What ``Concatenate`` and ``HybridConcatenate`` share: every child
    on the same input, their outputs joined along ``axis``."""

    def __init__(self, axis: int = -1, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis

    def forward(self, x):
        return dispatch("concat", *[block(x) for block in
                                    self._modules.values()], dim=self._axis)


class Concatenate(_Concat, Sequential):
    """Children run on one input, outputs concatenated (gluon
    ``nn.Concatenate``)."""


class HybridConcatenate(_Concat, HybridSequential):
    """Hybridizable :class:`Concatenate`."""


class Activation(HybridBlock):
    def __init__(self, activation: str, **kwargs):
        super().__init__(**kwargs)
        self._act = activation

    def forward(self, x):
        return dispatch("Activation", x, act_type=self._act)


class _LeakyFamily(HybridBlock):
    """A layer of the ``LeakyReLU`` op with a fixed ``act_type`` and
    ``slope``."""

    _act_type = "leaky"

    def __init__(self, slope: float = 0.25, **kwargs):
        super().__init__(**kwargs)
        self._slope = slope

    def forward(self, x):
        return dispatch("LeakyReLU", x, act_type=self._act_type,
                        slope=self._slope)


class LeakyReLU(_LeakyFamily):
    """``alpha * x`` below 0."""

    def __init__(self, alpha: float = 0.01, **kwargs):
        super().__init__(alpha, **kwargs)


class ELU(_LeakyFamily):
    """``alpha * (exp(x) - 1)`` below 0."""

    _act_type = "elu"

    def __init__(self, alpha: float = 1.0, **kwargs):
        super().__init__(alpha, **kwargs)


class SELU(_LeakyFamily):
    """Scaled ELU with the self-normalising constants."""

    _act_type = "selu"


class GELU(_LeakyFamily):
    """Exact (erf) GELU."""

    _act_type = "gelu"

    def __init__(self, approximation: str = "erf", **kwargs):
        super().__init__(**kwargs)


class PReLU(HybridBlock):
    """A learned slope ``alpha`` below 0, one per channel (axis 1),
    initialised by ``alpha_initializer`` (0.25)."""

    def __init__(self, alpha_initializer=None, in_channels: int = 1,
                 **kwargs):
        super().__init__(**kwargs)
        self.alpha = meta_parameter((in_channels,))
        param_handle(self, "alpha").init = alpha_initializer or \
            initializer.Constant(0.25)

    def forward(self, x):
        return dispatch("LeakyReLU", x, self._parameters["alpha"],
                        act_type="prelu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def forward(self, x):
        return x * dispatch("sigmoid", x * self._beta)


SiLU = Swish
