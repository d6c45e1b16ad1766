"""The nn functions of the serving and training slices, on tensors.

Counterpart of the matching entries of ``mxnet_tpu/ops/nn.py`` and
``mxnet_tpu/ops/matrix.py`` (``Embedding``, ``pick``).  Plain matrix
products, convolutions, pooling and batch norm stay with PyTorch's library
kernels (cuBLAS, cuDNN), as the JAX package left them to XLA.  The ops
are registered under the reference's names and signatures
(``FullyConnected``, ``Activation``, ``LeakyReLU``, ``LayerNorm``,
``GroupNorm``, ``InstanceNorm``, ``Embedding``, ``multi_head_attention``,
``softmax``, ``log_softmax``, ``softmax_cross_entropy``, ``pick``,
``Dropout``, ``Convolution``, ``Deconvolution``, ``Pooling``,
``BatchNorm``, ``CTCLoss``), and the gluon layers reach them through
``registry.dispatch``, where the AMP cast is applied.

A float32 convolution runs with cuDNN's TF32 off, in its forward and its
backward, whatever ``torch.backends.cudnn.allow_tf32`` says outside it:
TF32 would move it about 1e-3 from the reference.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..base import torch_dtype
from .attention import attention_core
from .registry import register

__all__ = ["fully_connected", "activation", "gelu", "leaky_relu",
           "layer_norm", "group_norm", "instance_norm",
           "embedding", "multi_head_attention", "softmax", "log_softmax",
           "softmax_cross_entropy", "pick", "dropout", "convolution",
           "deconvolution", "pooling", "batch_norm", "batch_norm_out",
           "batch_norm_stats", "ctc_loss"]


@register("FullyConnected", aliases=["fully_connected"])
def fully_connected(data: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    num_hidden: Optional[int] = None, no_bias: bool = False,
                    flatten: bool = True) -> torch.Tensor:
    """``data @ weight.T + bias`` with weight (num_hidden, in_units);
    ``flatten`` folds all but the leading axis first; ``no_bias`` drops
    the bias."""
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 \
        else data
    return F.linear(x, weight, None if no_bias else bias)


def gelu(data: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, the JAX package's ``LeakyReLU(act_type='gelu')``."""
    return F.gelu(data, approximate="none")


@register("Activation", aliases=["activation"])
def activation(data: torch.Tensor, act_type: str = "relu") -> torch.Tensor:
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    if act_type == "softsign":
        return F.softsign(data)
    if act_type == "gelu":
        return gelu(data)
    if act_type == "log_sigmoid":
        return F.logsigmoid(data)
    if act_type == "mish":
        return data * torch.tanh(F.softplus(data))
    raise ValueError("bad act_type %r" % act_type)


_SELU_ALPHA, _SELU_LAMBDA = 1.6732632423543772, 1.0507009873554805


@register("LeakyReLU", aliases=["leaky_relu", "_npx_leaky_relu"])
def leaky_relu(data: torch.Tensor, gamma: Optional[torch.Tensor] = None,
               act_type: str = "leaky", slope: float = 0.25,
               lower_bound: float = 0.125,
               upper_bound: float = 0.334) -> torch.Tensor:
    """The LeakyReLU family: ``leaky`` (``slope * x`` below 0), ``prelu``
    (a learned ``gamma`` per channel, axis 1), ``elu``, ``selu``, ``gelu``
    (erf), ``gelu_tanh`` and ``rrelu`` (in its deterministic inference
    form, slope ``(lower_bound + upper_bound) / 2``)."""
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if data.dim() > 2 else gamma
        return torch.where(data >= 0, data, g * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * (torch.exp(data) - 1.0))
    if act_type == "selu":
        return _SELU_LAMBDA * torch.where(
            data >= 0, data, _SELU_ALPHA * (torch.exp(data) - 1.0))
    if act_type == "gelu":
        return gelu(data)
    if act_type == "gelu_tanh":
        return F.gelu(data, approximate="tanh")
    if act_type == "rrelu":
        return torch.where(data >= 0, data,
                           data * ((lower_bound + upper_bound) / 2))
    raise ValueError("bad act_type %r" % act_type)


@register("LayerNorm", aliases=["layer_norm"])
def layer_norm(data: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               axis: int = -1, eps: float = 1e-5,
               output_mean_var: bool = False) -> torch.Tensor:
    """Normalise in float32, cast back to data's dtype, then scale and
    shift, in the JAX package's order."""
    if output_mean_var:
        raise NotImplementedError("LayerNorm(output_mean_var=True)")
    x32 = data.float()
    mean = x32.mean(dim=axis, keepdim=True)
    var = x32.var(dim=axis, keepdim=True, unbiased=False)
    norm = ((x32 - mean) * torch.rsqrt(var + eps)).to(data.dtype)
    shape = _channel_shape(data, axis)
    return norm * gamma.reshape(shape) + beta.reshape(shape)


@register("GroupNorm")
def group_norm(data: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               num_groups: int = 1, eps: float = 1e-5) -> torch.Tensor:
    """Normalise each of ``num_groups`` channel groups of each example
    over its channels and spatial axes, in float32; then cast back and
    scale and shift per channel."""
    n, c = data.shape[:2]
    x = data.reshape(n, num_groups, c // num_groups, *data.shape[2:]).float()
    red = tuple(range(2, x.dim()))
    var, mean = torch.var_mean(x, dim=red, keepdim=True, correction=0)
    norm = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape) \
        .to(data.dtype)
    shape = _channel_shape(data, 1)
    return norm * gamma.reshape(shape) + beta.reshape(shape)


@register("InstanceNorm")
def instance_norm(data: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Normalise each channel of each example over its spatial axes, in
    float32; then cast back and scale and shift per channel."""
    red = tuple(range(2, data.dim()))
    x32 = data.float()
    var, mean = torch.var_mean(x32, dim=red, keepdim=True, correction=0)
    norm = ((x32 - mean) * torch.rsqrt(var + eps)).to(data.dtype)
    shape = _channel_shape(data, 1)
    return norm * gamma.reshape(shape) + beta.reshape(shape)


@register("Embedding", aliases=["embedding"])
def embedding(data: torch.Tensor, weight: torch.Tensor,
              input_dim: Optional[int] = None,
              output_dim: Optional[int] = None, dtype="float32",
              sparse_grad: bool = False) -> torch.Tensor:
    """Row gather with ``jnp.take``'s semantics: indices are truncated to
    integers, -n <= i < 0 wraps, and an index outside [-n, n) gives a row
    of NaN (never a device fault).  The sizes come from ``weight``; the
    other parameters are the reference op's, unused."""
    n = weight.shape[0]
    idx = data.long()
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    out = F.embedding(idx.clamp(0, n - 1), weight)
    return out.masked_fill(~valid.unsqueeze(-1), float("nan"))


@register("multi_head_attention")
def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         num_heads: int = 1, scaled: bool = True,
                         causal: bool = False,
                         units: Optional[int] = None) -> torch.Tensor:
    """q, k, v: (B, T, H*D); mask broadcastable to (B, H, Tq, Tk);
    ``units`` is carried for the reference's export and unused.
    Splits the heads to (B, H, T, D), runs :func:`attention_core` and
    merges them back."""
    B, Tq, HD = q.shape
    D = HD // num_heads
    qh = q.reshape(B, Tq, num_heads, D).transpose(1, 2)
    kh = k.reshape(B, -1, num_heads, D).transpose(1, 2)
    vh = v.reshape(B, -1, num_heads, D).transpose(1, 2)
    scale = (1.0 / math.sqrt(D)) if scaled else 1.0
    out = attention_core(qh, kh, vh, scale=scale, causal=causal, mask=mask)
    return out.transpose(1, 2).reshape(B, Tq, HD)


def softmax(data: torch.Tensor, axis: int = -1,
            temperature: Optional[float] = None,
            length: Optional[torch.Tensor] = None, use_length: bool = False,
            dtype=None) -> torch.Tensor:
    """Softmax over ``axis``, optionally divided by ``temperature``; with
    ``use_length``, positions at or past ``length`` (one per leading-axis
    row) get probability 0.  The result is in ``dtype`` or data's dtype."""
    x = data if temperature in (None, 1.0) else data / temperature
    if use_length and length is not None:
        steps = torch.arange(x.shape[axis], device=x.device)
        bshape = [1] * x.dim()
        bshape[axis] = x.shape[axis]
        mask = steps.reshape(bshape) < length.reshape(
            [x.shape[0]] + [1] * (x.dim() - 1))
        x = x.masked_fill(~mask, float("-inf"))
    out = torch.softmax(x, dim=axis)
    if use_length and length is not None:
        out = torch.nan_to_num(out, nan=0.0)
    return out.to(torch_dtype(dtype) if dtype else data.dtype)


def log_softmax(data: torch.Tensor, axis: int = -1,
                temperature: Optional[float] = None,
                dtype=None) -> torch.Tensor:
    """Log-softmax over ``axis``, in ``dtype`` or data's dtype."""
    x = data if temperature in (None, 1.0) else data / temperature
    return torch.log_softmax(x, dim=axis).to(
        torch_dtype(dtype) if dtype else data.dtype)


@register("pick")
def pick(x: torch.Tensor, index: torch.Tensor, axis: int = -1,
         keepdims: bool = False, mode: str = "clip") -> torch.Tensor:
    """``x``'s entry at ``index`` along ``axis``; indices are truncated to
    integers and clipped to the axis (the JAX package clips in every
    mode)."""
    ax = axis % x.dim()
    idx = index.long().clamp(0, x.shape[ax] - 1).unsqueeze(ax)
    out = torch.gather(x, ax, idx)
    return out if keepdims else out.squeeze(ax)


@register("softmax_cross_entropy")
def softmax_cross_entropy(data: torch.Tensor,
                          label: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of ``log_softmax(data)`` against integer labels
    over the last axis.  A label outside [0, n) adds nothing, as its one-hot
    row in the JAX package is all zeros."""
    logp = torch.log_softmax(data, dim=-1)
    lab = label.long()
    valid = (lab >= 0) & (lab < data.shape[-1])
    return -pick(logp, lab, axis=-1).masked_fill(~valid, 0.0).sum()


register("softmax", softmax, aliases=["Softmax"])
register("log_softmax", log_softmax)


@register("softmin")
def softmin(data: torch.Tensor, axis: int = -1,
            temperature: Optional[float] = None, dtype=None) -> torch.Tensor:
    """The softmax of ``-data``."""
    return softmax(-data, axis=axis, temperature=temperature, dtype=dtype)


@register("SoftmaxOutput", aliases=["softmax_output"])
def softmax_output(data: torch.Tensor, label: torch.Tensor,
                   grad_scale: float = 1.0, ignore_label: float = -1.0,
                   multi_output: bool = False, use_ignore: bool = False,
                   preserve_shape: bool = False, normalization: str = "null",
                   out_grad: bool = False,
                   smooth_alpha: float = 0.0) -> torch.Tensor:
    """The softmax over axis 1 (``multi_output``) or the last axis.  As in
    the JAX package its gradient is that forward's VJP: the loss gradient
    (upstream MXNet's ``p - onehot``) comes from the loss or Module level,
    not from the op."""
    return torch.softmax(data, dim=1 if multi_output else -1)


@register("LinearRegressionOutput", aliases=["linear_regression_output"])
def linear_regression_output(data: torch.Tensor, label: torch.Tensor,
                             grad_scale: float = 1.0) -> torch.Tensor:
    """The identity (a copy: the output must not alias ``data``); the l2
    loss gradient comes from the Module level, as in the JAX package."""
    return data.clone()


@register("MAERegressionOutput", aliases=["mae_regression_output"])
def mae_regression_output(data: torch.Tensor, label: torch.Tensor,
                          grad_scale: float = 1.0) -> torch.Tensor:
    """The identity (a copy), as :func:`linear_regression_output`."""
    return data.clone()


@register("LogisticRegressionOutput", aliases=["logistic_regression_output"])
def logistic_regression_output(data: torch.Tensor, label: torch.Tensor,
                               grad_scale: float = 1.0) -> torch.Tensor:
    """The sigmoid of ``data``."""
    return torch.sigmoid(data)


@register("RMSNorm")
def rms_norm(data: torch.Tensor, gamma: torch.Tensor, axis: int = -1,
             eps: float = 1e-6) -> torch.Tensor:
    """Normalise by the root mean square over ``axis`` in float32, cast
    back to data's dtype, then scale by ``gamma``, in the JAX package's
    order."""
    x32 = data.float()
    ms = x32.square().mean(dim=axis, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps)).to(data.dtype) * gamma


@register("Dropout", aliases=["dropout"])
def dropout(data: torch.Tensor, p: float = 0.5, mode: str = "training",
            axes=(), cudnn_off: bool = False, training: bool = True,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The ``Dropout`` op: with ``training``, each entry is kept with
    probability ``1 - p`` and scaled by ``1 / (1 - p)``; ``axes`` share one
    draw along those axes.  Masks come from ``generator``, or from torch's
    default generator of the data's device (seeded by ``torch.manual_seed``,
    the role of ``mx.random.seed``).  The block :class:`gluon.nn.Dropout`
    asks for an explicit generator instead."""
    if not training or p <= 0.0:
        return data
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    keep = 1.0 - p
    mask = torch.rand(shape, generator=generator, device=data.device) < keep
    return data * mask.to(data.dtype) / keep


# ---------------------------------------------------------------------------
# Convolution, Deconvolution, Pooling, BatchNorm (NCW / NCHW / NCDHW)
# ---------------------------------------------------------------------------


def _tup(v, n):
    if v is None:
        return (0,) * n
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    return v if len(v) == n else v + v[-1:] * (n - len(v))


@contextlib.contextmanager
def _cudnn_without_tf32():
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


class _Float32Conv(torch.autograd.Function):
    """``aten.convolution`` and its backward, each inside
    :func:`_cudnn_without_tf32` (the backward runs after the forward's
    scope has closed, so it needs its own)."""

    @staticmethod
    def forward(ctx, data, weight, conf):
        ctx.save_for_backward(data, weight)
        ctx.conf = conf
        with _cudnn_without_tf32():
            return torch.ops.aten.convolution(data, weight, None, *conf)

    @staticmethod
    def backward(ctx, grad):
        data, weight = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with _cudnn_without_tf32():
            gd, gw, _ = torch.ops.aten.convolution_backward(
                grad, data, weight, None, *ctx.conf, mask)
        return gd, gw, None


def _conv(data, weight, stride, pad, dilate, transposed, adj, groups):
    conf = (list(stride), list(pad), list(dilate), transposed, list(adj),
            groups)
    if data.dtype == torch.float32:
        return _Float32Conv.apply(data, weight, conf)
    return torch.ops.aten.convolution(data, weight, None, *conf)


def _add_channel_bias(out, bias, n):
    return out + bias.reshape((1, -1) + (1,) * n)


@register("Convolution", aliases=["convolution"])
def convolution(data: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, kernel=None,
                stride=None, dilate=None, pad=None, num_filter=None,
                num_group: int = 1, no_bias: bool = False, cudnn_tune=None,
                cudnn_off: bool = False, workspace: int = 1024,
                layout=None) -> torch.Tensor:
    """Cross-correlation of ``data`` (N, C, *spatial) with ``weight``
    (num_filter, C / num_group, *kernel), cast to data's dtype, plus
    ``bias`` per output channel unless ``no_bias``."""
    n = len(kernel)
    out = _conv(data, weight, _tup(stride or 1, n), _tup(pad, n),
                _tup(dilate or 1, n), False, (0,) * n, num_group)
    out = out.to(data.dtype)
    if bias is not None and not no_bias:
        out = _add_channel_bias(out, bias, n)
    return out


@register("Deconvolution", aliases=["deconvolution"])
def deconvolution(data: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, kernel=None,
                  stride=None, dilate=None, pad=None, adj=None,
                  num_filter=None, num_group: int = 1, no_bias: bool = True,
                  target_shape=None, cudnn_tune=None, cudnn_off: bool = False,
                  workspace: int = 1024, layout=None) -> torch.Tensor:
    """The transpose of :func:`convolution`: ``weight`` is (C,
    num_filter / num_group, *kernel), ``adj`` extends the output on the
    right of each spatial axis."""
    n = len(kernel)
    out = _conv(data, weight, _tup(stride or 1, n), _tup(pad, n),
                _tup(dilate or 1, n), True, _tup(adj or 0, n), num_group)
    if bias is not None and not no_bias:
        out = _add_channel_bias(out, bias, n)
    return out


def _window_sum(x, kernel, stride):
    """Sum over each window (no padding), through ``avg_pool`` with a
    divisor of 1; a 1-D input goes through the 2-D pool."""
    if len(kernel) == 1:
        return F.avg_pool2d(x.unsqueeze(-2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(-2)
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


@register("Pooling", aliases=["pooling"])
def pooling(data: torch.Tensor, kernel=None, pool_type: str = "max",
            global_pool: bool = False, stride=None, pad=None,
            pooling_convention: str = "valid", count_include_pad: bool = True,
            cudnn_off: bool = False, layout=None, p_value=2) -> torch.Tensor:
    """Max, avg, sum or lp pooling over the spatial axes.

    The input is padded here, with -inf for max and 0 otherwise, and then
    pooled with no padding of the library's own.  The ``full`` convention
    (gluon's ``ceil_mode``) pads the right of each axis by ``max(needed -
    pad, pad)``, the reference's rule, so a last window can lie wholly in
    the padding (max -inf there, avg 0) where torch's ``ceil_mode`` would
    drop it.  ``global_pool`` is the max or the mean over the spatial
    axes."""
    n = data.dim() - 2
    if global_pool:
        axes = tuple(range(2, data.dim()))
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        return data.mean(dim=axes, keepdim=True)
    kernel = _tup(kernel, n)
    stride = _tup(stride or kernel, n)
    pad = _tup(pad, n)
    pads = []
    for i in range(n):
        right = pad[i]
        if pooling_convention == "full":
            size = data.shape[2 + i]
            out = -(-(size + 2 * pad[i] - kernel[i]) // stride[i]) + 1
            needed = (out - 1) * stride[i] + kernel[i] - size
            right = max(needed - pad[i], pad[i])
        pads.append((pad[i], right))
    flat = [p for lr in reversed(pads) for p in lr]    # F.pad: last axis first
    if pool_type == "max":
        fill = float("-inf") if data.is_floating_point() \
            else torch.iinfo(data.dtype).min
        return _MAX_POOL[n](F.pad(data, flat, value=fill), kernel, stride)
    if pool_type in ("avg", "sum"):
        summed = _window_sum(F.pad(data, flat), kernel, stride)
        if pool_type == "sum":
            return summed
        if count_include_pad:
            return summed / math.prod(kernel)
        ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                          device=data.device)
        return summed / _window_sum(F.pad(ones, flat), kernel, stride)
    if pool_type == "lp":
        powed = _window_sum(F.pad(data.abs() ** p_value, flat), kernel,
                            stride)
        return powed ** (1.0 / p_value)
    raise ValueError("bad pool_type %r" % pool_type)


@register("AdaptiveAvgPooling2D", aliases=["_contrib_AdaptiveAvgPooling2D"])
def adaptive_avg_pooling_2d(data: torch.Tensor,
                            output_size=1) -> torch.Tensor:
    """The mean over equal bins, by a reshape, as in the JAX package.  A
    size that the output size does not divide raises there (its reshape
    fails), so it raises here too, rather than taking
    ``F.adaptive_avg_pool2d``'s uneven bins."""
    oh, ow = _tup(output_size, 2)
    n, c, h, w = data.shape
    if h % oh or w % ow:
        raise TypeError("AdaptiveAvgPooling2D: cannot reshape array of shape "
                        "%s into equal %d x %d bins"
                        % (tuple(data.shape), oh, ow))
    return data.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))


_F32_EPS = float(torch.finfo(torch.float32).eps)


def _linear_resize_weights(in_size: int, out_size: int,
                           device) -> torch.Tensor:
    """The (in_size, out_size) weights of ``jax.image.resize``'s ``linear``
    method along one axis: half-pixel centres and a triangle kernel,
    widened by the scale when shrinking (jax antialiases by default),
    each column normalised, and zero for a sample outside the input.  The
    arithmetic is float32, step for step ``compute_weight_mat``'s."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample_f = (torch.arange(out_size, dtype=f32, device=device) + 0.5) \
        * inv_scale - 0.0 - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32,
                                          device=device)[:, None]).abs() \
        / kernel_scale
    weights = (1.0 - x.abs()).clamp_min(0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * _F32_EPS,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _resize_linear(data: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """``jax.image.resize(data, (n, c, th, tw), method="linear")`` as two
    products with explicit weight matrices (an axis whose size does not
    change is left as it is, as jax does)."""
    x = data if data.is_floating_point() else data.float()
    h, w = x.shape[2], x.shape[3]
    if th != h:
        x = torch.einsum("nchw,ho->ncow", x,
                         _linear_resize_weights(h, th, x.device).to(x.dtype))
    if tw != w:
        x = torch.einsum("nchw,wp->nchp", x,
                         _linear_resize_weights(w, tw, x.device).to(x.dtype))
    return x


@register("BilinearResize2D", aliases=["_contrib_BilinearResize2D"])
def bilinear_resize_2d(data: torch.Tensor, height=None, width=None,
                       scale_height=None, scale_width=None,
                       mode: str = "size") -> torch.Tensor:
    """Resize the spatial axes to ``height`` x ``width`` (or by the
    scales), with ``jax.image.resize``'s linear method: it antialiases
    when it shrinks, where ``F.interpolate(mode="bilinear")`` does not."""
    h, w = data.shape[2], data.shape[3]
    th = height or int(h * scale_height)
    tw = width or int(w * scale_width)
    return _resize_linear(data, th, tw)


@register("UpSampling")
def up_sampling(data: torch.Tensor, scale: int = 2,
                sample_type: str = "nearest", num_args: int = 1
                ) -> torch.Tensor:
    """Enlarge the spatial axes by ``scale``: each pixel repeated
    (``nearest``), or ``jax.image.resize``'s linear method."""
    if sample_type == "nearest":
        return data.repeat_interleave(scale, dim=2).repeat_interleave(
            scale, dim=3)
    h, w = data.shape[2], data.shape[3]
    return _resize_linear(data, h * scale, w * scale)


def _channel_shape(data, axis):
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return shape


def batch_norm_out(data: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, moving_mean: torch.Tensor,
                   moving_var: torch.Tensor, eps: float = 1e-5,
                   fix_gamma: bool = True, batch_stats: bool = True,
                   axis: int = 1) -> torch.Tensor:
    """BatchNorm's output alone, in data's dtype.  With ``batch_stats``
    the statistics are the batch's (over every axis but ``axis``, biased
    variance) and ``F.batch_norm`` normalises; otherwise the moving
    statistics normalise in the reference's order, ``(data - mean) *
    (rsqrt(var + eps) * gamma) + beta`` with each factor cast to data's
    dtype, so that they receive gradients as they do there.  ``fix_gamma``
    takes gamma as ones."""
    ax = axis % data.dim()
    g = torch.ones_like(gamma) if fix_gamma else gamma
    g, b = g.to(data.dtype), beta.to(data.dtype)
    if batch_stats:
        x = data if ax == 1 else data.movedim(ax, 1)
        out = F.batch_norm(x, None, None, g, b, training=True, eps=eps)
        return out if ax == 1 else out.movedim(1, ax)
    shape = _channel_shape(data, ax)
    inv = torch.rsqrt(moving_var + eps).to(data.dtype)
    return (data - moving_mean.reshape(shape).to(data.dtype)) * \
        (inv * g).reshape(shape) + b.reshape(shape)


def batch_norm_stats(data: torch.Tensor, moving_mean: torch.Tensor,
                     moving_var: torch.Tensor, momentum: float = 0.9,
                     axis: int = 1):
    """The new moving statistics after a batch: ``momentum * old + (1 -
    momentum) * batch``, the batch's mean and biased variance taken in
    float32 over every axis but ``axis`` (not ``F.batch_norm``'s own
    update, which takes the unbiased variance and weighs the other way).
    Carries no gradient."""
    ax = axis % data.dim()
    red = tuple(i for i in range(data.dim()) if i != ax)
    with torch.no_grad():
        var, mean = torch.var_mean(data.float(), dim=red, correction=0)
        return (momentum * moving_mean + (1.0 - momentum) * mean,
                momentum * moving_var + (1.0 - momentum) * var)


@register("BatchNorm", aliases=["batch_norm"], num_outputs=3,
          aux_writeback={1: 3, 2: 4})
def batch_norm(data: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               moving_mean: torch.Tensor, moving_var: torch.Tensor,
               eps: float = 1e-5, momentum: float = 0.9,
               fix_gamma: bool = True, use_global_stats: bool = False,
               output_mean_var: bool = False, axis: int = 1,
               cudnn_off: bool = False, min_calib_range=None,
               max_calib_range=None, training: bool = True):
    """``(out, new_moving_mean, new_moving_var)``: the batch's statistics
    when ``training`` and not ``use_global_stats``, else the moving ones,
    which then come back unchanged.  Dispatch (``nd.BatchNorm``) writes the
    last two into the moving-statistic arrays and returns ``out``."""
    if output_mean_var:
        raise NotImplementedError("BatchNorm(output_mean_var=True)")
    batch = training and not use_global_stats
    out = batch_norm_out(data, gamma, beta, moving_mean, moving_var, eps,
                         fix_gamma, batch, axis)
    if not batch:
        return out, moving_mean, moving_var
    return (out,) + batch_norm_stats(data, moving_mean, moving_var,
                                     momentum, axis)


_CTC_NEG = -1e30    # the reference's "log 0": finite, so no inf - inf


@register("CTCLoss", aliases=["ctc_loss", "_contrib_CTCLoss",
                              "_contrib_ctc_loss"])
def ctc_loss(pred: torch.Tensor, label: torch.Tensor,
             data_lengths: Optional[torch.Tensor] = None,
             label_lengths: Optional[torch.Tensor] = None,
             blank_label: str = "first") -> torch.Tensor:
    """Connectionist temporal classification loss, one value per sequence.

    pred: (T, N, C) activations (log-softmax is applied here); label: (N,
    L).  ``blank_label`` 'first': the blank is class 0, labels are 1..C-1
    padded with 0, and a label's length is its count of nonzero entries;
    'last': the blank is class C-1, labels are 0..C-2 padded with -1
    (length: the non-negative entries), mapped onto the 'first' layout by
    rolling the class axis.  ``data_lengths``/``label_lengths`` override
    the lengths.  The forward-variable recursion of the reference, step
    by step over T in float32 with -1e30 for log 0 and the variables
    frozen past each sequence's length; an alignment that cannot exist (a
    label longer than the sequence allows) gives a loss near 1e30, as in
    the reference, not inf.  The gradient is autograd's through the
    recursion, as the reference's is JAX's."""
    t_len, n, _ = pred.shape
    s = 2 * label.shape[1] + 1
    dev = pred.device
    logp = torch.log_softmax(pred.float(), dim=-1)
    label = label.to(torch.int64)
    if blank_label == "last":
        logp = torch.cat([logp[..., -1:], logp[..., :-1]], dim=-1)
        lab_len = (label >= 0).sum(dim=1) if label_lengths is None \
            else label_lengths.to(torch.int64)
        label = torch.where(label >= 0, label + 1, torch.zeros_like(label))
    elif label_lengths is None:
        lab_len = (label != 0).sum(dim=1)
    else:
        lab_len = label_lengths.to(torch.int64)
    seq_len = torch.full((n,), t_len, dtype=torch.int64, device=dev) \
        if data_lengths is None else data_lengths.to(torch.int64)

    # the extended label: blank, l1, blank, l2, ..., blank
    ext = torch.zeros((n, s), dtype=torch.int64, device=dev)
    ext[:, 1::2] = label
    shift2 = F.pad(ext[:, :-2], (2, 0), value=-1)
    allow2 = (ext != 0) & (ext != shift2)
    neg = torch.full((n, s), _CTC_NEG, dtype=torch.float32, device=dev)
    pos = torch.arange(s, device=dev)[None, :]
    alpha = torch.where(pos < 2, torch.gather(logp[0], 1, ext), neg)
    alpha = torch.where((pos == 1) & (lab_len[:, None] == 0), neg, alpha)
    for t in range(1, t_len):
        a1 = F.pad(alpha[:, :-1], (1, 0), value=_CTC_NEG)
        a2 = torch.where(allow2, F.pad(alpha[:, :-2], (2, 0),
                                       value=_CTC_NEG), neg)
        m = torch.maximum(torch.maximum(alpha, a1), a2)
        new = m + torch.log(torch.exp(alpha - m) + torch.exp(a1 - m)
                            + torch.exp(a2 - m))
        new = new + torch.gather(logp[t], 1, ext)
        alpha = torch.where((t < seq_len)[:, None], new, alpha)
    last = 2 * lab_len
    a_last = torch.gather(alpha, 1, last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, (last - 1).clamp_min(0)[:, None])[:, 0]
    a_prev = torch.where(lab_len > 0, a_prev, neg[:, 0])
    m = torch.maximum(a_last, a_prev)
    return -(m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m)))
