"""The nn functions of the serving and training slices, on tensors.

Counterpart of the matching entries of ``mxnet_tpu/ops/nn.py`` and
``mxnet_tpu/ops/matrix.py`` (``Embedding``, ``pick``).  Plain matrix products stay
with PyTorch's library kernels, as the JAX package left them to XLA.
``softmax``, ``log_softmax`` and ``Dropout`` are also registered ops of
``ops/registry.py``, under the reference's names.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..base import torch_dtype
from .attention import attention_core
from .registry import register

__all__ = ["fully_connected", "activation", "gelu", "layer_norm",
           "embedding", "multi_head_attention", "softmax", "log_softmax",
           "softmax_cross_entropy", "pick", "dropout"]


def fully_connected(data: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    flatten: bool = True) -> torch.Tensor:
    """``data @ weight.T + bias`` with weight (num_hidden, in_units);
    ``flatten`` folds all but the leading axis first."""
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 \
        else data
    return F.linear(x, weight, bias)


def gelu(data: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, the JAX package's ``LeakyReLU(act_type='gelu')``."""
    return F.gelu(data, approximate="none")


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
    raise ValueError("bad act_type %r" % act_type)


def layer_norm(data: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               axis: int = -1, eps: float = 1e-5) -> torch.Tensor:
    """Normalise in float32, cast back to data's dtype, then scale and
    shift, in the JAX package's order."""
    x32 = data.float()
    mean = x32.mean(dim=axis, keepdim=True)
    var = x32.var(dim=axis, keepdim=True, unbiased=False)
    norm = ((x32 - mean) * torch.rsqrt(var + eps)).to(data.dtype)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return norm * gamma.reshape(shape) + beta.reshape(shape)


def embedding(data: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Row gather with ``jnp.take``'s semantics: indices are truncated to
    integers, -n <= i < 0 wraps, and an index outside [-n, n) gives a row
    of NaN (never a device fault)."""
    n = weight.shape[0]
    idx = data.long()
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    out = F.embedding(idx.clamp(0, n - 1), weight)
    return out.masked_fill(~valid.unsqueeze(-1), float("nan"))


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         num_heads: int = 1, scaled: bool = True,
                         causal: bool = False) -> torch.Tensor:
    """q, k, v: (B, T, H*D); mask broadcastable to (B, H, Tq, Tk).
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


def pick(x: torch.Tensor, index: torch.Tensor, axis: int = -1,
         keepdims: bool = False, mode: str = "clip") -> torch.Tensor:
    """``x``'s entry at ``index`` along ``axis``; indices are truncated to
    integers and clipped to the axis (the JAX package clips in every
    mode)."""
    ax = axis % x.dim()
    idx = index.long().clamp(0, x.shape[ax] - 1).unsqueeze(ax)
    out = torch.gather(x, ax, idx)
    return out if keepdims else out.squeeze(ax)


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
