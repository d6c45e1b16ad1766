"""The nn functions of the serving slice, on tensors.

Counterpart of the matching entries of ``mxnet_tpu/ops/nn.py`` and
``mxnet_tpu/ops/matrix.py`` (``Embedding``).  Plain matrix products stay
with PyTorch's library kernels, as the JAX package left them to XLA.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .attention import attention_core

__all__ = ["fully_connected", "activation", "gelu", "layer_norm",
           "embedding", "multi_head_attention"]


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
