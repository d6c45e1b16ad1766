"""The AMP-named ops of ``mxnet_tpu/ops/misc.py``: ``all_finite``,
``multi_all_finite`` and ``amp_multicast`` (reference:
src/operator/contrib/all_finite.cc, src/operator/tensor/amp_cast.cc).

Their checks run on the device: the flag is a float32 tensor of shape
(1,), 1.0 when every entry is finite, and nothing is read back to the
host.  None of them is on an AMP list, so under ``amp.init()`` their
inputs pass uncast, as in the reference.  The rest of ``misc.py`` waits
for Queue 1 item 8.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = []

#: the reference's float order, narrowest first
_FLOAT_ORDER = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


@register("all_finite", differentiable=False)
def _all_finite(data, init_output=True):
    return torch.isfinite(data).all().reshape(1).to(torch.float32)


@register("multi_all_finite", differentiable=False)
def _multi_all_finite(*arrays, num_arrays=1, init_output=True):
    """One flag over every float array: the max norm of each, grouped by
    dtype and device (``torch._foreach_norm``: a few launches, not one an
    array), finite or not."""
    groups = {}
    for a in arrays:
        if a.is_floating_point():
            groups.setdefault((a.dtype, a.device), []).append(a)
    ok = torch.ones((), dtype=torch.bool,
                    device=arrays[0].device if arrays else None)
    for group in groups.values():
        norms = torch._foreach_norm(group, float("inf"))
        ok = ok & torch.isfinite(torch.stack(norms)).all().to(ok.device)
    return ok.reshape(1).to(torch.float32)


@register("amp_multicast", num_outputs=0)  # variable: one per input
def _amp_multicast(*args, num_outputs=1, cast_narrow=False):
    """Cast every input to the widest (``cast_narrow``: the narrowest)
    float type among them, in the order fp16 < bf16 < fp32 < fp64; a
    type outside that order ranks above all of them."""
    def rank(d):
        return _FLOAT_ORDER.index(d) if d in _FLOAT_ORDER \
            else len(_FLOAT_ORDER)

    target = (min if cast_narrow else max)((a.dtype for a in args),
                                           key=rank)
    return tuple(a.to(target) for a in args)
