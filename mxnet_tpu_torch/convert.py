"""Carry parameters between a ``mxnet_tpu`` block and the port.

The structural names of the two packages match
(``encoder.transformer_cells.0.attention.query_key_value.weight`` is
(3 * units, units) on both sides, and Dense weights are (out, in) as in
PyTorch), so the conversion is a copy by name.  The input is what the JAX
block exports, ``{name: p.data().asnumpy() for name, p in
net.collect_params().items()}``; this module needs nothing of the JAX
package to read it.  :func:`params_to_numpy` is the way back, the same
``{name: ndarray}`` form.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from .device import DeviceLike

__all__ = ["params_from_mxnet_tpu", "params_to_numpy"]


def params_from_mxnet_tpu(named: Mapping[str, np.ndarray],
                          net: Optional[torch.nn.Module] = None,
                          device: DeviceLike = None
                          ) -> Dict[str, torch.Tensor]:
    """Numpy arrays by structural name -> CPU tensors by the same name.

    With ``net`` (a port block) the tensors are also loaded into it on
    ``device`` (default: the GPU) with ``strict=True``, so a missing or
    extra name raises."""
    out = {str(k): torch.from_numpy(np.array(v, copy=True))
           for k, v in named.items()}
    if net is not None:
        net.load_dict(out, device=device)
    return out


def params_to_numpy(net_or_params: Union[torch.nn.Module,
                                         Mapping[str, torch.Tensor]]
                    ) -> Dict[str, np.ndarray]:
    """A port block's parameters (or a ``{name: tensor}`` mapping such as
    ``TrainStep.params``) as host numpy arrays by structural name.
    bfloat16, which numpy lacks, comes back as float32."""
    if isinstance(net_or_params, torch.nn.Module):
        named = net_or_params.named_parameters()
    else:
        named = net_or_params.items()
    out = {}
    for name, t in named:
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[str(name)] = t.cpu().numpy().copy()
    return out
