"""Carry parameters from a ``mxnet_tpu`` block into the port.

The structural names of the two packages match
(``encoder.transformer_cells.0.attention.query_key_value.weight`` is
(3 * units, units) on both sides, and Dense weights are (out, in) as in
PyTorch), so the conversion is a copy by name.  The input is what the JAX
block exports, ``{name: p.data().asnumpy() for name, p in
net.collect_params().items()}``; this module needs nothing of the JAX
package to read it.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .device import DeviceLike

__all__ = ["params_from_mxnet_tpu"]


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
