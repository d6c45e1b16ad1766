"""Carry parameters between a ``mxnet_tpu`` block and the port.

The structural names of the two packages match
(``encoder.transformer_cells.0.attention.query_key_value.weight`` is
(3 * units, units) on both sides, and Dense weights are (out, in) as in
PyTorch), so the conversion is a copy by name; so are the norms' and
activations' own parameters (``GroupNorm``/``InstanceNorm`` gamma and
beta, ``PReLU`` alpha).  The input is what the JAX
block exports, ``{name: p.data().asnumpy() for name, p in
net.collect_params().items()}``; this module needs nothing of the JAX
package to read it.  :func:`params_to_numpy` is the way back, the same
``{name: ndarray}`` form.  A port net built with deferred sizes takes them
from the arrays.  :func:`trainer_states_from_mxnet_tpu` carries a
reference ``gluon.Trainer``'s optimizer state (momenta, Adam moments,
float32 masters, update counts) into a port ``Trainer``, so both can go
on from the same point of a trajectory.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from .device import DeviceLike

__all__ = ["params_from_mxnet_tpu", "params_to_numpy",
           "trainer_states_from_mxnet_tpu"]


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


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _leaves(s)]
    return [state]


def trainer_states_from_mxnet_tpu(exported: Mapping[str, Any],
                                  trainer) -> None:
    """Load a reference trainer's optimizer state into a port ``Trainer``.

    ``exported`` is what the reference's ``Trainer`` holds, as numpy:
    ``{"states": {index: state}, "index_update_count": {index: count},
    "num_update": n}``, where a state is None, an array, or a tuple of
    them nested as the reference's ``Updater.states`` nest them (a
    multi-precision state is ``(inner state, float32 master)``; bfloat16
    arrays may come as float32).  Each state is made by the port's
    optimizer for the parameter at that index and filled from the
    arrays, and the update counts go to the counts of the parameters'
    device; with copies on several contexts every context's updater and
    counts take them."""
    for d, updater in enumerate(trainer._updaters):
        optimizer = updater.optimizer
        for index, values in exported["states"].items():
            weight = trainer._params[index].list_data()[d]
            state = optimizer.create_state_multi_precision(index, weight)
            dst, src = _leaves(state), _leaves(values)
            if len(dst) != len(src):
                raise ValueError("state %d: %d arrays, the port's optimizer "
                                 "keeps %d" % (index, len(src), len(dst)))
            with torch.no_grad():
                for t, a in zip(dst, src):
                    t.data.copy_(torch.from_numpy(
                        np.array(a, dtype=np.float32)).reshape(t.shape))
            updater.states[index] = state
            updater.states_synced[index] = True
        ctx = trainer._params[0].list_ctx()[d]
        optimizer._set_current_context((ctx.device_type, ctx.device_id))
        optimizer._index_update_count.clear()
        optimizer._index_update_count.update(
            {int(k): int(v)
             for k, v in exported["index_update_count"].items()})
    optimizer.num_update = int(exported["num_update"])
