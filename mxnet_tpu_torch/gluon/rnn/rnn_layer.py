"""Gluon recurrent layers ``RNN``, ``LSTM`` and ``GRU`` over the fused
``RNN`` op.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py``: the same parameter
names (``l{i}_``/``r{i}_`` + ``i2h_weight``, ``h2h_weight``, ``i2h_bias``,
``h2h_bias``; ``r`` the reverse direction), packed into the op's flat
vector in the reference's order (weights of every layer and direction,
then the biases), the input size deferred to the first call, the ``TNC``
and ``NTC`` layouts, ``begin_state`` and ``state_info``.  A call without
states returns only the output; ``sequence_length`` switches on the op's
``use_sequence_length``.  Dropout between layers is active in training
mode (``autograd.is_training()`` on a call with NDArrays, as
:meth:`Block.__call__` sets it) and draws from the layer's ``generator``
(``nn.set_dropout_generator`` sets it; while it is None, from
``mx.random``'s generator of the data's device).
"""
from __future__ import annotations

from typing import Optional

import torch

from ... import initializer
from ... import ndarray as nd
from ...ops.registry import dispatch
from ..block import HybridBlock
from ..parameter import meta_parameter, param_handle

__all__ = ["RNN", "LSTM", "GRU"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


class _RNNLayer(HybridBlock):
    """What ``RNN``, ``LSTM`` and ``GRU`` share."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, mode,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise ValueError("Invalid layout %s; must be one of ['TNC' or "
                             "'NTC']" % layout)
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = _GATES[mode]
        self.generator: Optional[torch.Generator] = None
        ng, ni, nh = self._gates, input_size, hidden_size
        inits = (("i2h_weight", i2h_weight_initializer),
                 ("h2h_weight", h2h_weight_initializer),
                 ("i2h_bias", i2h_bias_initializer),
                 ("h2h_bias", h2h_bias_initializer))
        for i in range(num_layers):
            shapes = ((ng * nh, ni), (ng * nh, nh), (ng * nh,), (ng * nh,))
            for j in self._directions():
                for (kind, init), shape in zip(inits, shapes):
                    name = "%s%d_%s" % (j, i, kind)
                    setattr(self, name, meta_parameter(shape))
                    if init is not None:
                        param_handle(self, name).init = \
                            initializer.create(init)
            ni = nh * self._dir

    def _directions(self):
        return ["l", "r"] if self._dir == 2 else ["l"]

    def infer_shape(self, inputs, *args):
        ni = inputs.shape[2] if self._layout == "TNC" else inputs.shape[-1]
        self._input_size = ni
        for j in self._directions():
            param_handle(self, "%s0_i2h_weight" % j).shape = \
                (self._gates * self._hidden_size, ni)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape}] * (2 if self._mode == "lstm" else 1)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states as NDArrays: ``func(**info, **kwargs)`` for
        each of :meth:`state_info` (default ``nd.zeros``; ``ctx=`` places
        them)."""
        func = nd.zeros if func is None else func
        return [func(**info, **kwargs) for info in self.state_info(batch_size)]

    def _pack_params(self):
        """The op's flat vector: every layer's and direction's weights,
        then their biases (reference order)."""
        p = self._parameters
        names = [(i, j) for i in range(self._num_layers)
                 for j in self._directions()]
        flat = [p["%s%d_%s" % (j, i, kind)].reshape(-1) for i, j in names
                for kind in ("i2h_weight", "h2h_weight")]
        flat += [p["%s%d_%s" % (j, i, kind)] for i, j in names
                 for kind in ("i2h_bias", "h2h_bias")]
        return torch.cat(flat)

    def forward(self, inputs, states=None, sequence_length=None):
        skip_states = states is None
        if self._layout == "NTC":
            inputs = inputs.transpose(0, 1)
        if skip_states:
            shape = (self._num_layers * self._dir, inputs.shape[1],
                     self._hidden_size)
            states = [inputs.new_zeros(shape)] * len(self.state_info())
        if isinstance(states, torch.Tensor):
            states = [states]
        out, h, c = dispatch(
            "RNN", inputs, self._pack_params(), states[0],
            states[1] if len(states) > 1 else None, sequence_length,
            state_size=self._hidden_size, num_layers=self._num_layers,
            mode=self._mode, bidirectional=self._dir == 2, p=self._dropout,
            use_sequence_length=sequence_length is not None,
            training=self.training, generator=self.generator)
        if self._layout == "NTC":
            out = out.transpose(0, 1)
        if skip_states:
            return out
        return out, ([h, c] if self._mode == "lstm" else [h])

    def extra_repr(self):
        return "%s -> %s, %s, layers=%d%s" % (
            self._input_size or "?", self._hidden_size, self._layout,
            self._num_layers, ", bidirectional" if self._dir == 2 else "")


class RNN(_RNNLayer):
    """Elman RNN with ``activation`` 'relu' (the default) or 'tanh'."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "rnn_" + activation,
                         **kwargs)


class LSTM(_RNNLayer):
    """Long short-term memory; the states are ``[h, c]``."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", **kwargs)


class GRU(_RNNLayer):
    """Gated recurrent unit (gates r, z, n)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", **kwargs)
