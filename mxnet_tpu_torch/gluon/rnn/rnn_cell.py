"""Recurrent cells: one step of a recurrence, and ``unroll`` over a
sequence.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``: ``RecurrentCell``
(alias ``HybridRecurrentCell``) with ``reset``, ``begin_state`` and
``unroll`` (``valid_length``, ``merge_outputs``), ``RNNCell``,
``LSTMCell`` and ``GRUCell`` with the reference's parameter names and gate
orders (LSTM i, f, g, o; GRU r, z, n, as the fused ``RNN`` op, so a cell
unroll and the fused layer give the same numbers),
``SequentialRNNCell``, ``HybridSequentialRNNCell``, ``DropoutCell``,
``ModifierCell``, ``ResidualCell``, ``ZoneoutCell`` and
``BidirectionalCell``.  A cell's ``forward`` runs on tensors, as every
port layer does, and reaches its ops through ``registry.dispatch``;
``unroll`` takes NDArrays (the imperative front end) or tensors (inside
another block's forward) and answers in kind.  Training mode is the
block's (``autograd.is_training()`` on a call with NDArrays); the
dropout and zoneout masks come from ``mx.random``'s generator of the
data's device.
"""
from __future__ import annotations

import torch

from ... import initializer
from ... import ndarray as nd
from ...base import dtype_name
from ...ndarray.ndarray import NDArray, invoke
from ...ops.random import generator as _generator
from ...ops.registry import dispatch
from ..block import HybridBlock
from ..parameter import meta_parameter, param_handle

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "BidirectionalCell",
           "ResidualCell", "ZoneoutCell", "ModifierCell",
           "HybridSequentialRNNCell"]


def _op(name, *args, **params):
    """Registered op ``name`` through ``invoke`` when an input is an
    NDArray, else through ``dispatch`` on tensors."""
    if any(isinstance(a, NDArray) for a in args):
        return invoke(name, *args, **params)
    return dispatch(name, *args, **params)


def _steps(length, inputs, axis):
    """``inputs`` as a list of ``length`` steps: a sequence is split along
    ``axis``, a list is taken as it is."""
    if isinstance(inputs, (NDArray, torch.Tensor)):
        return [_op("squeeze", _op("slice_axis", inputs, axis=axis, begin=i,
                                   end=i + 1), axis=axis)
                for i in range(length)]
    return list(inputs)


def _zero_states(cell, batch_size, like):
    """``cell.begin_state`` on ``like``'s device: NDArrays for an NDArray,
    tensors of its dtype for a tensor."""
    if isinstance(like, NDArray):
        return cell.begin_state(batch_size, ctx=like.context)
    return cell.begin_state(batch_size,
                            func=lambda shape, **kw: like.new_zeros(shape))


def _masked(out, valid_length, i):
    """Step ``i``'s output with the samples whose length is ``i`` or less
    zeroed (reference: ``unroll``'s ``valid_length``)."""
    mask = valid_length > i
    mask = mask.astype(out.dtype) if isinstance(mask, NDArray) \
        else mask.to(out.dtype)
    return out * mask.reshape((-1,) + (1,) * (out.ndim - 1))


class RecurrentCell(HybridBlock):
    """Base cell: ``forward(inputs, states) -> (output, new_states)``."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset the step counters, here and in the child cells."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._modules.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states: ``func(**info, **kwargs)`` for each of
        :meth:`state_info` (default ``nd.zeros``; ``ctx=`` places them)."""
        if self._modified:
            raise AssertionError(
                "After applying modifier cells the base cell cannot be "
                "called directly. Call the modifier cell instead.")
        func = nd.zeros if func is None else func
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            states.append(func(**info, **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run ``length`` steps over ``inputs`` (a sequence in ``layout``,
        or a list of steps).  Returns ``(outputs, states)``: the outputs
        stacked along T when ``merge_outputs`` (default: when the inputs
        came as one sequence), else a list; with ``valid_length`` each
        sample's outputs past its length are zero."""
        self.reset()
        axis = layout.find("T")
        seq = _steps(length, inputs, axis)
        if begin_state is None:
            begin_state = _zero_states(self, seq[0].shape[0], seq[0])
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(seq[i], states)
            outputs.append(output)
        if valid_length is not None:
            outputs = [_masked(out, valid_length, i)
                       for i, out in enumerate(outputs)]
        if merge_outputs or merge_outputs is None and \
                isinstance(inputs, (NDArray, torch.Tensor)):
            outputs = _op("stack", *outputs, axis=axis)
        return outputs, states


HybridRecurrentCell = RecurrentCell


class _GatedCell(RecurrentCell):
    """What the three cells share: ``i2h_weight`` (G·H, input size; the
    input size deferred to the first call), ``h2h_weight`` (G·H, H) and
    zero-initialised biases ``i2h_bias``, ``h2h_bias``."""

    _gates = 1

    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        self._input_size = input_size
        gh = self._gates * hidden_size
        self.i2h_weight = meta_parameter((gh, input_size))
        self.h2h_weight = meta_parameter((gh, hidden_size))
        self.i2h_bias = meta_parameter((gh,))
        self.h2h_bias = meta_parameter((gh,))
        for name in ("i2h_bias", "h2h_bias"):
            param_handle(self, name).init = initializer.Zero()

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}]

    def infer_shape(self, x, *args):
        self._input_size = x.shape[-1]
        param_handle(self, "i2h_weight").shape = \
            (self._gates * self._hidden_size, x.shape[-1])

    def _projections(self, inputs, h):
        p = self._parameters
        gh = self._gates * self._hidden_size
        return (dispatch("FullyConnected", inputs, p["i2h_weight"],
                         p["i2h_bias"], num_hidden=gh),
                dispatch("FullyConnected", h, p["h2h_weight"],
                         p["h2h_bias"], num_hidden=gh))

    def extra_repr(self):
        return "%s -> %d" % (self._input_size or "?", self._hidden_size)


class RNNCell(_GatedCell):
    """Elman cell: ``activation(W_i2h x + b + W_h2h h + b)``."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 **kwargs):
        super().__init__(hidden_size, input_size, **kwargs)
        self._activation = activation

    def forward(self, inputs, states):
        i2h, h2h = self._projections(inputs, states[0])
        output = dispatch("Activation", i2h + h2h,
                          act_type=self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    """LSTM cell, gates i, f, g, o; the states are ``[h, c]``."""

    _gates = 4

    def __init__(self, hidden_size, input_size=0, activation="tanh",
                 recurrent_activation="sigmoid", **kwargs):
        super().__init__(hidden_size, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}] * 2

    def forward(self, inputs, states):
        i2h, h2h = self._projections(inputs, states[0])
        i, f, g, o = dispatch("split", i2h + h2h, num_outputs=4, axis=1)
        next_c = dispatch("sigmoid", f) * states[1] + \
            dispatch("sigmoid", i) * dispatch("tanh", g)
        next_h = dispatch("sigmoid", o) * dispatch("tanh", next_c)
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """GRU cell, gates r, z, n with n = tanh(x_n + r·(W_hn h + b_hn))."""

    _gates = 3

    def forward(self, inputs, states):
        prev_h = states[0]
        i2h, h2h = self._projections(inputs, prev_h)
        i2h_r, i2h_z, i2h_n = dispatch("split", i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_n = dispatch("split", h2h, num_outputs=3, axis=1)
        reset = dispatch("sigmoid", i2h_r + h2h_r)
        update = dispatch("sigmoid", i2h_z + h2h_z)
        next_h_tmp = dispatch("tanh", i2h_n + reset * h2h_n)
        next_h = (1.0 - update) * next_h_tmp + update * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step's output feeds the next cell."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return [info for cell in self._modules.values()
                for info in cell.state_info(batch_size)]

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def forward(self, inputs, states):
        next_states = []
        pos = 0
        for cell in self._modules.values():
            n = len(cell.state_info())
            inputs, state = cell(inputs, states[pos:pos + n])
            pos += n
            next_states.extend(state)
        return inputs, next_states


class HybridSequentialRNNCell(SequentialRNNCell):
    """:class:`SequentialRNNCell` under the reference's hybrid name."""


class DropoutCell(RecurrentCell):
    """Dropout of the step's input at ``rate`` in training mode (``axes``
    share one draw); no states."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def forward(self, inputs, states):
        if self._rate > 0 and self.training:
            inputs = dispatch("Dropout", inputs, p=self._rate,
                              axes=tuple(self._axes), mode="training",
                              generator=_generator(inputs.device))
        return inputs, states


class ModifierCell(RecurrentCell):
    """A cell that wraps ``base_cell``, which may then be called only
    through it."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        if self._modified:
            raise AssertionError(
                "After applying modifier cells the base cell cannot be "
                "called directly. Call the modifier cell instead.")
        self.base_cell._modified = False
        try:
            return self.base_cell.begin_state(batch_size, func=func,
                                              **kwargs)
        finally:
            self.base_cell._modified = True


class ResidualCell(ModifierCell):
    """The base cell's output plus the step's input."""

    def forward(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class ZoneoutCell(ModifierCell):
    """In training mode, keep each entry of the previous output
    (``zoneout_outputs``) and of the previous states (``zoneout_states``)
    with that probability instead of the new one; masks through the
    ``_random_bernoulli`` op."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        if isinstance(base_cell, BidirectionalCell):
            raise AssertionError("BidirectionalCell doesn't support zoneout")
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def forward(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        if not self.training:
            return next_output, next_states

        def mask(p, like):
            return dispatch("_random_bernoulli", prob=1 - p,
                            shape=tuple(like.shape),
                            dtype=dtype_name(like.dtype), device=like.device)

        prev_output = self._prev_output
        if prev_output is None:
            prev_output = torch.zeros_like(next_output)
        output = next_output
        if self.zoneout_outputs > 0:
            m = mask(self.zoneout_outputs, next_output)
            output = m * next_output + (1 - m) * prev_output
        new_states = next_states
        if self.zoneout_states > 0:
            new_states = []
            for new_s, old_s in zip(next_states, states):
                m = mask(self.zoneout_states, new_s)
                new_states.append(m * new_s + (1 - m) * old_s)
        self._prev_output = output
        return output, new_states


class BidirectionalCell(RecurrentCell):
    """``l_cell`` forward and ``r_cell`` backward over a sequence, their
    outputs concatenated; only :meth:`unroll` runs it."""

    def __init__(self, l_cell, r_cell, **kwargs):
        super().__init__(**kwargs)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")

    def state_info(self, batch_size=0):
        return [info for cell in self._modules.values()
                for info in cell.state_info(batch_size)]

    def forward(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        axis = layout.find("T")
        seq = _steps(length, inputs, axis)
        l_cell, r_cell = self._modules.values()
        if begin_state is None:
            begin_state = _zero_states(self, seq[0].shape[0], seq[0])
        n_l = len(l_cell.state_info())
        l_outputs, l_states = l_cell.unroll(
            length, seq, begin_state[:n_l], layout, merge_outputs=False,
            valid_length=valid_length)
        if valid_length is None:
            rev_seq = list(reversed(seq))
        else:
            # each sample's valid steps reversed, so the reverse cell
            # starts from its last valid step
            rev = _op("SequenceReverse", _op("stack", *seq, axis=0),
                      valid_length, use_sequence_length=True)
            rev_seq = [rev[t] for t in range(length)]
        r_outputs, r_states = r_cell.unroll(
            length, rev_seq, begin_state[n_l:], layout,
            merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            r_outputs = list(reversed(r_outputs))
        else:
            r_rev = _op("SequenceReverse", _op("stack", *r_outputs, axis=0),
                        valid_length, use_sequence_length=True)
            r_outputs = [r_rev[t] for t in range(length)]
        outputs = [_op("concat", lo, ro, dim=1)
                   for lo, ro in zip(l_outputs, r_outputs)]
        if merge_outputs or merge_outputs is None:
            outputs = _op("stack", *outputs, axis=axis)
        return outputs, l_states + r_states
