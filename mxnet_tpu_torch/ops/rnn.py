"""The fused ``RNN`` op (RNN, LSTM, GRU; multi-layer, bidirectional).

Counterpart of ``mxnet_tpu/ops/rnn.py`` (reference: src/operator/rnn.cc
and its cuDNN path).  The reference runs each layer and direction as a
``lax.scan`` over a matmul-and-gates step, which XLA compiles; the port
leaves the recurrence to PyTorch's own RNN (``torch._VF.lstm``, ``gru``,
``rnn_tanh``, ``rnn_relu``, the calls behind ``torch.nn.LSTM``), which is
cuDNN's on the card and PyTorch's native loop on the CPU.  What the port
keeps of the reference, and how:

* The packed parameter vector keeps the reference's layout: every layer's
  and direction's ``W_i2h`` (G·H, I) and ``W_h2h`` (G·H, H) first, then
  all the biases ``b_i2h``, ``b_h2h`` in the same order.  PyTorch wants
  ``w_ih, w_hh, b_ih, b_hh`` per layer and direction, so the vector is cut
  at the reference's offsets and PyTorch gets views in its own order.  The
  gate orders agree: LSTM i, f, g, o; GRU r, z, n with
  n = tanh(x_n + r·(W_hn h + b_hn)).
* A float32 RNN runs with cuDNN's TF32 off, in its forward and its
  backward, whatever ``torch.backends.cudnn.allow_tf32`` says outside:
  TF32 would move it about 1e-3 from the reference.
* Dropout between layers (``p > 0`` and ``training``; never after the
  last layer) is inverted dropout with masks drawn from ``generator``, or
  from :func:`.random.generator` of the data's device, never from cuDNN's
  own dropout state.  With dropout active the stack runs layer by layer;
  without it one call runs the whole stack.
* ``use_sequence_length``: past each sample's length the states freeze
  (the final h and c are those of its last valid step), the outputs are
  zero, and the reverse direction starts at the last valid step.  This
  runs on packed sequences (``pack_padded_sequence(...,
  enforce_sorted=False)``).  A length of 0, which packing refuses, gives
  zero outputs and h0, c0 back, as in the reference; a length above T
  counts as T (the reference's reverse direction reads past the end there
  and returns NaN).  The lengths move to the host once a call.
* ``lstm_state_clip_min``/``_max`` clip only the returned c, as the
  reference does (upstream MXNet clips at every step).
* Outside ``lstm`` mode the third output is the cell state passed in
  (zeros for ``state_cell=None``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .nn import _cudnn_without_tf32
from .random import generator as _default_generator
from .registry import register

__all__ = ["rnn", "rnn_param_size", "unpack_params"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(num_layers: int, input_size: int, state_size: int,
                   mode: str, bidirectional: bool = False) -> int:
    """Length of the packed parameter vector (reference: RNNParam)."""
    gh = _GATES[mode] * state_size
    dirs = 2 if bidirectional else 1
    total = 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * dirs
        total += dirs * gh * (isz + state_size)
    return total + num_layers * dirs * 2 * gh


def unpack_params(params: torch.Tensor, num_layers: int, dirs: int,
                  input_size: int, state_size: int, mode: str
                  ) -> List[List[torch.Tensor]]:
    """Views of the reference-layout vector ``params``, as PyTorch's
    per-(layer, direction) lists ``[w_ih, w_hh, b_ih, b_hh]``."""
    gh = _GATES[mode] * state_size
    expected = rnn_param_size(num_layers, input_size, state_size, mode,
                              dirs == 2)
    if params.numel() != expected:
        raise ValueError("RNN: %d parameters given, %s with %d layer(s), "
                         "input %d and state %d takes %d"
                         % (params.numel(), mode, num_layers, input_size,
                            state_size, expected))
    offset = 0
    weights = []
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * dirs
        for _ in range(dirs):
            pair = []
            for cols in (isz, state_size):
                pair.append(params[offset:offset + gh * cols]
                            .view(gh, cols))
                offset += gh * cols
            weights.append(pair)
    for w in weights:
        for _ in range(2):
            w.append(params[offset:offset + gh])
            offset += gh
    return weights


class _Float32Scope(torch.autograd.Function):
    """``fn(*inputs)`` with cuDNN's TF32 off, in its forward and in its
    backward, which runs after the forward's scope has closed: the forward
    records ``fn``'s own graph on detached copies of the inputs and the
    backward differentiates that graph inside the scope."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        with torch.enable_grad(), _cudnn_without_tf32():
            leaves = [x.detach().requires_grad_(need) if x is not None
                      else None
                      for x, need in zip(inputs, ctx.needs_input_grad[1:])]
            outs = fn(*leaves)
        ctx.leaves = leaves
        ctx.outs = outs
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        pairs = [(o, g) for o, g in zip(ctx.outs, grads)
                 if o.requires_grad]
        wanted = [i for i, x in enumerate(ctx.leaves)
                  if x is not None and x.requires_grad]
        got = [None] * len(ctx.leaves)
        if pairs and wanted:
            with _cudnn_without_tf32():
                found = torch.autograd.grad(
                    [o for o, _ in pairs], [ctx.leaves[i] for i in wanted],
                    [g for _, g in pairs], allow_unused=True)
            for i, g in zip(wanted, found):
                got[i] = g
        return (None,) + tuple(got)


def _flat(weights: Sequence[Sequence[torch.Tensor]]) -> List[torch.Tensor]:
    return [t for w in weights for t in w]


def _stack(x, h0, c0, weights, num_layers, bidirectional, mode, lengths):
    """One PyTorch RNN call over ``num_layers`` layers: x (T, N, I) ->
    (out (T, N, D·H), h (L·D, N, H), c or None).  ``lengths`` (a CPU int64
    tensor of N values, each in 1..T) packs the batch."""
    call = getattr(torch._VF, mode)
    hx = (h0, c0) if mode == "lstm" else h0
    params = _flat(weights)
    # cuDNN keeps what its backward needs only in training mode
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in [x, h0, c0] + params)
    if lengths is None:
        res = call(x, hx, params, True, num_layers, 0.0, train,
                   bidirectional, False)
    else:
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x, lengths, enforce_sorted=False)
        order, back = packed.sorted_indices, packed.unsorted_indices
        hx = tuple(h.index_select(1, order) for h in hx) \
            if mode == "lstm" else hx.index_select(1, order)
        res = call(packed.data, packed.batch_sizes, hx, params, True,
                   num_layers, 0.0, train, bidirectional)
        out, _ = torch.nn.utils.rnn.pad_packed_sequence(
            torch.nn.utils.rnn.PackedSequence(res[0], packed.batch_sizes,
                                              order, back),
            total_length=x.shape[0])
        res = (out,) + tuple(h.index_select(1, back) for h in res[1:])
    return res[0], res[1], (res[2] if mode == "lstm" else None)


def _run(data, params, state, state_cell, lengths, state_size, num_layers,
         mode, bidirectional, p, training, generator):
    """The whole op on tensors (inside :class:`_Float32Scope`)."""
    dirs = 2 if bidirectional else 1
    weights = unpack_params(params, num_layers, dirs, data.shape[2],
                            state_size, mode)
    keep = None
    if lengths is not None and not bool(lengths.all()):
        # packing refuses a length of 0: run the other samples, and give
        # those zero outputs and their initial states back
        keep = lengths.nonzero().squeeze(1)
        if not keep.numel():
            return (data.new_zeros(data.shape[:2] + (dirs * state_size,)),
                    state, state_cell)
        on = keep.to(data.device)
        whole = (data, state, state_cell)
        data = data.index_select(1, on)
        state = state.index_select(1, on)
        state_cell = state_cell.index_select(1, on)
        lengths = lengths.index_select(0, keep)
    drop = training and p > 0 and num_layers > 1
    if not drop:
        out, h, c = _stack(data, state, state_cell, weights, num_layers,
                           bidirectional, mode, lengths)
    else:
        x, hs, cs = data, [], []
        for layer in range(num_layers):
            rows = slice(layer * dirs, (layer + 1) * dirs)
            x, h, c = _stack(x, state[rows], state_cell[rows],
                             weights[rows], 1, bidirectional, mode,
                             lengths)
            hs.append(h)
            cs.append(c)
            if layer < num_layers - 1:
                mask = torch.rand(x.shape, generator=generator,
                                  device=x.device) < 1.0 - p
                x = x * mask.to(x.dtype) / (1.0 - p)
        out, h = x, torch.cat(hs)
        c = torch.cat(cs) if mode == "lstm" else None
    if c is None:
        c = state_cell
    if keep is not None:
        data0, state0, cell0 = whole
        on = keep.to(data0.device)
        out = out.new_zeros((data0.shape[0], data0.shape[1], out.shape[2])
                            ).index_copy(1, on, out)
        h = state0.index_copy(1, on, h)
        c = cell0.index_copy(1, on, c)
    return out, h, c


@register("RNN", aliases=["rnn"], num_outputs=3)
def rnn(data: torch.Tensor, parameters: torch.Tensor, state: torch.Tensor,
        state_cell: Optional[torch.Tensor] = None,
        sequence_length: Optional[torch.Tensor] = None,
        state_size: int = 0, num_layers: int = 1, mode: str = "lstm",
        bidirectional: bool = False, p: float = 0.0,
        state_outputs: bool = True, lstm_state_clip_min=None,
        lstm_state_clip_max=None, use_sequence_length: bool = False,
        projection_size=None, training: bool = False,
        generator: Optional[torch.Generator] = None):
    """The fused RNN: ``data`` (T, N, I) in the reference's time-major
    layout, the packed ``parameters`` (module docstring), ``state`` (L·D,
    N, H) and, for ``lstm``, ``state_cell`` (zeros when None);
    ``sequence_length`` (N,) with ``use_sequence_length``.  Returns
    ``(output (T, N, D·H), state out, cell state out)``.  ``p`` is the
    dropout between layers, active with ``training``, drawn from
    ``generator`` (default: :func:`.random.generator` of the data's
    device).  ``state_outputs`` and ``projection_size`` are accepted and
    ignored, as the reference ignores them."""
    if mode not in _GATES:
        raise ValueError("unknown RNN mode %r" % mode)
    if state_cell is None:
        state_cell = torch.zeros_like(state)
    lengths = None
    if use_sequence_length and sequence_length is not None:
        lengths = sequence_length.detach().to("cpu", torch.int64).clamp(
            0, data.shape[0])
    if generator is None and training and p > 0 and num_layers > 1:
        generator = _default_generator(data.device)
    def run(*tensors):
        return _run(*tensors, lengths, state_size, num_layers, mode,
                    bidirectional, p, training, generator)
    tensors = (data, parameters, state, state_cell)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        out, h, c = _Float32Scope.apply(run, *tensors)
    else:
        with _cudnn_without_tf32():
            out, h, c = run(*tensors)
    if mode == "lstm" and lstm_state_clip_min is not None:
        c = c.clamp(lstm_state_clip_min, lstm_state_clip_max)
    return out, h, c
