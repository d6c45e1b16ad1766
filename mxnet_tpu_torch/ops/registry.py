"""Operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py`` (the nnvm op registry's role:
``NNVM_REGISTER_OP``, ``FCompute``, ``FGradient``).  Each entry is an
:class:`OpDef` keyed by op name: ``fn(*tensors, **params)`` computes the op
on ``torch.Tensor``s, ``differentiable`` says whether dispatch records it
for autograd (torch autograd differentiates ``fn`` itself, which plays the
FGradient role), ``num_outputs`` is 1, n, or 0 for a variable count,
``aux_writeback`` maps an output's index to the index of the input that
dispatch writes it into in place and drops from the visible outputs
(``BatchNorm``'s moving statistics, the reference's aux states; a callable
of the call's parameters gives the map of a variable-arity op, such as
``multi_sgd_update`` over ``num_weights`` pairs), and ``mutates_input``
names the input that dispatch writes the first visible output into and
returns (the optimizer updates write the weight).

:func:`dispatch` runs a registered op on tensors by name.  It is the one
route that ``nd.*`` (``ndarray.invoke``), the gluon layers' forwards,
``functionalize``/``TrainStep`` and ``serve.Servable`` share, and where
the AMP policy (:mod:`mxnet_tpu_torch.amp`) casts an op's inputs, as the
reference's ``invoke`` does for every op.  Its cost over calling the op's
function is one dictionary lookup and one thread-local read.

The reference's per-op jit cache is not ported: PyTorch dispatches
eagerly, so re-registering a name replaces its ``OpDef`` and nothing else
needs evicting.
"""
from __future__ import annotations

import inspect
import numbers
from typing import Callable, Dict, Optional, Sequence, Union

from ..amp import current_state as _amp_state

__all__ = ["OpDef", "register", "get_op", "list_ops", "alias", "dispatch",
           "amp_cast"]

_REGISTRY: Dict[str, "OpDef"] = {}

#: an op's aux write-back: {output index: input index}, or a callable of
#: the call's parameters giving that map
AuxMap = Union[Dict[int, int], Callable[[dict], Dict[int, int]], None]


class OpDef:
    __slots__ = ("name", "fn", "differentiable", "num_outputs",
                 "aux_writeback", "mutates_input", "doc", "_pos_params")

    def __init__(self, name: str, fn: Callable, differentiable: bool = True,
                 num_outputs: int = 1, doc: Optional[str] = None,
                 aux_writeback: AuxMap = None,
                 mutates_input: Optional[int] = None):
        self.name = name
        self.fn = fn
        self.differentiable = differentiable
        self.num_outputs = num_outputs
        self.aux_writeback = aux_writeback if callable(aux_writeback) \
            else dict(aux_writeback or {})
        self.mutates_input = mutates_input
        self.doc = doc or (fn.__doc__ or "")
        self._pos_params = None

    def aux_map(self, params) -> Dict[int, int]:
        """The output -> input write-back map of a call with ``params``."""
        if callable(self.aux_writeback):
            return self.aux_writeback(params)
        return self.aux_writeback

    def pos_params(self):
        """[(name, has_default)] for ``fn``'s positional parameters (stops
        at ``*args``)."""
        if self._pos_params is None:
            info = []
            try:
                for p in inspect.signature(self.fn).parameters.values():
                    if p.kind not in (p.POSITIONAL_ONLY,
                                      p.POSITIONAL_OR_KEYWORD):
                        break
                    info.append((p.name, p.default is not p.empty))
            except (TypeError, ValueError):
                pass
            self._pos_params = tuple(info)
        return self._pos_params

    def split_pos_attrs(self, inputs, params, tensor_cls):
        """The classic-API convention: a plain value (number, tuple, list,
        str) in a positional slot whose parameter HAS a default is an
        attribute and moves into ``params`` (``nd.expand_dims(x, 0)``,
        ``nd.reshape(x, (2, 3))``); a slot without a default keeps a number
        as an operand (``broadcast_add(x, 1.5)``).  Raises on a value given
        both positionally and by keyword.  Returns the remaining inputs."""
        def plain(x):
            return isinstance(x, (numbers.Number, tuple, list, str)) \
                and not isinstance(x, tensor_cls)

        if not any(plain(x) for x in inputs):
            return inputs
        info = self.pos_params()
        kept = []
        for i, x in enumerate(inputs):
            if plain(x) and i < len(info) and info[i][1]:
                name = info[i][0]
                if name in params:
                    raise TypeError("%s: got multiple values for %r "
                                    "(positional and keyword)"
                                    % (self.name, name))
                params[name] = x
            else:
                kept.append(x)
        return tuple(kept)

    def __repr__(self):
        return "OpDef(%s)" % self.name


def register(name: str, fn: Optional[Callable] = None, *,
             differentiable: bool = True, num_outputs: int = 1,
             aliases: Sequence[str] = (), replace: bool = False,
             aux_writeback: AuxMap = None,
             mutates_input: Optional[int] = None):
    """Register an op; usable as a decorator or a direct call.

    A name (or alias) already registered raises unless ``replace=True``,
    which is for deliberate re-registration (a user kernel iterated on
    through :func:`mxnet_tpu_torch.tpu_kernel.register`)."""

    def _do(f: Callable) -> Callable:
        taken = [n for n in (name,) + tuple(aliases) if n in _REGISTRY]
        if taken and not replace:
            raise ValueError(
                "op %r is already registered (to %r); pass replace=True "
                "only for deliberate user-kernel re-registration"
                % (taken[0], _REGISTRY[taken[0]].fn))
        op = OpDef(name, f, differentiable=differentiable,
                   num_outputs=num_outputs, aux_writeback=aux_writeback,
                   mutates_input=mutates_input)
        for n in (name,) + tuple(aliases):
            _REGISTRY[n] = op
        return f

    if fn is None:
        return _do
    return _do(fn)


def alias(name: str, *names: str) -> None:
    op = _REGISTRY[name]
    for n in names:
        _REGISTRY[n] = op


def get_op(name: str) -> OpDef:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError("Operator %r is not registered (have %d ops)"
                       % (name, len(set(_REGISTRY.values())))) from None


def list_ops():
    """All registered op names (reference: MXListAllOpNames)."""
    return sorted(_REGISTRY.keys())


def amp_cast(op: OpDef, params: dict, args):
    """``args`` under the AMP policy in force for op ``op`` (unchanged
    when AMP is off)."""
    state = _amp_state()
    if state is None:
        return args
    return state.cast_inputs(op.name, params, args)


def dispatch(name: str, *args, **params):
    """Run registered op ``name`` on tensors: ``fn(*args, **params)`` after
    the AMP cast of its inputs (:func:`amp_cast`, keyed by the op's
    registered name, not the alias called)."""
    op = _REGISTRY[name]
    return op.fn(*amp_cast(op, params, args), **params)
