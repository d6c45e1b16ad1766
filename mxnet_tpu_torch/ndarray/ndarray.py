"""NDArray: the imperative tensor of the port.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``.  An :class:`NDArray` wraps
one ``torch.Tensor``.  What differs from the reference, and why:

* The reference keeps a mutable chunk over an immutable ``jax.Array`` and
  composes basic indices so that slices write through to their base
  (``_Chunk``, ``_compose_index``).  A torch tensor is mutable and a basic
  slice or a reshape of a contiguous tensor is already a view sharing its
  storage, so that machinery is not ported: ``a[1:3][:] = 3`` writes into
  ``a`` as in MXNet.  Torch has no negative strides, so a negative-step
  slice reads a copy.
* Autograd is torch autograd (see :mod:`..autograd`): ``attach_grad`` makes
  the tensor a leaf that requires a gradient and keeps its gradient buffer
  and ``grad_req`` on the tensor, where ``autograd.backward`` finds them.
* Dispatch (:func:`invoke`) calls the registered op's torch function under
  ``torch.enable_grad()`` when autograd is recording and the op is
  differentiable, and under ``torch.no_grad()`` otherwise.  In-place writes
  (``a[:] = x``, ``a += 1``) are never recorded, as in the reference.
* Creation functions take ``ctx=`` and default to
  :func:`~..device.current_context`, which is the GPU.
* ``dtype`` is a numpy dtype, or the string ``'bfloat16'``, which numpy
  lacks; ``asnumpy`` returns bfloat16 data as float32.
"""
from __future__ import annotations

import numbers
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import autograd
from .. import profiler as _profiler
from ..engine import engine as _engine
from ..base import MXNetError, dtype_name, torch_dtype
from ..device import Context, resolve
from ..ops.matrix import infer_reshape
from ..ops.registry import amp_cast, get_op

__all__ = ["NDArray", "invoke", "array", "zeros", "ones", "full", "empty",
           "arange", "eye", "zeros_like", "ones_like", "concatenate",
           "stack_arrays", "waitall"]

# NDArray <op> number dispatches to the scalar family (ops/scalar.py);
# reverse forms swap the operands' roles
_SCALAR_OPS = {
    ("broadcast_add", False): "_plus_scalar",
    ("broadcast_add", True): "_plus_scalar",
    ("broadcast_sub", False): "_minus_scalar",
    ("broadcast_sub", True): "_rminus_scalar",
    ("broadcast_mul", False): "_mul_scalar",
    ("broadcast_mul", True): "_mul_scalar",
    ("broadcast_div", False): "_div_scalar",
    ("broadcast_div", True): "_rdiv_scalar",
    ("broadcast_mod", False): "_mod_scalar",
    ("broadcast_mod", True): "_rmod_scalar",
    ("broadcast_power", False): "_power_scalar",
    ("broadcast_power", True): "_rpower_scalar",
}


def _grad_mode():
    """Torch's grad mode for work the front end does itself: recorded
    while autograd is recording, not otherwise."""
    return torch.enable_grad() if autograd.is_recording() \
        else torch.no_grad()


class NDArray:
    __slots__ = ("_data", "__weakref__")

    # higher than numpy's so ndarray.__op__(NDArray) defers to us
    __array_priority__ = 1000.0

    def __init__(self, data: torch.Tensor):
        if not isinstance(data, torch.Tensor):
            raise TypeError("NDArray wraps a torch.Tensor, got %s"
                            % type(data).__name__)
        self._data = data

    # ------------------------------------------------------------------
    # basic properties
    # ------------------------------------------------------------------
    @property
    def data(self) -> torch.Tensor:
        """The wrapped tensor (shared, not copied)."""
        return self._data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        if self._data.dtype == torch.bfloat16:
            return "bfloat16"
        return np.dtype(dtype_name(self._data.dtype))

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def context(self) -> Context:
        return Context.from_torch(self._data.device)

    ctx = context
    device = context

    @property
    def stype(self) -> str:
        return "default"

    @property
    def T(self) -> "NDArray":
        return invoke("transpose", self)

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with multiple "
                             "elements is ambiguous.")
        return bool(self.asscalar())

    def __repr__(self):
        body = np.array2string(self.asnumpy(), precision=4, threshold=20)
        return "%s\n<NDArray %s @%s>" % (
            body, "x".join(str(d) for d in self.shape), self.context)

    # ------------------------------------------------------------------
    # sync / host transfer
    # ------------------------------------------------------------------
    def wait_to_read(self) -> None:
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def asnumpy(self) -> np.ndarray:
        """A host copy (a sync point, as in the reference).  A bfloat16
        array comes back as float32 holding exactly its bf16 values, where
        the reference returns ``ml_dtypes.bfloat16``: numpy has no bf16 of
        its own, and the port does not depend on ``ml_dtypes``."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __index__(self):
        if self.size == 1:
            return int(self.asscalar())
        raise TypeError("only integer scalar arrays can be converted to index")

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def tolist(self):
        return self.asnumpy().tolist()

    # ------------------------------------------------------------------
    # copies / context movement
    # ------------------------------------------------------------------
    def copy(self) -> "NDArray":
        return NDArray(self._data.detach().clone())

    def copyto(self, other: Union["NDArray", Context]) -> "NDArray":
        """Copy into ``other`` (an NDArray, cast to its dtype) or onto a new
        array in context ``other``."""
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(resolve(other), copy=True))
        if not isinstance(other, NDArray):
            raise TypeError("copyto expects NDArray or Context")
        with torch.no_grad():
            other._data.copy_(self._data)
        return other

    def as_in_context(self, ctx: Context) -> "NDArray":
        if ctx == self.context:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context

    def astype(self, dtype, copy: bool = True) -> "NDArray":
        if not copy and self._data.dtype == torch_dtype(dtype):
            return self
        return invoke("cast", self, dtype=dtype_name(torch_dtype(dtype)))

    # ------------------------------------------------------------------
    # autograd surface (reference: attach_grad / .grad / detach / backward)
    # ------------------------------------------------------------------
    def attach_grad(self, grad_req: str = "write", stype=None) -> None:
        """Make this array a variable: a leaf that requires a gradient,
        with a zero gradient buffer that ``backward`` writes ('write'),
        adds to ('add') or leaves alone ('null')."""
        if grad_req not in ("write", "add", "null"):
            raise ValueError("grad_req must be 'write', 'add' or 'null', "
                             "got %r" % (grad_req,))
        if not self._data.is_leaf:
            self._data = self._data.detach()
        t = self._data
        t.requires_grad_(True)
        t._mx_grad = torch.zeros_like(t, requires_grad=False)
        t.grad_req = grad_req

    @property
    def grad(self) -> Optional["NDArray"]:
        g = getattr(self._data, "_mx_grad", None)
        return None if g is None else NDArray(g)

    def detach(self) -> "NDArray":
        return NDArray(self._data.detach())

    def backward(self, out_grad: Optional["NDArray"] = None,
                 retain_graph: bool = False, train_mode: bool = True) -> None:
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # ------------------------------------------------------------------
    # indexing
    # ------------------------------------------------------------------
    def _key(self, key, for_write: bool = False):
        """``key`` for torch: NDArray indices as integer tensors; a
        negative-step slice as flips of ``self`` (reads) or an index
        tensor (writes).  Returns (tensor to index, key)."""
        ks = list(key) if isinstance(key, tuple) else [key]
        for i, k in enumerate(ks):
            if isinstance(k, NDArray):
                k = k._data
            if isinstance(k, torch.Tensor) and k.dtype != torch.bool:
                k = k.long()
            ks[i] = k
        t = self._data
        neg = [i for i, k in enumerate(ks)
               if isinstance(k, slice) and k.step is not None and k.step < 0]
        if neg:
            dims = self._dims_of(ks)
            if for_write and len(neg) > 1:
                raise MXNetError("a write through more than one "
                                 "negative-step slice is not supported")
            for i in neg:
                n = t.shape[dims[i]]
                start, stop, step = ks[i].indices(n)
                if for_write:
                    ks[i] = torch.arange(start, stop, step, device=t.device)
                else:
                    t = t.flip(dims[i])
                    ks[i] = slice(n - 1 - start, n - 1 - stop, -step)
        return t, (tuple(ks) if isinstance(key, tuple) else ks[0])

    def _dims_of(self, ks):
        """The tensor dim each entry of an index list addresses (None for
        entries that address no dim)."""
        n_dims = sum(1 for k in ks if k is not None and k is not Ellipsis)
        dims, d = [], 0
        for k in ks:
            if k is None:
                dims.append(None)
            elif k is Ellipsis:
                dims.append(None)
                d += self.ndim - n_dims
            else:
                dims.append(d)
                d += 1
        return dims

    def __getitem__(self, key) -> "NDArray":
        t, key = self._key(key)
        with _grad_mode():
            return NDArray(t[key])

    def __setitem__(self, key, value) -> None:
        t, key = self._key(key, for_write=True)
        if isinstance(value, NDArray):
            value = value._data
        elif isinstance(value, (np.ndarray, list, tuple)):
            value = torch.as_tensor(np.asarray(value))
        with torch.no_grad():
            if isinstance(value, torch.Tensor):
                value = value.to(device=t.device, dtype=t.dtype)
            t[key] = value
        _engine.maybe_sync(t)

    # ------------------------------------------------------------------
    # reshape (a view where torch can make one)
    # ------------------------------------------------------------------
    def reshape(self, *shape, **kwargs) -> "NDArray":
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        shape = infer_reshape(self.shape, shape)
        with _grad_mode():
            return NDArray(self._data.reshape(shape))

    def reshape_like(self, other: "NDArray") -> "NDArray":
        return self.reshape(other.shape)

    # ------------------------------------------------------------------
    # arithmetic: every operator dispatches through the op registry
    # ------------------------------------------------------------------
    def _binop(self, name, other, reverse=False):
        if isinstance(other, numbers.Number) and not isinstance(other, bool):
            scalar_op = _SCALAR_OPS.get((name, reverse))
            if scalar_op is not None:
                return invoke(scalar_op, self, scalar=other)
            other = full((), other, ctx=self.context,
                         dtype=dtype_name(self._data.dtype))
        elif isinstance(other, (np.ndarray, list, tuple)):
            other = array(other, ctx=self.context)
        if not isinstance(other, NDArray):
            return NotImplemented
        return invoke(name, other, self) if reverse \
            else invoke(name, self, other)

    def __add__(self, o):  return self._binop("broadcast_add", o)
    def __radd__(self, o): return self._binop("broadcast_add", o, True)
    def __sub__(self, o):  return self._binop("broadcast_sub", o)
    def __rsub__(self, o): return self._binop("broadcast_sub", o, True)
    def __mul__(self, o):  return self._binop("broadcast_mul", o)
    def __rmul__(self, o): return self._binop("broadcast_mul", o, True)
    def __truediv__(self, o):  return self._binop("broadcast_div", o)
    def __rtruediv__(self, o): return self._binop("broadcast_div", o, True)
    def __mod__(self, o):  return self._binop("broadcast_mod", o)
    def __rmod__(self, o): return self._binop("broadcast_mod", o, True)
    def __pow__(self, o):  return self._binop("broadcast_power", o)
    def __rpow__(self, o): return self._binop("broadcast_power", o, True)
    def __matmul__(self, o): return invoke("dot", self, o)
    def __neg__(self): return invoke("negative", self)
    def __abs__(self): return invoke("abs", self)

    # comparisons return 0/1 in the float type (the legacy mx.nd rule)
    def __eq__(self, o):
        return False if o is None else self._binop("broadcast_equal", o)

    def __ne__(self, o):
        return True if o is None else self._binop("broadcast_not_equal", o)

    def __gt__(self, o): return self._binop("broadcast_greater", o)
    def __ge__(self, o): return self._binop("broadcast_greater_equal", o)
    def __lt__(self, o): return self._binop("broadcast_lesser", o)
    def __le__(self, o): return self._binop("broadcast_lesser_equal", o)

    def __hash__(self):
        return id(self)

    # in-place operators write the result into this array's storage
    def _ibinop(self, name, other):
        res = self._binop(name, other)
        if res is NotImplemented:
            return res
        with torch.no_grad():
            self._data.copy_(res._data)
        return self

    def __iadd__(self, o): return self._ibinop("broadcast_add", o)
    def __isub__(self, o): return self._ibinop("broadcast_sub", o)
    def __imul__(self, o): return self._ibinop("broadcast_mul", o)
    def __itruediv__(self, o): return self._ibinop("broadcast_div", o)

    # ------------------------------------------------------------------
    # method forms of common ops
    # ------------------------------------------------------------------
    def sum(self, axis=None, keepdims=False, **kw):
        return invoke("sum", self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False, **kw):
        return invoke("mean", self, axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False, **kw):
        return invoke("max", self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False, **kw):
        return invoke("min", self, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return invoke("argmax", self, axis=axis, keepdims=keepdims)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return invoke("transpose", self, axes=axes if axes else None)

    def flatten(self):
        return invoke("flatten", self)

    def expand_dims(self, axis):
        return invoke("expand_dims", self, axis=axis)

    def squeeze(self, axis=None):
        return invoke("squeeze", self, axis=axis)

    def broadcast_to(self, shape):
        return invoke("broadcast_to", self, shape=tuple(shape))

    def clip(self, a_min=None, a_max=None):
        return invoke("clip", self, a_min=a_min, a_max=a_max)

    def abs(self):
        return invoke("abs", self)

    def sqrt(self):
        return invoke("sqrt", self)

    def exp(self):
        return invoke("exp", self)

    def log(self):
        return invoke("log", self)

    def relu(self):
        return invoke("relu", self)

    def sigmoid(self):
        return invoke("sigmoid", self)

    def tanh(self):
        return invoke("tanh", self)

    def softmax(self, axis=-1):
        return invoke("softmax", self, axis=axis)

    def log_softmax(self, axis=-1):
        return invoke("log_softmax", self, axis=axis)

    def dot(self, other):
        return invoke("dot", self, other)

    def one_hot(self, depth, on_value=1.0, off_value=0.0, dtype="float32"):
        return invoke("one_hot", self, depth=depth, on_value=on_value,
                      off_value=off_value, dtype=dtype)

    def slice_axis(self, axis, begin, end):
        return invoke("slice_axis", self, axis=axis, begin=begin, end=end)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return invoke("split", self, num_outputs=num_outputs, axis=axis,
                      squeeze_axis=squeeze_axis)


# ---------------------------------------------------------------------------
# eager dispatch (reference: MXImperativeInvokeEx -> Imperative::Invoke)
# ---------------------------------------------------------------------------

def invoke(op_name: str, *inputs, out: Optional[NDArray] = None, **params):
    """Run registered op ``op_name`` on NDArrays (or tensors) and wrap its
    outputs as NDArrays.

    Positional plain values in defaulted slots become attributes (the
    classic-API convention, :meth:`OpDef.split_pos_attrs`).  ``ctx=`` places
    the outputs; an op with no array input is a creation op and gets the
    device (``ctx``, else the current context) as ``device=``.  The op runs
    under ``torch.enable_grad()`` when autograd is recording and the op is
    differentiable, else under ``torch.no_grad()``, so a non-differentiable
    op's output carries no gradient.  The outputs of a differentiable op run
    while recording are marked as recorded (``autograd.RECORDED``), even
    when no input needs a gradient, as the reference gives them a tape node:
    ``backward`` on such a head writes nothing instead of raising.
    Under AMP the op's floating inputs are cast by the policy in force
    (``registry.amp_cast``), as :func:`..ops.registry.dispatch` casts them.
    An op's aux outputs (``OpDef.aux_writeback``: ``BatchNorm``'s new moving
    statistics, an optimizer update's new state) are written into their
    inputs in place and are not returned; an op that mutates an input
    (``OpDef.mutates_input``: the optimizer updates' weight) writes its
    first visible output there and returns that input.  ``out=`` receives
    the result in place.

    Each call counts one dispatch (``engine.dispatch_count``); under
    ``MXNET_ENGINE_TYPE=NaiveEngine`` it waits for the device after the
    op, and while the profiler runs with ``profile_imperative`` (or
    ``profile_all``) it is one span of the profiler's table."""
    if _profiler.IMPERATIVE:
        with _profiler.op_span(op_name):
            ret = _invoke_impl(op_name, *inputs, out=out, **params)
            if _profiler.want_sync():
                _engine.wait_for_var(ret[0] if isinstance(ret, list)
                                     else ret)
        return ret
    return _invoke_impl(op_name, *inputs, out=out, **params)


def _invoke_impl(op_name: str, *inputs, out: Optional[NDArray] = None,
                 _counted: bool = True, **params):
    op = get_op(op_name)
    if _counted:
        _engine.count_dispatch()
    inputs = op.split_pos_attrs(inputs, params, NDArray)
    ctx = params.pop("ctx", None)
    params.pop("name", None)
    args = [x._data if isinstance(x, NDArray) else x for x in inputs]
    if not any(isinstance(a, torch.Tensor) for a in args):
        params["device"] = resolve(ctx)
    record = autograd.is_recording() and op.differentiable
    with (torch.enable_grad() if record else torch.no_grad()):
        outs = op.fn(*amp_cast(op, params, args), **params)
        if ctx is not None:
            dev = resolve(ctx)
            outs = [o.to(dev) for o in outs] \
                if isinstance(outs, (tuple, list)) else outs.to(dev)
    if record:
        for o in (outs if isinstance(outs, (tuple, list)) else (outs,)):
            if isinstance(o, torch.Tensor):
                setattr(o, autograd.RECORDED, True)
    outs = _wrap_outputs(op, outs)
    _engine.maybe_sync(outs[0] if isinstance(outs, list) else outs)
    aux = op.aux_map(params)
    if aux and isinstance(outs, list):
        outs = _write_aux(aux, inputs, outs)
    if op.mutates_input is not None:
        target = inputs[op.mutates_input]
        src = outs[0] if isinstance(outs, list) else outs
        with torch.no_grad():
            target._data.copy_(src._data)
        return target
    if out is not None:
        src = outs[0] if isinstance(outs, list) else outs
        with torch.no_grad():
            out._data.copy_(src._data)
        return out
    return outs


def _write_aux(aux, inputs, outs):
    """Copy each aux output into its input NDArray, in that array's dtype,
    and return the other outputs (reference: ``invoke``'s aux-state
    write-back)."""
    visible = []
    for i, o in enumerate(outs):
        target = aux.get(i)
        if target is None:
            visible.append(o)
        elif isinstance(inputs[target], NDArray):
            with torch.no_grad():
                inputs[target]._data.copy_(o._data)
    return visible[0] if len(visible) == 1 else visible


def _wrap_outputs(op, outs):
    if isinstance(outs, (tuple, list)):
        if len(outs) == 1 and op.num_outputs == 1:
            return NDArray(outs[0])
        return [NDArray(o) for o in outs]
    return NDArray(outs)


# ---------------------------------------------------------------------------
# creation functions (reference: python/mxnet/ndarray/utils.py + ndarray.py)
# ---------------------------------------------------------------------------

def array(source, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """A new array holding a copy of ``source`` (an NDArray, tensor, numpy
    array, nested list or scalar) on ``ctx`` (default: the current context),
    of ``source``'s shape (a scalar or 0-d array gives shape ()).  Python
    scalars and lists and float64 numpy data become float32, as in the
    reference; int64 data, and a ``dtype`` of int64, become int32, as the
    reference's arrays hold them (``base.NARROWED``); other dtypes keep
    their type."""
    dev = resolve(ctx)
    if isinstance(source, NDArray):
        source = source._data
    if isinstance(source, torch.Tensor):
        t = source.detach()
    else:
        is_np = isinstance(source, np.ndarray) or hasattr(source, "__array__")
        arr = np.asarray(source)
        if dtype is None and (not is_np or arr.dtype == np.float64):
            dtype = "float32"
        # np.ascontiguousarray would make a 0-d array 1-d
        t = torch.as_tensor(np.array(arr, order="C"))
    t = t.to(torch_dtype(t.dtype if dtype is None else dtype))
    return NDArray(t.to(dev, copy=True))


# The creation functions run their op uncounted: the reference makes
# these arrays on the host and places them, no dispatch of its engine.

def zeros(shape, ctx=None, dtype=None, **kw) -> NDArray:
    return _invoke_impl("_zeros", shape=shape, dtype=dtype, ctx=ctx,
                        _counted=False)


def ones(shape, ctx=None, dtype=None, **kw) -> NDArray:
    return _invoke_impl("_ones", shape=shape, dtype=dtype, ctx=ctx,
                        _counted=False)


def full(shape, val, ctx=None, dtype=None, **kw) -> NDArray:
    return _invoke_impl("_full", shape=shape, value=val, dtype=dtype,
                        ctx=ctx, _counted=False)


def empty(shape, ctx=None, dtype=None) -> NDArray:
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=None) -> NDArray:
    return _invoke_impl("_arange", start=start, stop=stop, step=step,
                        repeat=repeat, dtype=dtype, ctx=ctx, _counted=False)


def eye(N, M=0, k=0, ctx=None, dtype=None) -> NDArray:
    """An N x M (N x N when M is 0) matrix of ones on the k-th diagonal
    (reference: ``mx.nd.eye``)."""
    return _invoke_impl("_eye", N=N, M=M, k=k, dtype=dtype, ctx=ctx,
                        _counted=False)


def zeros_like(a: NDArray, **kw) -> NDArray:
    return zeros(a.shape, ctx=a.context, dtype=a.dtype)


def ones_like(a: NDArray, **kw) -> NDArray:
    return ones(a.shape, ctx=a.context, dtype=a.dtype)


def concatenate(arrays: Sequence[NDArray], axis=0) -> NDArray:
    """Join ``arrays`` along ``axis`` (the ``concat`` op)."""
    return invoke("concat", *arrays, dim=axis)


def stack_arrays(arrays: Sequence[NDArray], axis=0) -> NDArray:
    return invoke("stack", *arrays, axis=axis)


def waitall() -> None:
    """Wait for every queued device operation (reference: nd.waitall)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
