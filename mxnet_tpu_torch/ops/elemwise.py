"""Elementwise binary (broadcasting) and unary ops.

Counterpart of ``mxnet_tpu/ops/elemwise.py``, on ``torch.Tensor``s: every
legacy name the reference registers there, with its aliases, parameters
and output dtypes.  Where ``torch`` answers differently from the ``jnp``
function the reference calls (an integer input to ``floor``, ``digamma``
at a non-positive integer, a Python number as an operand of ``maximum``),
the op follows the reference.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


def _int_operands(a, b):
    """(a, b) as tensors of their integer result type on one device, or
    None when the result type is not an integer one."""
    dt = torch.result_type(a, b)
    if dt.is_floating_point or dt.is_complex or dt == torch.bool:
        return None
    dev = a.device if isinstance(a, torch.Tensor) else b.device
    return (torch.as_tensor(a, dtype=dt, device=dev),
            torch.as_tensor(b, dtype=dt, device=dev))


def power(a, b):
    """``jnp.power``: on integers the reference's binary exponentiation
    over the low six bits of the exponent (jnp's ``_pow_int_int``), the
    products wrapping in the integer type, so a negative exponent gives the
    wrapped power of its low bits (``torch.pow`` raises or gives 0) and
    0 ** e = 0 for e != 0; ``torch.pow`` otherwise."""
    ints = _int_operands(a, b)
    if ints is None:
        return torch.pow(a, b)
    a, b = torch.broadcast_tensors(*ints)
    acc = torch.where((a == 0) & (b != 0), 0, 1).to(a.dtype)
    for _ in range(6):
        acc = torch.where((b & 1) != 0, acc * a, acc)
        a = a * a
        b = b >> 1          # the low bits shift alike, arithmetic or not
    return acc


def mod(a, b):
    """``jnp.mod``: the remainder takes the divisor's sign (as
    ``torch.remainder``); an integer divisor of 0 gives 0, as the reference
    divides by 1 there, where torch raises."""
    ints = _int_operands(a, b)
    if ints is not None:
        a, b = ints
        b = torch.where(b == 0, torch.ones_like(b), b)
    return torch.remainder(a, b)


def _tensors(a, b):
    """(a, b) as tensors on one device, a Python number taking the other
    operand's type as JAX's weak typing gives it (a float number meeting an
    integer tensor gives float32)."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a, b
    t = a if isinstance(a, torch.Tensor) else b
    dt = torch.result_type(a, b)
    a, b = (torch.as_tensor(v, dtype=dt, device=t.device) for v in (a, b))
    return a, b


def _floating(a, b):
    """(a, b) as tensors in their floating result type (float32 for
    integers), as ``jnp``'s inexact functions promote them."""
    a, b = _tensors(a, b)
    dt = torch.result_type(a, b)
    if not dt.is_floating_point:
        dt = torch.float32
    return a.to(dt), b.to(dt)


def maximum(a, b):
    """``jnp.maximum``: the gradient of a tie is split evenly between the
    operands, as ``torch.maximum``'s is."""
    return torch.maximum(*_tensors(a, b))


def minimum(a, b):
    return torch.minimum(*_tensors(a, b))


def hypot(a, b):
    """``jnp.hypot``: sqrt(a^2 + b^2) without overflow (finite for
    operands near the float32 maximum), in a floating type."""
    return torch.hypot(*_floating(a, b))


def arctan2(a, b):
    return torch.atan2(*_floating(a, b))


_BINARY = {
    "broadcast_add": (torch.add, ["elemwise_add", "_plus", "_add"]),
    "broadcast_sub": (torch.sub, ["elemwise_sub", "_minus", "_sub"]),
    "broadcast_mul": (torch.mul, ["elemwise_mul", "_mul"]),
    "broadcast_div": (torch.true_divide, ["elemwise_div", "_div"]),
    "broadcast_mod": (mod, ["_mod"]),
    "broadcast_power": (power, ["_power", "pow"]),
    "broadcast_maximum": (maximum, ["_maximum", "maximum"]),
    "broadcast_minimum": (minimum, ["_minimum", "minimum"]),
    "broadcast_hypot": (hypot, []),
    "arctan2": (arctan2, []),
}

for _name, (_fn, _aliases) in _BINARY.items():
    register(_name, _fn, aliases=_aliases)

_COMPARE = {
    "broadcast_equal": torch.eq,
    "broadcast_not_equal": torch.ne,
    "broadcast_greater": torch.gt,
    "broadcast_greater_equal": torch.ge,
    "broadcast_lesser": torch.lt,
    "broadcast_lesser_equal": torch.le,
    "broadcast_logical_and": torch.logical_and,
    "broadcast_logical_or": torch.logical_or,
    "broadcast_logical_xor": torch.logical_xor,
}


def _floating_dtype(x):
    return x.dtype if x.is_floating_point() else torch.float32


def _comparison(f):
    def cmp(a, b):
        """MXNet comparisons return 0/1 in a's float type (float32 for
        integer inputs), not bool."""
        a, b = _tensors(a, b)
        return f(a, b).to(_floating_dtype(a))
    return cmp


for _name, _fn in _COMPARE.items():
    register(_name, _comparison(_fn), differentiable=False,
             aliases=[_name.replace("broadcast_", "")])


def _keep_integers(f):
    """``f`` on floats; an integer or bool tensor comes back unchanged, as
    ``jnp.floor``/``trunc``/... return it (``torch.trunc`` refuses it)."""
    def op(x):
        return f(x) if x.is_floating_point() else x
    return op


def _inexact(f):
    """``f`` with an integer or bool input promoted to float32 first, as
    ``jnp``'s inexact functions promote it."""
    def op(x):
        return f(x if x.is_floating_point() else x.to(torch.float32))
    return op


def _non_positive_integer(x):
    return (x <= 0) & (x == torch.floor(x))


def gamma(x):
    """``exp(lgamma(x))``, as the reference computes it: |Gamma(x)|, so a
    negative x where Gamma is negative gives its magnitude; inf at a
    non-positive integer."""
    return torch.exp(torch.lgamma(x))


def digamma(x):
    """``lax.digamma``: NaN at every non-positive integer, 0 included
    (``torch.digamma`` gives -inf at 0)."""
    return torch.where(_non_positive_integer(x),
                       torch.full_like(x, float("nan")), torch.digamma(x))


def cbrt(x):
    """The real cube root, negative for a negative x (torch has no
    ``cbrt``)."""
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def logical_not(x):
    """1 where x is 0, else 0, in x's float type (float32 for integers)."""
    return torch.logical_not(x).to(_floating_dtype(x))


_UNARY = {
    "negative": torch.neg,
    "abs": torch.abs,
    "sign": torch.sign,
    "floor": _keep_integers(torch.floor),
    "ceil": _keep_integers(torch.ceil),
    "round": _keep_integers(torch.round),      # half to even, as jnp's
    "rint": _inexact(torch.round),             # jnp.rint promotes integers
    "trunc": _keep_integers(torch.trunc),
    "fix": _keep_integers(torch.trunc),
    "exp": torch.exp,
    "expm1": _inexact(torch.expm1),
    "log": torch.log,
    "log10": _inexact(torch.log10),
    "log2": _inexact(torch.log2),
    "log1p": _inexact(torch.log1p),
    "sqrt": torch.sqrt,
    "cbrt": _inexact(cbrt),
    "square": torch.square,
    "reciprocal": _inexact(torch.reciprocal),
    "rsqrt": _inexact(torch.rsqrt),
    "sin": torch.sin,
    "cos": _inexact(torch.cos),
    "tan": _inexact(torch.tan),
    "arcsin": _inexact(torch.asin),
    "arccos": _inexact(torch.acos),
    "arctan": _inexact(torch.atan),
    "sinh": _inexact(torch.sinh),
    "cosh": _inexact(torch.cosh),
    "tanh": torch.tanh,
    "arcsinh": _inexact(torch.asinh),
    "arccosh": _inexact(torch.acosh),
    "arctanh": _inexact(torch.atanh),
    "erf": _inexact(torch.erf),
    "erfinv": _inexact(torch.erfinv),
    "gamma": _inexact(gamma),
    "gammaln": _inexact(torch.lgamma),
    "digamma": _inexact(digamma),
    "sigmoid": torch.sigmoid,
    "softsign": lambda x: x / (1.0 + torch.abs(x)),
    "relu": torch.relu,        # gradient 0 at x == 0, as the reference's
    "logical_not": logical_not,
    "identity": torch.clone,   # a copy: the output must not alias x
}

_UNARY_NONDIFF = {"sign", "floor", "ceil", "round", "rint", "trunc", "fix",
                  "logical_not"}
_UNARY_ALIASES = {"identity": ["_copy"]}

for _name, _fn in _UNARY.items():
    register(_name, _fn, differentiable=_name not in _UNARY_NONDIFF,
             aliases=_UNARY_ALIASES.get(_name, ()))


@register("clip")
def _clip(x, a_min=None, a_max=None):
    return torch.clamp(x, a_min, a_max)


def _flag(f):
    def op(x):
        return f(x).to(torch.float32)
    return op


for _name, _fn in (("isnan", torch.isnan), ("isinf", torch.isinf),
                   ("isfinite", torch.isfinite)):
    register(_name, _flag(_fn), differentiable=False)


@register("cast", aliases=["Cast"])
def _cast(x, dtype="float32"):
    """``x`` in ``dtype``.  A floating-point x cast to an integer type
    saturates, NaN giving 0, as the reference's conversion does (-1.7 to
    uint8 is 0, 300.2 is 255); torch's conversion wraps there.  The bounds
    are applied in float64, which holds every int32 bound exactly."""
    dt = torch_dtype(dtype)
    if x.is_floating_point() and not (dt.is_floating_point or dt.is_complex
                                      or dt == torch.bool):
        info = torch.iinfo(dt)
        x = x.double().nan_to_num(0.0, posinf=info.max, neginf=info.min) \
            .clamp(info.min, info.max)
    return x.to(dt)


register("amp_cast", _cast)


@register("where")
def where(cond, a, b):
    """a where cond is nonzero, else b (in their promoted type)."""
    a, b = _tensors(a, b)
    return torch.where(cond.bool(), a, b)


@register("smooth_l1")
def smooth_l1(x, scalar=1.0):
    """0.5 (sigma x)^2 where |x| < 1 / sigma^2, else |x| - 0.5 / sigma^2,
    with sigma = ``scalar``; |x| = 1 / sigma^2 takes the linear branch, as
    the reference's ``<`` does."""
    s2 = scalar * scalar
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * x * x, absx - 0.5 / s2)
