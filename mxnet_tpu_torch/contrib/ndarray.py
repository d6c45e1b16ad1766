"""``mx.contrib.nd`` / ``mx.nd.contrib``: the contrib op namespace over
NDArrays.

Counterpart of ``mxnet_tpu/contrib/ndarray.py``: built from the port's
op registry as the reference's is built from its own, so every
``_contrib_*`` op the port registers appears here without its prefix,
plus the detection and spatial ops registered under bare names.  A
``_contrib_*`` op the port has not ported is absent here, as the op is.
"""
from __future__ import annotations

import sys

from ..ops import registry as _registry
from ..ndarray.ndarray import invoke

__all__ = ["foreach", "while_loop", "cond"]

_CONTROL_FLOW = ("mx.nd.contrib.%s waits for ops/control_flow.py, which "
                 "is not ported yet (ROADMAP Queue 1 item 8)")


def foreach(*args, **kwargs):
    """Not ported yet: raises ``NotImplementedError``."""
    raise NotImplementedError(_CONTROL_FLOW % "foreach")


def while_loop(*args, **kwargs):
    """Not ported yet: raises ``NotImplementedError``."""
    raise NotImplementedError(_CONTROL_FLOW % "while_loop")


def cond(*args, **kwargs):
    """Not ported yet: raises ``NotImplementedError``."""
    raise NotImplementedError(_CONTROL_FLOW % "cond")


def _make(opname):
    def fn(*args, out=None, **kwargs):
        return invoke(opname, *args, out=out, **kwargs)
    fn.__name__ = opname
    fn.__doc__ = _registry.get_op(opname).doc
    return fn


_this = sys.modules[__name__]
for _name in _registry.list_ops():
    if _name.startswith("_contrib_"):
        _short = _name[len("_contrib_"):]
        if _short.isidentifier() and not hasattr(_this, _short):
            setattr(_this, _short, _make(_name))
# detection/spatial ops registered under bare names are contrib surface too
for _name in ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
              "ROIAlign", "box_iou", "box_nms"):
    if not hasattr(_this, _name):
        try:
            setattr(_this, _name, _make(_name))
        except KeyError:
            pass
