"""``mx.contrib``: the contrib op namespace over NDArrays and the 1.x
location of AMP.

Counterpart of ``mxnet_tpu/contrib/__init__.py``.  ``mx.contrib.nd`` (the
same module as ``mx.nd.contrib``) holds every registered ``_contrib_*``
op without its prefix and the bare detection ops; ``mx.contrib.amp`` is
``mx.amp``.  The control-flow combinators (``foreach``, ``while_loop``,
``cond``) raise until ``ops/control_flow.py`` is ported; ``quantization``,
``summary``, ``text`` and ``onnx`` are not ported yet.
"""
from .. import amp  # 1.x location: mx.contrib.amp (2.x: mx.amp)
from . import ndarray
from . import ndarray as nd
from .ndarray import foreach, while_loop, cond

__all__ = ["foreach", "while_loop", "cond", "nd", "ndarray", "amp"]
