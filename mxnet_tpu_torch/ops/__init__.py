"""Operators of the port: attention (with the hand-written flash kernels),
the nn functions of the serving and training slices, the registered ops
the imperative front end (``nd``) dispatches to by name, the optimizer
updates (``nd.sgd_mom_update``, ...) with the fused apply behind
``optimizer.Optimizer``, the random samplers (``nd.random.*``), the image
ops (``_image_*``, the ``_cv*`` ops) and the spatial ops
(``GridGenerator``, ``BilinearSampler``, the ROI ops, ...) and the
detection ops (box IoU and NMS, the SSD MultiBox family) and AMP's
finite checks and multicast."""
from . import registry
from .registry import OpDef, get_op, list_ops, register
from . import attention, nn
from . import creation, elemwise, scalar, reduce, matrix
from . import optimizer
from . import random
from . import image, spatial
from . import detection
from . import rnn
from . import misc

__all__ = ["registry", "OpDef", "get_op", "list_ops", "register",
           "attention", "nn", "creation", "elemwise", "scalar",
           "reduce", "matrix", "optimizer", "random", "image", "spatial",
           "detection", "rnn", "misc"]
