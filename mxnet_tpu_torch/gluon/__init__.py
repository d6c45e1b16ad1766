"""Gluon front end of the port: Blocks as ``torch.nn.Module``s, gluon
``Parameter`` handles, the ``Trainer``, the utilities and ``data``
(datasets, samplers, ``DataLoader``, vision datasets and transforms)."""
from .block import Block, HybridBlock, functionalize
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer
from . import loss
from . import nn
from . import model_zoo
from . import utils
from . import data

__all__ = ["Block", "HybridBlock", "functionalize", "Parameter", "Constant",
           "ParameterDict", "DeferredInitializationError", "Trainer", "loss",
           "nn", "model_zoo", "utils", "data"]
