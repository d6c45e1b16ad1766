"""Gluon front end of the port: Blocks as ``torch.nn.Module``s, gluon
``Parameter`` handles, the ``Trainer`` and the utilities."""
from .block import Block, HybridBlock, functionalize
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer
from . import loss
from . import nn
from . import model_zoo
from . import utils

__all__ = ["Block", "HybridBlock", "functionalize", "Parameter", "Constant",
           "ParameterDict", "DeferredInitializationError", "Trainer", "loss",
           "nn", "model_zoo", "utils"]
