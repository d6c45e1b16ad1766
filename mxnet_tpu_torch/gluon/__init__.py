"""Gluon front end of the port: Blocks as ``torch.nn.Module``s, gluon
``Parameter`` handles, the ``Trainer``, the utilities, ``data``
(datasets, samplers, ``DataLoader``, vision datasets and transforms),
``rnn`` (recurrent layers and cells) and ``metric``, the package's
``mx.metric`` under its 2.x name."""
from .block import Block, HybridBlock, functionalize
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer
from . import loss
from . import nn
from . import model_zoo
from . import utils
from . import data
from . import rnn
from .. import metric

__all__ = ["Block", "HybridBlock", "functionalize", "Parameter", "Constant",
           "ParameterDict", "DeferredInitializationError", "Trainer", "loss",
           "nn", "model_zoo", "utils", "data", "rnn", "metric"]
