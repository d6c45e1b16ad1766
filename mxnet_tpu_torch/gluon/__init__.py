"""Gluon front end of the port: Blocks as ``torch.nn.Module``s."""
from .block import Block, HybridBlock, functionalize
from . import loss
from . import nn
from . import model_zoo

__all__ = ["Block", "HybridBlock", "functionalize", "loss", "nn",
           "model_zoo"]
