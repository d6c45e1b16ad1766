"""Gluon front end of the port: Blocks as ``torch.nn.Module``s."""
from .block import Block, HybridBlock
from . import nn
from . import model_zoo

__all__ = ["Block", "HybridBlock", "nn", "model_zoo"]
