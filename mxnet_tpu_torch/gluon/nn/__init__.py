"""Gluon layers of the port."""
from .basic_layers import (Activation, Dense, Dropout, Embedding, GELU,
                           HybridSequential, LayerNorm)

__all__ = ["Activation", "Dense", "Dropout", "Embedding", "GELU",
           "HybridSequential", "LayerNorm"]
