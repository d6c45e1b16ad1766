"""Gluon layers of the port."""
from .basic_layers import (Activation, Dense, Dropout, Embedding, GELU,
                           HybridSequential, LayerNorm, set_dropout_generator)

__all__ = ["Activation", "Dense", "Dropout", "Embedding", "GELU",
           "HybridSequential", "LayerNorm", "set_dropout_generator"]
