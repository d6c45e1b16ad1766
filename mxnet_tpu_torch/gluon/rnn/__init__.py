"""Gluon recurrent layers and cells of the port (counterpart of
``mxnet_tpu/gluon/rnn/``)."""
from .rnn_layer import RNN, LSTM, GRU
from .rnn_cell import (RecurrentCell, HybridRecurrentCell, RNNCell, LSTMCell,
                       GRUCell, SequentialRNNCell, HybridSequentialRNNCell,
                       DropoutCell, ModifierCell, BidirectionalCell,
                       ResidualCell, ZoneoutCell)

__all__ = ["RNN", "LSTM", "GRU", "RecurrentCell", "HybridRecurrentCell",
           "RNNCell", "LSTMCell", "GRUCell", "SequentialRNNCell",
           "HybridSequentialRNNCell", "DropoutCell", "ModifierCell",
           "BidirectionalCell", "ResidualCell", "ZoneoutCell"]
