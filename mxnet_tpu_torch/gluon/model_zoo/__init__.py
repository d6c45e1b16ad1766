"""Model zoo of the port (reference: python/mxnet/gluon/model_zoo/)."""
from . import bert
from . import ssd
from . import vision
from .vision import get_model
from .bert import BERTModel, bert_12_768_12, bert_24_1024_16

__all__ = ["vision", "bert", "ssd", "get_model", "BERTModel", "bert_12_768_12",
           "bert_24_1024_16"]
