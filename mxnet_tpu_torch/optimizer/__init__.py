"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer/``)."""
from .optimizer import (Optimizer, Updater, get_updater, register, create,
                        SGD, NAG, Adam, AdamW, RMSProp, AdaGrad, AdaDelta,
                        Ftrl, LAMB, LARS, Signum, SignSGD, DCASGD, Test)

__all__ = ["Optimizer", "Updater", "get_updater", "register", "create",
           "SGD", "NAG", "Adam", "AdamW", "RMSProp", "AdaGrad", "AdaDelta",
           "Ftrl", "LAMB", "LARS", "Signum", "SignSGD", "DCASGD", "Test"]
