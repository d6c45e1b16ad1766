"""Pretrained weights of the model zoo (counterpart of
``mxnet_tpu/gluon/model_zoo/model_store.py``).

The reference loads a local weight file and, with none dropped in place
and no network, raises ``FileNotFoundError``.  The port has no weight
store (``get_model_file`` and its cache are Queue 1 item 8), so
``pretrained=True`` raises the same error everywhere; weights come in
through ``Block.load_parameters`` (a reference ``.params`` file) or
:func:`mxnet_tpu_torch.convert.params_from_mxnet_tpu`.
"""
from __future__ import annotations

__all__ = ["load_pretrained"]


def load_pretrained(name: str):
    """The ``pretrained=True`` path of every zoo builder: raises
    ``FileNotFoundError`` naming ``name``."""
    raise FileNotFoundError(
        "%s: the port has no pretrained weight store; load weights with "
        "mxnet_tpu_torch.convert.params_from_mxnet_tpu" % name)
