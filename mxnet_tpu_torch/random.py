"""Global seeding of the random ops (reference: ``mxnet_tpu/random.py``,
python/mxnet/random.py ``seed``).

``seed(s)`` reseeds the calling thread's ``torch.Generator`` of every
device that :mod:`.ops.random` draws from; a ``ctx`` seeds them all, as
the reference's per-context seeds collapse to one root key.
"""
from __future__ import annotations

from .ops import random as _impl

__all__ = ["seed"]


def seed(seed_state: int, ctx=None) -> None:
    _impl.seed(seed_state)
