"""Errors and environment knobs of the PyTorch port.

Counterpart of ``mxnet_tpu/base.py``: :class:`MXNetError` and
:func:`get_env`, with the catalog limited to the knobs the port reads.
"""
from __future__ import annotations

import os
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["MXNetError", "ENV_CATALOG", "get_env", "DTYPES", "NARROWED",
           "torch_dtype", "dtype_name"]


class MXNetError(RuntimeError):
    """Default error type raised by the framework."""


#: name -> (default, doc)
ENV_CATALOG = {
    "MX_SERVE_BUCKETS": ("1,2,4,8,16", "Comma-separated batch-size buckets "
                         "a servable warms; every micro-batch is padded up to "
                         "the smallest bucket that fits, and requests larger "
                         "than the top bucket are refused at admission."),
    "MX_SERVE_MAX_BATCH": ("16", "Rows the micro-batcher coalesces into one "
                           "dispatch (clamped to the top bucket)."),
    "MX_SERVE_MAX_DELAY_US": ("2000", "Microseconds the micro-batcher holds "
                              "an under-full batch open for more arrivals; "
                              "0 dispatches at once."),
    "MX_SERVE_QUEUE_CAP": ("256", "Admission-queue bound in rows; a submit "
                           "past it is refused with Overloaded."),
    "MX_SERVE_PORT": ("9700", "Port a serving replica binds."),
    "MX_SERVE_TIMEOUT": ("30", "Seconds a client waits for one reply, and "
                         "the server-side bound on a request waiting for its "
                         "batch."),
    "MX_SERVE_REPLAY_CAP": ("512", "Bound on the exactly-once replay cache "
                            "(one entry per client id, LRU over resolved "
                            "entries; values < 1 clamp to 1)."),
    "MX_PREFETCH": ("1", "Device input prefetch (io/prefetch.py "
                    "DevicePrefetcher) where a loop supports it: a "
                    "background thread stages the next batch in pinned "
                    "memory and copies it to the card on a side stream "
                    "while the current step computes.  0 keeps the copy "
                    "in the loop."),
    "MX_PREFETCH_DEPTH": ("2", "DevicePrefetcher queue bound in batches "
                          "(2 = double buffering); the producer blocks at "
                          "the bound.  Values < 1 clamp to 1."),
    "MX_RECORDIO_TOLERATE_CORRUPT": ("0", "1 = a corrupt or truncated .rec "
                                     "record is skipped and counted "
                                     "(reader.corrupt_skipped) and the "
                                     "read ends there, instead of raising "
                                     "OSError with the uri and byte "
                                     "offset."),
}


def get_env(name: str, default: Any = None, dtype: Callable = str) -> Any:
    """Read an environment knob, falling back to ``default`` and then to
    the catalog default; a value ``dtype`` cannot parse gives the
    default."""
    val = os.environ.get(name)
    if val is None:
        if default is None and name in ENV_CATALOG:
            default = ENV_CATALOG[name][0]
        if default is None:
            return None
        val = default
    try:
        if dtype is bool:
            return str(val).lower() in ("1", "true", "yes", "on")
        return dtype(val)
    except (TypeError, ValueError):
        return default


#: dtype names (the reference's, numpy's) -> torch dtypes
DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}

#: what the reference's arrays hold in place of a type that JAX without its
#: x64 mode does not keep: int64 data and int64 requests become int32.  Ops
#: that need int64 indices (gather, scatter, embedding ids, cross-entropy
#: targets) cast to int64 internally.
NARROWED = {torch.int64: torch.int32}


def torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a torch dtype, a numpy dtype or type, or a
    name ('float32', 'bfloat16', 'int32'), narrowed as the reference's
    arrays are (:data:`NARROWED`: 'int64' gives int32)."""
    if isinstance(dtype, torch.dtype):
        return NARROWED.get(dtype, dtype)
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in DTYPES:
        raise TypeError("unsupported dtype %r" % (dtype,))
    return torch_dtype(DTYPES[name])


def dtype_name(dtype: torch.dtype) -> str:
    """The reference's name of a torch dtype ('float32', 'bfloat16')."""
    return _NAMES[dtype]
