"""Errors and environment knobs of the PyTorch port.

Counterpart of ``mxnet_tpu/base.py``: :class:`MXNetError` and
:func:`get_env`, with the catalog limited to the knobs the port reads.
"""
from __future__ import annotations

import os
from typing import Any, Callable

__all__ = ["MXNetError", "ENV_CATALOG", "get_env"]


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
