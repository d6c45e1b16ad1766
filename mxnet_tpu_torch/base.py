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
    # -- the engine, the profiler and telemetry ------------------------------
    "MXNET_ENGINE_TYPE": ("ThreadedEnginePerDevice", "'NaiveEngine' "
                          "synchronises the device after every eager op "
                          "(for bisecting asynchronous faults); any other "
                          "value keeps CUDA's asynchronous launches."),
    "MXNET_PROFILER_SYNC": ("0", "1 = the profiler waits for each "
                            "annotated range's device work before stamping "
                            "its duration."),
    "MX_TELEMETRY": ("1", "Runtime telemetry (telemetry.py): 1 records "
                     "per-phase step histograms and a flight-recorder step "
                     "record a training step; 0 turns both off.  The "
                     "engine's counters count regardless."),
    "MX_TELEMETRY_TRACE": ("", "Directory for per-process trace files: "
                           "every span is buffered and written to "
                           "<dir>/trace-<role>-r<rank>-p<pid>.trace.json "
                           "at exit.  Empty turns span buffering off."),
    "MX_TELEMETRY_RING": ("256", "Flight-recorder capacity in step "
                          "records."),
    "MX_CRASH_DIR": ("", "Crash-dump directory for the flight recorder's "
                     "ring and a counters snapshot.  Empty turns crash "
                     "dumps off."),
    # -- fault tolerance -----------------------------------------------------
    "MX_FAULT_INJECT": ("", "Fault-injection spec "
                        "'site:action[:k=v,...];...' armed at import "
                        "(launcher --fault); see fault.py."),
    "MX_NAN_POLICY": ("", "Training-loop gradient guard (health.py): "
                      "'warn' logs non-finite gradients, 'skip_batch' also "
                      "drops the poisoned update so the parameters stay "
                      "finite, 'raise' fails the rank fast for the "
                      "supervisor to restart; empty turns it off."),
    "MX_STEP_TIMEOUT": ("", "Seconds a training step may stall before the "
                        "watchdog thread dumps every thread's stack to "
                        "stderr and exits the process with code 86, so "
                        "the launcher's --restart on-failure restarts the "
                        "rank from its last checkpoint; empty turns it "
                        "off."),
    "MX_HEARTBEAT_FILE": ("", "Per-rank liveness file the training loop "
                          "atomically rewrites every batch; the launcher's "
                          "--hang-timeout sets it for each worker and reads "
                          "its mtime to tell a slow rank (fresh file) from "
                          "a wedged one (stale file: killed and "
                          "restarted)."),
    "MX_KVSTORE_RETRY_DEADLINE": ("60", "dist_async client: seconds to "
                                  "keep retrying a failed RPC (reconnect "
                                  "and replay) before the terminal "
                                  "MXNetError; also bounds the first "
                                  "connect to each server."),
    "MX_KVSTORE_RETRY_BASE": ("0.05", "dist_async client: first backoff "
                              "delay in seconds; doubles an attempt."),
    "MX_KVSTORE_RETRY_MAX": ("2.0", "dist_async client: backoff delay cap "
                             "in seconds."),
    "MX_KVSTORE_RETRY_JITTER": ("0.2", "dist_async client: uniform jitter "
                                "fraction added to each backoff delay."),
    "MX_KVSTORE_RECV_TIMEOUT": ("", "Seconds a kvstore recv_msg may block "
                                "mid-message before TimeoutError (empty: "
                                "no bound; the dist_async client uses 30)."),
    "MX_KVSTORE_BARRIER_TIMEOUT": ("120", "Seconds a kvstore server BARRIER "
                                   "waits for stragglers."),
    "MX_KVSTORE_HEARTBEAT": ("5", "dist_async client: seconds between "
                             "background PINGs to each server (0 turns "
                             "them off)."),
    "MX_KVSTORE_STALE_TIMEOUT": ("30", "kvstore server: a worker silent "
                                 "this long is left out of barrier "
                                 "accounting."),
    # -- the parameter server ------------------------------------------------
    "MX_PS_ROOT": ("", "dist_async parameter-server address host:port (one "
                   "server)."),
    "MX_PS_ROOTS": ("", "Comma-separated parameter-server addresses; keys "
                    "shard across them by hash (launcher -s N)."),
    "MX_PS_PORT": ("9600", "Port a kvstore server process binds."),
    "MX_PS_SNAPSHOT": ("", "Path where a kvstore server keeps its store "
                       "(an atomically replaced pickle) after mutations and "
                       "on STOP; a server restarted with it resumes."),
    "MX_PS_SNAPSHOT_EVERY": ("1", "Snapshot the server's store every N "
                             "mutating requests."),
    "MXNET_KVSTORE_BIGARRAY_BOUND": ("1000000", "dist_async: a value of at "
                                     "least this many entries is split "
                                     "evenly across all servers."),
    "MX_ELASTIC": ("0", "1 = a dist_async worker JOINs the servers' "
                   "membership table at store init."),
    "MX_ELASTIC_EPOCH": ("0", "The membership epoch a worker plans its "
                         "fusion buckets under (the bucket-name salt); 0 "
                         "keeps the unsalted names."),
    "MX_ELASTIC_EVICT_AFTER": ("", "kvstore server: a member silent this "
                               "many seconds leaves the membership table "
                               "(an epoch bump).  Empty/0: never."),
    "MX_EXCHANGE_HIERARCHICAL": ("0", "1 = the dist_async pull leg comes "
                                 "back int8 (PULLQ), each bucket's pull on "
                                 "its own connection as it is ready."),
    "MX_EXCHANGE_PARALLEL": ("4", "Concurrent bucket pulls a worker under "
                             "MX_EXCHANGE_HIERARCHICAL."),
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
