"""Errors and environment knobs of the PyTorch port.

Counterpart of ``mxnet_tpu/base.py``: :class:`MXNetError`,
:func:`get_env` with the process-local overrides of :func:`set_env` and
:class:`environment`, and the catalog limited to the knobs the port reads.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

__all__ = ["MXNetError", "ENV_CATALOG", "get_env", "set_env",
           "environment", "DTYPES", "NARROWED",
           "torch_dtype", "dtype_name", "string_types", "numeric_types",
           "integer_types"]


class MXNetError(RuntimeError):
    """Default error type raised by the framework."""


string_types = (str,)
numeric_types = (float, int)
integer_types = (int,)


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
    "MX_SERVE_DECODE_SLOTS": ("8", "Decode engine (serve/decode.py): "
                              "concurrent generation slots in the KV-cache "
                              "pool, allocated once on the device and "
                              "updated in place by every dispatch; decode "
                              "steps bucket by active-slot count (powers "
                              "of two up to this)."),
    "MX_SERVE_DECODE_MAX_TOKENS": ("32", "Decode engine: cap on generated "
                                   "tokens per GENERATE request (a "
                                   "request's max_tokens clamps to it)."),
    "MX_SERVE_DECODE_PAGE": ("16", "Decode engine: KV page size in token "
                             "positions; each slot's extent (top prompt "
                             "bucket + max tokens + the overrun margin) "
                             "rounds up to whole pages."),
    "MX_SERVE_DECODE_PROMPT_BUCKETS": ("4,8,16", "Decode engine: "
                                       "comma-separated prompt-length "
                                       "buckets; a prompt pads to the "
                                       "smallest covering one, a longer "
                                       "prompt is refused at admission."),
    "MX_SERVE_KV_PAGES": ("0", "Paged decode engine: physical pages in the "
                          "shared KV page heap; 0 sizes it to (slots + 1) "
                          "x pages per slot, the flat pool's bytes."),
    "MX_SERVE_KV_PAGE_LEN": ("0", "Paged decode engine: token positions "
                             "per physical page; 0 takes "
                             "MX_SERVE_DECODE_PAGE."),
    "MX_SERVE_PREFIX_SHARE": ("1", "Paged decode engine: 1 shares full "
                              "prompt pages across sessions by a chained "
                              "content hash (copy-on-write at a "
                              "divergence); 0 disables sharing."),
    "MX_SERVE_PREFILL_CHUNK": ("0", "Paged decode engine: prefill chunk "
                               "length in positions (rounded up to whole "
                               "pages; 0 = one page); chunks interleave "
                               "with decode steps."),
    "MX_SERVE_SPEC_K": ("4", "Speculative decoding: tokens the draft "
                        "proposes per window (1..8); one verify dispatch "
                        "commits 1..spec_k of them."),
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
    # -- the compiled step and its sharded lane --------------------------------
    "MX_STEP_COMPILE": ("0", "1 = the whole-step lane: "
                        "Trainer.make_compiled_step's CompiledStep runs "
                        "loss forward, backward, the bucketed (int8 "
                        "error-feedback quantized) gradient exchange and "
                        "the fused multi-tensor optimizer apply as one "
                        "call a step (mxnet_tpu_torch/step.py).  Each call "
                        "runs eagerly for now; the PS/dist_async transport, "
                        "optimizers without a fused form, grad_req='add' "
                        "and row-sparse gradients fall back to the eager "
                        "pipeline.  Nothing in the port reads it yet: its "
                        "reader, Module.fit, is not ported, so build the "
                        "step with Trainer.make_compiled_step."),
    "MX_STEP_SCAN": ("0", "N>1 = window size for the compiled step lane's "
                     "window consumers (step.scan_window(), "
                     "CompiledStep.run_window): N micro-batches a call, "
                     "gradient accumulation folded in through "
                     "run_window(accum=k).  0/1 = one step a call.  "
                     "Nothing in the port reads it yet: its reader, "
                     "Module.fit, is not ported, so pass the window to "
                     "run_window."),
    "MX_MESH_AXES": ("", "Named mesh axes for the SpecLayout sharded "
                     "training lane (mxnet_tpu_torch/parallel/"
                     "speclayout.py), as comma-separated name[=size] "
                     "tokens, e.g. 'data,fsdp=2' or 'data,fsdp=2,tp=2'.  "
                     "When set, CompiledStep/Trainer.make_compiled_step "
                     "run the step over this mesh of ranks: the batch "
                     "splits over data*fsdp, parameters + optimizer state "
                     "live sheet-sharded (fsdp) / tensor-split (tp), so "
                     "per-rank state bytes drop ~linearly with the fsdp "
                     "axis, and gradients reduce-scatter onto the "
                     "parameter shards (int8-quantized per bucket under "
                     "gradient compression, error-feedback residuals "
                     "sharded per rank).  An unsized data axis infers -1 "
                     "(all remaining ranks); unsized model axes default "
                     "to 2.  Empty keeps the replicated step.  Sharding "
                     "never changes results - only placement and "
                     "communication."),
    # -- the serving tier: programs, packer, drain, router, fleet ---------
    "MX_PROGRAM_CENSUS": ("1", "Program registry and buffer census "
                          "(programs.py): 1 (default) routes the bucket, "
                          "decode and step programs through the registry "
                          "(program_compile_seconds, program_temp_bytes, "
                          "program_retraces with the retrace explainer's "
                          "diff) and lets owners register their tensors "
                          "for buffer_census(); 0 makes register_program "
                          "return the plain callable."),
    "MX_LEAK_WARN_BYTES": ("67108864", "Buffer-census leak detector "
                           "threshold: when the census total grows over "
                           "consecutive checks by more than this many "
                           "bytes, census_leak_bytes latches the streak, "
                           "census.leak_trips increments and a warning "
                           "names the growing owners.  A shrink resets "
                           "the streak; 0 disables the trip."),
    "MX_SERVE_HBM_BUDGET": ("0", "Device byte budget one serving replica "
                            "may spend across its co-hosted models "
                            "(servables and decode engines' models).  "
                            "ModelHost.deploy measures a candidate after "
                            "its warm (live bytes plus the largest temp "
                            "bytes of its registered programs) and refuses "
                            "it with BudgetExceeded, answered in-band as "
                            "'(False, \"budget: ...\")', when hosted + "
                            "new would pass the budget.  0 disables the "
                            "packer."),
    "MX_SERVE_DRAIN_TIMEOUT": ("30", "Default deadline in seconds of a "
                               "replica's DRAIN: admission closes at once "
                               "(fresh PREDICT/GENERATE answered "
                               "'draining: ...'), in-flight work finishes, "
                               "the serve loop exits; past the deadline "
                               "the stragglers' connections are severed "
                               "with no reply so their clients fail over. "
                               " A repeated DRAIN keeps the first "
                               "deadline."),
    "MX_SERVE_ROOTS": ("", "Comma-separated replica (or router) addresses "
                       "host:port a ServeClient connects to when given "
                       "none; it sticks to one and fails over to the "
                       "next on a connection error or timeout."),
    "MX_SERVE_DRAFT": ("0", "Speculative decoding for 'python -m "
                       "mxnet_tpu_torch.serve --decode': layers of the "
                       "built-in draft model (the demo LM's first N, "
                       "demo_spec_pair); > 0 selects the speculative "
                       "engine and needs MX_SERVE_KV_PAGES > 0."),
    "MX_COORDINATOR": ("", "host:port of rank 0 for the process group "
                       "(parallel.init_process_group; set by "
                       "tools/launch.py)."),
    "MX_NUM_PROCESSES": ("", "Process-group size (launcher-set)."),
    "MX_PROCESS_ID": ("", "This process's rank (launcher-set); a replica "
                      "started with --port-base binds port-base + it."),
    "MX_ROUTER_PORT": ("9800", "Port the serving router binds (python -m "
                       "mxnet_tpu_torch.serve.router) when --port is not "
                       "given."),
    "MX_ROUTER_REPLICAS": ("", "Comma-separated static replica addresses "
                           "host:port the router starts with.  New members "
                           "join 'up'; a failed forward marks one 'dead' "
                           "and a connect probe each refresh tick revives "
                           "it."),
    "MX_ROUTER_REPLICAS_FILE": ("", "Replica-list file (one host:port a "
                                "line, '#' comments) the router re-reads "
                                "every refresh tick: an address that "
                                "appears joins 'up', one that disappears "
                                "goes 'draining' until dead, then is "
                                "forgotten."),
    "MX_ROUTER_REFRESH": ("1.0", "Seconds between router refresh ticks: "
                          "the replicas file, dead-replica probes and the "
                          "FLEET pull of load signals."),
    "MX_ROUTER_FLEET": ("", "Fleet collector address host:port the router "
                        "pulls merged load signals from "
                        "(fleet.replica_signals).  Empty: no signals, "
                        "round-robin over 'up' replicas."),
    "MX_ROUTER_PIN_CAP": ("4096", "Bound on the router's session-pin LRU "
                          "(client id -> replica).  An evicted pin costs "
                          "locality on the session's next request, never "
                          "correctness.  Values < 1 clamp to 1."),
    "MX_ROUTER_DRAIN_TIMEOUT": ("30", "Default deadline in seconds of the "
                                "router's own DRAIN: new sessions refused "
                                "'draining: ...', pinned sessions keep "
                                "flowing, the router exits once idle and "
                                "severs stragglers past the deadline."),
    "MX_FLEET_INTERVAL": ("2.0", "Fleet collector (fleet.py): seconds "
                          "between scrape rounds over its members (serve "
                          "replicas over METRICS, workers through their "
                          "heartbeat files).  A member whose scrape fails "
                          "is marked absent that round."),
    "MX_FLEET_RING": ("120", "Fleet collector: bounded ring of merged "
                      "snapshots, one a scrape round."),
    "MX_FLEET_WINDOW": ("5", "Fleet detectors: window in scrape rounds for "
                        "straggler medians and SLO burn."),
    "MX_FLEET_STRAGGLER_FACTOR": ("2.0", "Straggler detector: a worker "
                                  "whose windowed step time passes this "
                                  "multiple of the fleet's lower median "
                                  "is flagged with its dominant phase."),
    "MX_FLEET_STALE": ("", "Fleet collector: seconds a heartbeat-scraped "
                       "member's beat may age before it is absent.  "
                       "Empty: max(2 x MX_FLEET_INTERVAL, 30 s)."),
    "MX_FLEET_SLO_P50_MS": ("", "Serving SLO target: the fleet-merged "
                            "rolling p50 of MX_FLEET_SLO_PHASES in ms; "
                            "fleet.slo_burn{slo=p50_latency} publishes "
                            "observed/target and a burn > 1 latches a "
                            "breach.  Empty disables."),
    "MX_FLEET_SLO_P99_MS": ("", "Serving SLO target: the fleet-merged "
                            "rolling p99 in ms (as MX_FLEET_SLO_P50_MS).  "
                            "Empty disables."),
    "MX_FLEET_SLO_REJECT_RATE": ("", "Serving SLO target: windowed "
                                 "rejection rate rejected / (requests + "
                                 "rejected).  Empty disables."),
    "MX_FLEET_SLO_QUEUE": ("", "Serving SLO target: mean fleet queue depth "
                           "in rows (serve.queue_rows).  Empty disables."),
    "MX_FLEET_SLO_PHASES": ("queue_wait,serve_dispatch", "Comma-separated "
                            "step_phase_seconds phases whose merged "
                            "histograms make the serving latency the SLO "
                            "trackers read."),
    "MX_FLEET_PORT": ("", "Port of the fleet collector's wire server "
                      "(FLEET: the merged snapshot; METRICS: the "
                      "federation exposition).  Empty: none."),
    "MX_COMPILE_CACHE": ("", "Persistent compile cache directory "
                         "(compile_cache.py): every kernel library "
                         "(ops/_kernels.py, tpu_kernel bodies) is looked "
                         "up there, keyed by name, source and header "
                         "hash, nvcc flags and the environment envelope, "
                         "before nvcc runs, and a library built on a miss "
                         "is stored there; _build/ is not read then.  A "
                         "miss, envelope skew or corrupt entry is counted "
                         "(compile_cache.misses{reason}) and builds the "
                         "same kernel with nvcc.  Writes are temp + "
                         "rename; concurrent writers: last write wins.  "
                         "Empty disables it."),
    "MX_COMPILE_CACHE_SALT": ("", "Extra compile-cache key component: set it "
                              "to partition one shared cache directory "
                              "without deleting entries; changing it is a "
                              "full-miss restart."),
    "MX_AUTOSCALE_UP_BURN": ("1.0", "Autoscaler (tools/launch.py --autoscale "
                             "MIN:MAX): scale up when any fleet SLO burn "
                             "(observed/target, from the merged snapshot) "
                             "is at or above this for MX_AUTOSCALE_HOLD "
                             "consecutive scrape rounds: one replica is "
                             "spawned and added to the router's replicas "
                             "file and the collector."),
    "MX_AUTOSCALE_DOWN_BURN": ("0.5", "Autoscaler: retire one replica (the "
                               "newest, by DRAIN) when every burn is at or "
                               "below this for MX_AUTOSCALE_HOLD rounds.  "
                               "The band between DOWN and UP holds "
                               "steady."),
    "MX_AUTOSCALE_HOLD": ("3", "Autoscaler: consecutive scrape rounds a burn "
                          "signal must hold before an action (both "
                          "directions)."),
    "MX_AUTOSCALE_COOLDOWN": ("10", "Autoscaler: base seconds of the cooldown "
                              "after an action: a fault.RetryPolicy backoff "
                              "(base x 2^consecutive same-direction "
                              "actions, jittered, at most 8x)."),
    "MX_FLEET_HTTP_PORT": ("", "Port of the collector's Prometheus "
                           "federation HTTP endpoint (GET /metrics, GET "
                           "/fleet.json).  Empty: none."),
    "MX_FSDP": ("", "Size of the fsdp (ZeRO sheet-sharding) mesh axis for "
                "the SpecLayout lane.  Overrides the fsdp entry of "
                "MX_MESH_AXES; setting MX_FSDP=N alone implies "
                "MX_MESH_AXES='data,fsdp=N'.  Per-rank params + "
                "optimizer-state bytes drop ~1/N.  Empty/1 = no fsdp "
                "sharding."),
}


_env_overrides: Dict[str, str] = {}
_env_lock = threading.Lock()


def get_env(name: str, default: Any = None, dtype: Callable = str) -> Any:
    """Read an environment knob (a :func:`set_env` override first, then
    ``os.environ``), falling back to ``default`` and then to the catalog
    default; a value ``dtype`` cannot parse gives the default."""
    with _env_lock:
        val = _env_overrides.get(name)
        if val is None:
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


def set_env(name: str, value: Optional[str]) -> None:
    """Set (or with None, unset) a process-local override of knob
    ``name``, kept in step with ``os.environ``.  Unsetting removes the
    override, so a later direct ``os.environ`` write is read again."""
    with _env_lock:
        if value is None:
            _env_overrides.pop(name, None)
            os.environ.pop(name, None)
        else:
            _env_overrides[name] = str(value)
            os.environ[name] = str(value)


class environment:
    """A scope of knob overrides: ``environment(name, value)`` or
    ``environment({name: value, ...})``; a value of None unsets the knob
    inside the scope, and leaving the scope restores what was there."""

    def __init__(self, *args):
        if len(args) == 1 and isinstance(args[0], dict):
            self._kwargs = dict(args[0])
        elif len(args) == 2:
            self._kwargs = {args[0]: args[1]}
        else:
            raise ValueError("environment() takes (name, value) or a dict")
        self._saved: Dict[str, Optional[str]] = {}

    def __enter__(self):
        for k, v in self._kwargs.items():
            self._saved[k] = os.environ.get(k)
            set_env(k, v)
        return self

    def __exit__(self, *exc):
        for k, v in self._saved.items():
            set_env(k, v)
        return False


#: dtype names (the reference's, numpy's) -> torch dtypes
DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
    "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
}
_NAMES = {v: k for k, v in DTYPES.items()}

#: what the reference's arrays hold in place of a type that JAX without its
#: x64 mode does not keep: int64 data and int64 requests become int32, and
#: uint64 ones uint32.  Ops that need int64 indices (gather, scatter,
#: embedding ids, cross-entropy targets) cast to int64 internally.
NARROWED = {torch.int64: torch.int32, torch.uint64: torch.uint32}


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
