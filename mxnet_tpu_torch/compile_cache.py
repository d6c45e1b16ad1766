"""Persistent compile cache: the kernel libraries a warm process loads
instead of running ``nvcc``.

Counterpart of ``mxnet_tpu/compile_cache.py``.  The reference stores
serialized XLA executables.  A torch program has no executable to
serialize: its "compile" is its first dispatch (:mod:`.programs`).  What a
cold process pays and a warm one need not is the ``nvcc`` build of its
hand-written kernel libraries (``ops/_kernels.py``: the ``csrc/*.cu``
libraries of K1-K3, and the user bodies of :mod:`.tpu_kernel`), seconds
each.  So this store holds those shared libraries.

**When it is on.**  With ``MX_COMPILE_CACHE`` set, every library is
looked up here before ``nvcc`` runs, and a library built on a miss is
stored here.  The cache takes the place of ``mxnet_tpu_torch/_build/``
for that process: a library already in ``_build`` cannot hide a miss.
Empty (the default): the package builds into ``_build/`` as before.

**The key.**  ``sha256(name | signature | function fingerprint | spec |
envelope)``.  For a library the "signature" is the hash of its source and
of every header it may include, and the "spec" the ``nvcc`` flags.  The
envelope (:func:`envelope`) is torch's version, ``torch.version.cuda``,
``nvcc --version``, the device name, compute capability and count, Python
major.minor, a content hash of the port's ``.py``, ``.cu`` and ``.cuh``
sources, and ``MX_COMPILE_CACHE_SALT``.  It is stored inside each entry
and checked again on load.  It needs CUDA, so it is computed at the first
library load, never at import; ``nvcc --version`` runs once a process.

**An entry is one file**, published with a temporary name and
``os.replace`` (last write wins; a reader never sees a torn entry): the
schema, the envelope, the library's SHA-256 and its bytes.  On load the
bytes are verified, written to a path private to this process, and
opened with ``dlopen`` there, so a library cannot be read as a torn pair
of files and no other writer changes it under the loader.

**Every failure is a counted miss, then an ``nvcc`` build of the same
hand-written kernel**: absent (``misses{reason="absent"}``), envelope skew
(``"envelope"``), or corrupt (``"corrupt"``: bad schema, digest mismatch,
truncated, refused by ``dlopen``), which also counts an error and removes
the entry.  The cache can cost a read; it can never change which kernel
runs, and nothing falls back to a plain version.

Counters: ``compile_cache.hits``, ``.misses{reason}``, ``.errors``,
``.writes``, ``.bytes{direction}``, and the histogram
``compile_cache_deserialize_seconds`` (the load and verification of one
entry).  :func:`stats` has the reference's keys; ``xla_cache_hits`` and
``xla_cache_misses`` are None, for torch has no second (compiler-level)
layer.
"""
from __future__ import annotations

import atexit
import ctypes
import hashlib
import json
import logging
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, Optional, Tuple

from .base import get_env
from . import telemetry as _telemetry

__all__ = ["enabled", "cache_dir", "envelope", "cache_key",
           "signature_token", "function_fingerprint", "load", "store",
           "stats", "reset_stats", "entry_path", "SCHEMA", "activate",
           "library_events"]

logger = logging.getLogger(__name__)

#: bumped when the on-disk entry layout changes; a mismatch is a miss
SCHEMA = 1

_PKG = os.path.dirname(os.path.abspath(__file__))


def enabled() -> bool:
    """MX_COMPILE_CACHE non-empty: the persistent cache is on."""
    return bool(get_env("MX_COMPILE_CACHE", "") or "")


def cache_dir() -> str:
    return str(get_env("MX_COMPILE_CACHE", "") or "")


# ---------------------------------------------------------------------------
# This thread's library loads and builds (the registry's cache-hit rule)
# ---------------------------------------------------------------------------

_tls = threading.local()


def library_events() -> Tuple[int, int]:
    """(libraries this thread loaded from the cache, libraries this
    thread built with ``nvcc``) so far."""
    return getattr(_tls, "loaded", 0), getattr(_tls, "built", 0)


def note_library(loaded: bool) -> None:
    """Count one library that this thread loaded from the cache
    (``loaded``) or built."""
    if loaded:
        _tls.loaded = getattr(_tls, "loaded", 0) + 1
    else:
        _tls.built = getattr(_tls, "built", 0) + 1


# ---------------------------------------------------------------------------
# Key construction
# ---------------------------------------------------------------------------

_env_lock = threading.Lock()
_env_fixed: Optional[Dict[str, str]] = None


def _library_fingerprint() -> str:
    """Content hash over the port's ``.py``, ``.cu`` and ``.cuh`` sources:
    an edit of any of them invalidates every entry."""
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in os.walk(_PKG):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "_build"))
        for fname in sorted(filenames):
            if not fname.endswith((".py", ".cu", ".cuh")):
                continue
            path = os.path.join(dirpath, fname)
            h.update(os.path.relpath(path, _PKG).encode())
            try:
                with open(path, "rb") as f:
                    h.update(f.read())
            except OSError:
                h.update(b"?")
    return h.hexdigest()[:16]


def _nvcc_version() -> str:
    try:
        from .ops._kernels import nvcc_path
        out = subprocess.run([nvcc_path(), "--version"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[-1] if out.stdout else "?"
    except Exception:           # no nvcc: the key says so
        return "none"


def _fixed_envelope() -> Dict[str, str]:
    """The parts of the envelope that cannot change within a process,
    computed once (CUDA's context, ``nvcc --version``, the source hash)."""
    global _env_fixed
    with _env_lock:
        if _env_fixed is not None:
            return _env_fixed
    import torch
    name, cap, count = "none", "none", 0
    if torch.cuda.is_available():
        count = torch.cuda.device_count()
        name = torch.cuda.get_device_name(0)
        cap = "%d.%d" % torch.cuda.get_device_capability(0)
    fixed = {
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "nvcc": _nvcc_version(),
        "device_name": name,
        "capability": cap,
        "device_count": str(count),
        "python": "%d.%d" % sys.version_info[:2],
        "library": _library_fingerprint(),
    }
    with _env_lock:
        if _env_fixed is None:
            _env_fixed = fixed
        return _env_fixed


def envelope() -> Dict[str, str]:
    """The environment an entry is valid under; stored in every entry and
    checked on load (any difference is a miss)."""
    env = {"schema": str(SCHEMA)}
    env.update(_fixed_envelope())
    env["salt"] = str(get_env("MX_COMPILE_CACHE_SALT", "") or "")
    return env


def _leaf_token(sig) -> str:
    """One registry leaf signature as stable text (a tensor's shape,
    dtype and device; anything else by its repr)."""
    if isinstance(sig, tuple) and sig and sig[0] == "tensor":
        return "tensor:%s:%s:%s" % (tuple(int(d) for d in sig[1]),
                                    str(sig[2]).replace("torch.", ""),
                                    sig[3])
    return repr(sig)


def signature_token(sig) -> str:
    """Canonical text of a :func:`.programs.signature_of` value, or of a
    plain string or bytes signature (a library's source hash)."""
    if isinstance(sig, (str, bytes)):
        return sig if isinstance(sig, str) else sig.hex()
    treedef, leaf_sigs = sig
    return "%s|%s" % (str(treedef),
                      ";".join(_leaf_token(s) for s in leaf_sigs))


_ADDR_RE = None


def _stable_repr(obj) -> str:
    """repr() with memory addresses stripped, so that it hashes alike
    across processes."""
    global _ADDR_RE
    if _ADDR_RE is None:
        import re
        _ADDR_RE = re.compile(r" at 0x[0-9a-fA-F]+")
    return _ADDR_RE.sub("", repr(obj))


_FP_MAX_DEPTH = 8


def function_fingerprint(fn) -> str:
    """Recursive hash of a callable's code objects (bytecode, nested code
    constants, names) and of the host values it closes over (closure
    cells, defaults, ``functools.partial`` bindings), memory addresses
    stripped and frozensets in sorted order: the reference's algorithm,
    so the same plain function hashes alike in both packages."""
    import functools as _ft
    h = hashlib.sha256()
    seen = set()

    def const_token(c) -> str:
        if hasattr(c, "co_code"):
            walk(c)
            return "<code>"
        if isinstance(c, (frozenset, set)):
            return "fs{%s}" % ",".join(sorted(const_token(x) for x in c))
        if isinstance(c, tuple):
            return "(%s)" % ",".join(const_token(x) for x in c)
        return _stable_repr(c)

    def walk(code):
        if id(code) in seen:
            return
        seen.add(id(code))
        h.update(code.co_code)
        h.update(",".join(code.co_names).encode())
        h.update(",".join(code.co_varnames).encode())
        for const in code.co_consts:
            h.update(const_token(const).encode())

    def feed_value(v, depth):
        if depth > _FP_MAX_DEPTH:
            h.update(b"<depth>")
            return
        if callable(v) and (hasattr(v, "__code__")
                            or isinstance(v, _ft.partial)):
            feed(v, depth)
        elif isinstance(v, (list, tuple)):
            h.update(b"seq%d" % len(v))
            for x in v:
                feed_value(x, depth + 1)
        elif isinstance(v, dict):
            for k in sorted(v, key=repr):
                h.update(_stable_repr(k).encode())
                feed_value(v[k], depth + 1)
        else:
            try:
                h.update(_stable_repr(v)[:2000].encode())
            except Exception:
                h.update(type(v).__name__.encode())

    def feed(obj, depth=0):
        if id(obj) in seen or depth > _FP_MAX_DEPTH:
            return
        seen.add(id(obj))
        if isinstance(obj, _ft.partial):
            feed(obj.func, depth + 1)
            feed_value(tuple(obj.args), depth + 1)
            for k in sorted(obj.keywords or {}):
                h.update(k.encode())
                feed_value(obj.keywords[k], depth + 1)
            return
        obj = getattr(obj, "__wrapped__", obj)
        code = getattr(obj, "__code__", None)
        if code is None:
            h.update(_stable_repr(obj).encode())
            return
        walk(code)
        for d in (getattr(obj, "__defaults__", None) or ()):
            feed_value(d, depth + 1)
        for k in sorted(getattr(obj, "__kwdefaults__", None) or {}):
            h.update(k.encode())
            feed_value(obj.__kwdefaults__[k], depth + 1)
        cells = getattr(obj, "__closure__", None) or ()
        for name, cell in zip(code.co_freevars, cells):
            h.update(name.encode())
            try:
                feed_value(cell.cell_contents, depth + 1)
            except ValueError:        # an empty cell
                h.update(b"<empty>")

    feed(fn)
    return h.hexdigest()[:16]


def cache_key(name: str, sig=None, fn=None,
              jit_kw: Optional[Dict[str, Any]] = None,
              env: Optional[Dict[str, str]] = None) -> str:
    """An entry's identity (sha256 hex).  A library passes its source and
    header hash as ``sig`` and its ``nvcc`` flags in ``jit_kw``; ``env``
    defaults to :func:`envelope`."""
    h = hashlib.sha256()
    h.update(name.encode())
    h.update(b"\0")
    if sig is not None:
        h.update(signature_token(sig).encode())
    h.update(b"\0")
    if fn is not None:
        h.update(function_fingerprint(fn).encode())
    h.update(b"\0")
    kw = jit_kw or {}
    h.update(json.dumps({k: repr(v) for k, v in sorted(kw.items())},
                        sort_keys=True).encode())
    h.update(b"\0")
    h.update(json.dumps(envelope() if env is None else env,
                        sort_keys=True).encode())
    return h.hexdigest()


def entry_path(key: str) -> str:
    return os.path.join(cache_dir(), key[:2], key + ".so-entry")


# ---------------------------------------------------------------------------
# Telemetry
# ---------------------------------------------------------------------------

def _counter(name, doc, **labels):
    return _telemetry.registry.counter(name, doc=doc,
                                       labels=labels or None)


def _c_hits():
    return _counter("compile_cache.hits",
                    "kernel libraries loaded from the persistent compile "
                    "cache (no nvcc run)")


def _c_misses(reason: str):
    return _counter("compile_cache.misses",
                    "persistent-cache lookups that went on to an nvcc "
                    "build, by reason", reason=reason)


def _c_errors():
    return _counter("compile_cache.errors",
                    "persistent-cache failures (a corrupt entry, an I/O "
                    "error), each followed by an nvcc build")


def _c_writes():
    return _counter("compile_cache.writes",
                    "kernel libraries written into the persistent cache")


def _c_bytes(direction: str):
    return _counter("compile_cache.bytes",
                    "persistent-cache payload bytes moved",
                    direction=direction)


def _h_deser():
    return _telemetry.registry.histogram(
        "compile_cache_deserialize_seconds",
        doc="seconds to read, verify and dlopen one cached library")


def stats() -> Dict[str, Any]:
    """Roll-up for the serve banner and METRICS (the reference's keys)."""
    reg = _telemetry.registry
    reasons = {}
    for inst in reg.instruments():
        if inst.name == "compile_cache.misses":
            reasons[inst.labels.get("reason", "?")] = inst.value
    return {
        "enabled": enabled(),
        "dir": cache_dir() or None,
        "hits": reg.value("compile_cache.hits"),
        "misses": sum(reasons.values()),
        "miss_reasons": reasons,
        "errors": reg.value("compile_cache.errors"),
        "writes": reg.value("compile_cache.writes"),
        # torch has no compiler-level cache under the library store
        "xla_cache_hits": None,
        "xla_cache_misses": None,
    }


def reset_stats() -> None:
    """Zero the cache counters (tests; the instruments persist)."""
    for inst in list(_telemetry.registry.instruments()):
        if inst.name.startswith("compile_cache") and \
                isinstance(inst, _telemetry.Counter):
            inst.set(0)


_activate_lock = threading.Lock()
_activated = False


def activate() -> bool:
    """Arm the cache for this process (idempotent; called by
    ``programs.register_program``): makes the directory and the counters.
    There is no second layer to arm."""
    global _activated
    if not enabled():
        return False
    with _activate_lock:
        if _activated:
            return True
        _activated = True
    # the counters exist from here on, so a replica's METRICS carries them
    # before its first lookup
    _c_hits(), _c_errors(), _c_writes()
    try:
        os.makedirs(cache_dir(), exist_ok=True)
    except OSError as e:
        logger.warning("compile_cache: cannot make %s (%s); every lookup "
                       "will miss", cache_dir(), e)
    return True


# ---------------------------------------------------------------------------
# This process's private directory
# ---------------------------------------------------------------------------

_private_lock = threading.Lock()
_private: Optional[str] = None


def private_dir() -> str:
    """A directory of this process (removed at exit): verified libraries
    are opened from here, and builds land here before they are stored."""
    global _private
    with _private_lock:
        if _private is None:
            _private = tempfile.mkdtemp(prefix="mx-compile-cache-")
            atexit.register(shutil.rmtree, _private, True)
        return _private


# ---------------------------------------------------------------------------
# Load / store
# ---------------------------------------------------------------------------

def load(name: str, key: str) -> Optional[str]:
    """The path of this process's verified, ``dlopen``-able copy of the
    library stored under ``key``, or None.  Every failure is a counted
    miss (a corrupt entry also an error, and it is removed); this never
    raises."""
    if not enabled():
        return None
    path = entry_path(key)
    t0 = time.perf_counter()
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        _c_misses("absent").inc()
        return None
    try:
        entry = pickle.loads(blob)
        if not isinstance(entry, dict) or entry.get("schema") != SCHEMA:
            raise ValueError("bad schema %r" % (
                entry.get("schema") if isinstance(entry, dict)
                else type(entry)))
        if entry.get("envelope") != envelope():
            _c_misses("envelope").inc()
            logger.info("compile_cache: envelope skew for %r (%s); "
                        "building", name, path)
            return None
        payload = entry["payload"]
        digest = hashlib.sha256(payload).hexdigest()
        if digest != entry.get("sha256"):
            raise ValueError("digest mismatch")
        # named by the bytes too: dlopen returns a path's first library
        # again, so other bytes must come from another path
        local = os.path.join(private_dir(), "%s-%s-%s.so"
                             % (name, key[:16], digest[:16]))
        tmp = "%s.tmp-%d" % (local, threading.get_ident())
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, local)
        ctypes.CDLL(local)                  # refused by dlopen: corrupt
    except Exception as e:
        _c_misses("corrupt").inc()
        _c_errors().inc()
        logger.warning("compile_cache: unreadable entry for %r (%s: %s); "
                       "building", name, type(e).__name__, e)
        try:
            os.remove(path)
        except OSError:
            pass
        return None
    dt = time.perf_counter() - t0
    _c_hits().inc()
    _c_bytes("read").inc(len(blob))
    _h_deser().observe(dt)
    logger.info("compile_cache: loaded %r in %.1f ms (%d bytes)", name,
                dt * 1e3, len(blob))
    return local


def store(name: str, key: str, library_path: str) -> bool:
    """Store the library at ``library_path`` under ``key`` (temporary
    file, then ``os.replace``).  Returns False (counted, never raises)
    when the write fails."""
    if not enabled():
        return False
    try:
        with open(library_path, "rb") as f:
            payload = f.read()
        blob = pickle.dumps({
            "schema": SCHEMA, "name": name, "envelope": envelope(),
            "created": time.time(),
            "sha256": hashlib.sha256(payload).hexdigest(),
            "payload": payload}, protocol=pickle.HIGHEST_PROTOCOL)
    except OSError as e:
        _c_errors().inc()
        logger.warning("compile_cache: cannot read %s (%s)",
                       library_path, e)
        return False
    path = entry_path(key)
    tmp = "%s.tmp-%d-%d" % (path, os.getpid(), threading.get_ident())
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)       # last write wins; never torn
    except OSError as e:
        _c_errors().inc()
        logger.warning("compile_cache: write failed for %r (%s)", name, e)
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False
    _c_writes().inc()
    _c_bytes("written").inc(len(blob))
    return True
