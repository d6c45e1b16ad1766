"""The host-side native components (RecordIO, JPEG decode), built on demand.

Counterpart of ``mxnet_tpu/_native/__init__.py``.  The C++ sources are the
repo root's ``src/<name>.cc`` (a plain ``extern "C"`` interface, no
framework code), shared with the reference and never edited here.
:func:`load` compiles one with ``g++`` into ``mxnet_tpu_torch/_build/``
(git-ignored), named by a hash of the source and the flags, and returns
its ``ctypes.CDLL``.  A build goes to a temporary name and is renamed into
place, so processes that build at once (spawned ``DataLoader`` workers)
never load a half-written library.  Raises ``OSError`` when the source is
missing or the build fails; callers then take their pure-Python path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["load"]

_PKG = Path(__file__).resolve().parent
SRC = _PKG.parent / "src"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]
#: each component's system libraries
LINK_FLAGS = {"imdecode": ["-ljpeg"]}

_lock = threading.Lock()
_cache = {}


def _build(name: str) -> Path:
    src = SRC / (name + ".cc")
    if not src.is_file():
        raise OSError("native source %s is missing" % src)
    flags = CXX_FLAGS + LINK_FLAGS.get(name, [])
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    out = BUILD_DIR / ("lib%s-%s.so" % (name, digest.hexdigest()[:16]))
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
    cmd = ["g++"] + CXX_FLAGS + [str(src), "-o", str(tmp)] + \
        LINK_FLAGS.get(name, [])
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise OSError("native build of %s: no g++ (%s)" % (name, e)) from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise OSError("native build failed for %s:\n%s"
                      % (name, proc.stderr))
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``src/<name>.cc``, built at first use."""
    with _lock:
        if name not in _cache:
            _cache[name] = ctypes.CDLL(str(_build(name)))
        return _cache[name]
