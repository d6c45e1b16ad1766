"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface and loaded with :mod:`ctypes`.
The build happens at first use, never at import: a machine without ``nvcc``
or a card imports this module freely.  Libraries land in
``mxnet_tpu_torch/_build/`` (git-ignored), named by a hash of their source so
an edited source never loads a stale library.  :func:`build_all` builds and
loads every library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from ..base import MXNetError

__all__ = ["KernelLibrary", "FLASH_FWD", "build_all", "nvcc_path"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_float = ctypes.c_float


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``; raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise MXNetError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                     "/usr/local/cuda/bin); the CUDA kernels cannot be built")


class KernelLibrary:
    """One ``csrc/<name>.cu`` source, its shared library and its C entry
    points.  ``signatures`` maps each exported function to
    ``(argtypes, restype)``."""

    def __init__(self, name: str, signatures: Dict[str, tuple]):
        self.name = name
        self.source = CSRC / (name + ".cu")
        self._signatures = signatures
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        #: seconds the last build took, and nvcc's -Xptxas -v report
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        #: launches of this library's kernel, counted by its wrapper
        self.launches = 0
        self._count_lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes()
                              + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / ("lib%s-%s.so" % (self.name, digest[:12]))

    def _build(self) -> None:
        """Run ``nvcc`` into a temporary file and move it into place."""
        out = self.library_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(out.name + ".%d.tmp" % os.getpid())
        cmd = [nvcc_path()] + NVCC_FLAGS + ["-o", str(tmp), str(self.source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        self.build_log = proc.stdout
        if proc.returncode != 0:
            raise MXNetError("nvcc failed for %s (exit %d):\n%s"
                             % (self.source, proc.returncode, proc.stdout))
        os.replace(tmp, out)
        self.build_seconds = time.perf_counter() - t0

    def _bind(self) -> ctypes.CDLL:
        lib = ctypes.CDLL(str(self.library_path()))
        for fn, (argtypes, restype) in self._signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        return lib

    def load(self) -> ctypes.CDLL:
        """The loaded library, building it first if needed."""
        with self._lock:
            if self._lib is None:
                if self.library_path().exists():
                    self.build_seconds = 0.0
                else:
                    self._build()
                self._lib = self._bind()
            return self._lib

    def count_launch(self) -> None:
        with self._count_lock:
            self.launches += 1

    def reset_launches(self) -> None:
        with self._count_lock:
            self.launches = 0

    def check(self, err: int, what: str) -> None:
        """Raise on a nonzero ``cudaError_t`` returned by an entry point."""
        if err:
            msg = self.load().mx_cuda_error_string(err).decode()
            raise MXNetError("%s: CUDA error %d (%s)" % (what, err, msg))


_ERR_STRING = {"mx_cuda_error_string": ([_c_int], ctypes.c_char_p)}

FLASH_FWD = KernelLibrary("flash_fwd", dict(_ERR_STRING, mx_flash_fwd=(
    [_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
     _c_int, _c_int, _c_int, _c_int, _c_int, _c_float, _c_int, _c_void_p],
    _c_int)))

LIBRARIES: List[KernelLibrary] = [FLASH_FWD]


def build_all() -> Dict[str, float]:
    """Build and load every kernel library; returns build seconds by
    name."""
    for lib in LIBRARIES:
        lib.load()
    return {lib.name: lib.build_seconds or 0.0 for lib in LIBRARIES}
