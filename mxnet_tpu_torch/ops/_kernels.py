"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface and loaded with :mod:`ctypes`.
The build happens at first use, never at import: a machine without ``nvcc``
or a card imports this module freely.  Libraries land in
``mxnet_tpu_torch/_build/`` (git-ignored), named by a hash of their source,
of every ``csrc/*.cuh`` header beside it and of the flags, so an edited
source or header never loads a stale library.  :func:`build_all` builds
every library with one ``nvcc`` each, all started together, and loads them.

Each kernel has its own launch counter, kept by its library and raised by
its wrapper where it launches the kernel and nowhere else;
:func:`launch_counts` reads them all and :func:`reset_launches` sets them
to 0.

A :class:`SourceLibrary` is built the same way from source *text* (the
user kernels of ``tpu_kernel``): the text is written to
``_build/<name>-<hash>.cu`` and compiled with the same flags, and the
library is named by the hash of the text, so a new body gives a new
library.  :func:`add_user_library` records the newest library of each user
kernel; its counter appears in :func:`launch_counts` as
``tpu_kernel:<name>`` once that library is loaded on the card.
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
from typing import Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError

__all__ = ["KernelLibrary", "SourceLibrary", "FLASH_FWD", "FLASH_BWD",
           "build_all", "add_user_library", "launch_counts",
           "reset_launches", "nvcc_path"]

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
    """One ``csrc/<name>.cu`` source, its shared library, its C entry
    points and a launch counter for each kernel it holds.  ``signatures``
    maps each exported function to ``(argtypes, restype)``."""

    def __init__(self, name: str, signatures: Dict[str, tuple],
                 kernels: Sequence[str]):
        self.name = name
        self.source = CSRC / (name + ".cu")
        self._signatures = signatures
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        #: seconds the last build took, and nvcc's -Xptxas -v report
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        #: launches of each kernel, counted by its wrapper
        self.launches: Dict[str, int] = {k: 0 for k in kernels}
        self._count_lock = threading.Lock()

    def source_bytes(self) -> bytes:
        return self.source.read_bytes()

    def header_bytes(self) -> bytes:
        """The name and bytes of every ``*.cuh`` header in the source's
        directory, any of which the source may include."""
        return b"".join(h.name.encode() + b"\0" + h.read_bytes()
                        for h in sorted(self.source.parent.glob("*.cuh")))

    def library_path(self) -> Path:
        digest = hashlib.sha1(self.source_bytes() + self.header_bytes()
                              + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / ("lib%s-%s.so" % (self.name, digest[:12]))

    def _start_build(self) -> Tuple[subprocess.Popen, Path, float]:
        """Start ``nvcc`` into a temporary file; :meth:`_finish_build`
        waits for it and moves the library into place."""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self._write_source()
        out = self.library_path()
        tmp = out.with_name(out.name + ".%d.tmp" % os.getpid())
        cmd = [nvcc_path()] + NVCC_FLAGS + ["-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, time.perf_counter()

    def _write_source(self) -> None:
        """A ``csrc/`` source is already on disk."""

    def _finish_build(self, proc: subprocess.Popen, tmp: Path,
                      t0: float) -> None:
        self.build_log = proc.communicate()[0]
        if proc.returncode != 0:
            raise MXNetError("nvcc failed for %s (exit %d):\n%s"
                             % (self.source, proc.returncode,
                                self.build_log))
        os.replace(tmp, self.library_path())
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
                if not self.library_path().exists():
                    self._finish_build(*self._start_build())
                elif self.build_seconds is None:
                    self.build_seconds = 0.0    # built by an earlier run
                self._lib = self._bind()
            return self._lib

    def count_launch(self, kernel: str) -> None:
        with self._count_lock:
            self.launches[kernel] += 1

    def reset_launches(self) -> None:
        with self._count_lock:
            for k in self.launches:
                self.launches[k] = 0

    def check(self, err: int, what: str) -> None:
        """Raise on a nonzero ``cudaError_t`` returned by an entry point."""
        if err:
            msg = self.load().mx_cuda_error_string(err).decode()
            raise MXNetError("%s: CUDA error %d (%s)" % (what, err, msg))


class SourceLibrary(KernelLibrary):
    """A library built from source text rather than a ``csrc/`` file."""

    def __init__(self, name: str, text: str, signatures: Dict[str, tuple],
                 kernels: Sequence[str]):
        self.text = text
        super().__init__(name, signatures, kernels)
        self.source = self.library_path().with_suffix(".cu")

    def source_bytes(self) -> bytes:
        return self.text.encode()

    def header_bytes(self) -> bytes:
        """A body's text includes no header of ``csrc/``."""
        return b""

    def _write_source(self) -> None:
        tmp = self.source.with_name(self.source.name + ".%d.tmp"
                                    % os.getpid())
        tmp.write_text(self.text)
        os.replace(tmp, self.source)


_ERR_STRING = {"mx_cuda_error_string": ([_c_int], ctypes.c_char_p)}

FLASH_FWD = KernelLibrary("flash_fwd", dict(
    _ERR_STRING,
    mx_flash_fwd=([_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
                   _c_int, _c_int, _c_int, _c_int, _c_int, _c_float, _c_int,
                   _c_void_p], _c_int),
    mx_flash_fwd_smem=([_c_int, _c_int], _c_int)), kernels=["flash_fwd"])

FLASH_BWD = KernelLibrary("flash_bwd", dict(
    _ERR_STRING,
    mx_flash_bwd_dq=([_c_void_p] * 7 + [_c_int] * 5
                     + [_c_float, _c_int, _c_void_p], _c_int),
    mx_flash_bwd_dkv=([_c_void_p] * 8 + [_c_int] * 5
                      + [_c_float, _c_int, _c_void_p], _c_int),
    mx_flash_bwd_smem=([_c_int, _c_int, _c_int], _c_int)),
    kernels=["flash_bwd_dq", "flash_bwd_dkv"])

LIBRARIES: List[KernelLibrary] = [FLASH_FWD, FLASH_BWD]

# the newest library of each user kernel, by kernel name
_USER_LIBRARIES: Dict[str, SourceLibrary] = {}
_USER_LOCK = threading.Lock()


def add_user_library(kernel: str, lib: SourceLibrary) -> None:
    """Make ``lib`` the library whose counter reports user kernel
    ``kernel`` (a re-registered kernel's new body replaces its old one)."""
    with _USER_LOCK:
        _USER_LIBRARIES[kernel] = lib


def _counted_libraries() -> List[KernelLibrary]:
    with _USER_LOCK:
        users = [lib for lib in _USER_LIBRARIES.values()
                 if lib._lib is not None]
    return LIBRARIES + users


def build_all(libraries: Optional[Sequence[KernelLibrary]] = None
              ) -> Dict[str, float]:
    """Build every library of ``libraries`` (default: the ``csrc/`` ones)
    that is not built yet, one ``nvcc`` process each, all running at once;
    then load them all.  Returns the build seconds by library name."""
    libraries = LIBRARIES if libraries is None else list(libraries)
    pending, errors, paths = [], [], set()
    try:
        for lib in libraries:
            path = lib.library_path()
            if lib._lib is None and not path.exists() and path not in paths:
                paths.add(path)     # one nvcc for libraries of one source
                pending.append((lib, lib._start_build()))
    finally:
        # wait for every nvcc that started, even after a failure
        for lib, started in pending:
            try:
                lib._finish_build(*started)
            except MXNetError as e:
                errors.append(e)
    if errors:
        raise errors[0]
    for lib in libraries:
        lib.load()
    return {lib.name: lib.build_seconds or 0.0 for lib in libraries}


def launch_counts() -> Dict[str, int]:
    """A copy of every kernel's launch count, by kernel name: the
    ``csrc/`` kernels always, a user kernel once its library is loaded."""
    out: Dict[str, int] = {}
    for lib in _counted_libraries():
        with lib._count_lock:
            out.update(lib.launches)
    return out


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for lib in _counted_libraries():
        lib.reset_launches()
