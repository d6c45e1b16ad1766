"""mx.tpu_kernel: user-written kernels, as CUDA C++ built for the card.

Counterpart of ``mxnet_tpu/tpu_kernel.py`` (the port of K4, ``Kernel._build``
at ``mxnet_tpu/tpu_kernel.py:96``), which the JAX package modelled on
upstream MXNet's NVRTC ``rtc.py`` (``CudaModule`` / ``CudaKernel``).  There
the user writes a Pallas body over refs; here the body is what rtc.py took:
the CUDA C++ source of a ``__global__`` function, its name, and its C
parameter list.

**The signature.**  Pointers come first: the inputs in order, then the
outputs (as Pallas passes input refs, then output refs).  Scalar parameters
come last.  Pointer types map to torch dtypes (``float*`` float32,
``__nv_bfloat16*`` bfloat16, ``half*`` float16); scalars are ``int``,
``long long`` or ``float``.  With ``dtypes=("float32", "bfloat16")`` the
source defines a template over one type parameter: ``T`` in the signature
stands for the element type, ``<entry><float>`` and
``<entry><__nv_bfloat16>`` are both built, and a launch takes the one of
its first input's dtype.  The scalar values come from
``scalars(*inputs, *outputs)``.

**The build.**  The source goes into one translation unit after a prelude
(``<cuda_runtime.h>``, ``<cuda_bf16.h>``, ``<cuda_fp16.h>``) and before a
generated ``extern "C"`` launcher per instantiation, which raises the
dynamic shared-memory limit when ``shared_mem`` is above 48 KB, calls
``cudaLaunchKernel`` and returns its error or ``cudaGetLastError()``.
Since the launcher sits in the same unit, C++ names and templates need no
``extern "C"`` from the user.  ``nvcc`` builds it for ``sm_90a`` at the
first launch (``ops/_kernels.py`` ``SourceLibrary``), named by the hash of
the generated text, so a re-registered name with a new body launches the
new body.  Python passes one ctypes value per parameter through an array
of pointers, on ``torch.cuda.current_stream`` of the inputs' device.

**No fallback that hides the card.**  On CUDA tensors the CUDA body always
runs; an ``nvcc`` error raises with nvcc's log and a launch error with the
CUDA error string.  A tensor whose dtype does not match its parameter
raises (it is never cast); a non-contiguous input is made contiguous (a
copy).  ``plain``, a PyTorch function of the inputs that returns the
outputs, runs only for CPU tensors: the caller asking for the CPU, as
the reference interprets off the TPU.  Without ``plain`` a CPU launch
raises.  Each kernel counts its launches on the card
(``ops._kernels.launch_counts()`` key ``tpu_kernel:<name>``); the CPU route
counts nothing.

``in_specs``, ``out_specs`` and ``interpret`` (Pallas BlockSpecs and the
interpreter switch) have no meaning for a CUDA kernel and raise if given;
``grid`` and ``block`` are CUDA launch dimensions (or callables of the
first output's shape) and ``shared_mem`` the dynamic shared memory in
bytes.  A callable ``grid`` runs at each launch with the launch device
current, so it may size the grid by the card (``torch.cuda.
get_device_properties(torch.cuda.current_device()).multi_processor_count``).

**The default grid** is one thread per entry of the first output, so a body
that indexes without a stride loop covers every entry.  That is one 2-byte
(bf16) or 4-byte (fp32) element a thread: far too few bytes in flight to
cover the latency of device memory, so such a body runs at well under the
card's memory rate.  A bandwidth-bound body should loop over its output in
16-byte vectors (``uint4``: 8 bf16 or 4 fp32 values) and pass ``grid=``
of a few blocks per SM, as ``chip_smoke.USER_KERNELS`` does.
"""
from __future__ import annotations

import ctypes
import math
import re
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from .base import MXNetError, torch_dtype
from .device import resolve
from .ops import _kernels
from .ops import registry as _registry

__all__ = ["Kernel", "kernel", "register", "parse_signature",
           "generate_source"]

POINTER_DTYPES = {"float": torch.float32, "__nv_bfloat16": torch.bfloat16,
                  "half": torch.float16, "__half": torch.float16}
SCALAR_CTYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
                 "float": ctypes.c_float}
C_TYPE_OF = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16",
             torch.float16: "half"}
_QUALIFIERS = ("const", "__restrict__", "restrict", "volatile")
_INT_RANGE = (-2 ** 31, 2 ** 31 - 1)

PRELUDE = """\
// Generated by mxnet_tpu_torch.tpu_kernel: this prelude, the user's
// source, then one extern "C" launcher per instantiation.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
"""

LAUNCHER = """
extern "C" int {fn}(void** args, unsigned int gx, unsigned int gy,
                    unsigned int gz, unsigned int bx, unsigned int by,
                    unsigned int bz, unsigned int smem, void* stream) {{
  const void* fn = (const void*)(&{entry});
  cudaError_t e;
  if (smem > 48u * 1024u) {{
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }}
  e = cudaLaunchKernel(fn, dim3(gx, gy, gz), dim3(bx, by, bz), args,
                       (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}}
"""

ERROR_STRING = """
extern "C" const char* mx_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
"""

_LAUNCH_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_uint] * 7 + [ctypes.c_void_p]


class Param(NamedTuple):
    name: str
    ctype: str          # base C type, qualifiers dropped
    pointer: bool


def parse_signature(signature: str) -> List[Param]:
    """A C parameter list (``"const float* x, float* out, long long n"``)
    as :class:`Param`s; raises on a type the launcher cannot pass or on a
    pointer after a scalar."""
    params = []
    for part in signature.split(","):
        tokens = re.findall(r"[A-Za-z_][A-Za-z0-9_]*|\*|&|\[", part)
        if "&" in tokens or "[" in tokens:
            raise MXNetError("signature %r: references and arrays are not "
                             "parameters a launch can pass" % signature)
        stars = tokens.count("*")
        words = [t for t in tokens if t != "*" and t not in _QUALIFIERS]
        if len(words) < 2 or stars > 1:
            raise MXNetError("signature %r: cannot read parameter %r (want "
                             "'<type> <name>' or '<type>* <name>')"
                             % (signature, part.strip()))
        name, ctype = words[-1], " ".join(words[:-1])
        table = POINTER_DTYPES if stars else SCALAR_CTYPES
        if ctype not in table:
            raise MXNetError(
                "signature %r: parameter %r has type %s%s; supported are "
                "pointers to %s and scalars %s"
                % (signature, name, ctype, "*" if stars else "",
                   sorted(POINTER_DTYPES), sorted(SCALAR_CTYPES)))
        params.append(Param(name, ctype, bool(stars)))
    first_scalar = next((i for i, p in enumerate(params) if not p.pointer),
                        len(params))
    if any(p.pointer for p in params[first_scalar:]):
        raise MXNetError("signature %r: pointers (inputs, then outputs) "
                         "must come before every scalar" % signature)
    return params


def generate_source(source: str, entries: Sequence[str]) -> str:
    """The translation unit nvcc builds: the prelude, ``source``, and a
    launcher ``mx_user_launch_<i>`` for each ``entries[i]`` (a
    ``__global__`` function's name or a template instantiation)."""
    launchers = "".join(LAUNCHER.format(fn="mx_user_launch_%d" % i,
                                        entry=entry)
                        for i, entry in enumerate(entries))
    return PRELUDE + source.rstrip() + "\n" + launchers + ERROR_STRING


class _Variant(NamedTuple):
    entry: str
    params: List[Param]
    launcher: str


def _dims(d, what: str):
    d = (int(d),) if isinstance(d, int) else tuple(int(x) for x in d)
    if not 1 <= len(d) <= 3 or any(x < 1 for x in d):
        raise MXNetError("%s %r: want 1 to 3 positive dimensions" % (what, d))
    return d + (1,) * (3 - len(d))


def _as_structs(out_shape, out_dtype, default_dtype):
    """``out_shape`` (a shape, a tensor such as a meta aval, or a list of
    either) as [(shape, dtype)] and whether it named one output."""
    def one(s, d):
        if isinstance(s, torch.Tensor):
            return tuple(s.shape), s.dtype if d is None else torch_dtype(d)
        return tuple(int(x) for x in s), \
            default_dtype if d is None else torch_dtype(d)

    multi = isinstance(out_shape, (list, tuple)) and out_shape and \
        isinstance(out_shape[0], (list, tuple, torch.Size, torch.Tensor))
    if not multi:
        return [one(out_shape, out_dtype)], True
    dts = out_dtype if isinstance(out_dtype, (list, tuple)) \
        else [out_dtype] * len(out_shape)
    return [one(s, d) for s, d in zip(out_shape, dts)], False


class Kernel:
    """A launchable user CUDA kernel (reference: rtc.py CudaKernel).

    ``source`` holds the ``__global__`` function ``entry`` whose C
    parameters are ``signature``; ``grid`` (default: one thread per entry
    of the first output, which moves 2 bytes a thread in bf16: a
    bandwidth-bound body should vectorise and pass a grid of a few blocks
    per SM) and ``block`` (default 256 threads) are CUDA dims or callables
    of the first output's shape (a callable grid runs on the launch
    device); ``shared_mem`` is the
    dynamic shared memory in bytes; ``plain`` is the PyTorch version CPU
    tensors take; ``dtypes`` builds a template for each element type;
    ``scalars(*inputs, *outputs)`` gives the trailing scalar values.
    ``name`` (default: ``entry``) names the kernel in counters and
    errors."""

    def __init__(self, source: str, entry: str, signature: str, *,
                 name: Optional[str] = None, grid=None, block=256,
                 shared_mem: int = 0, plain: Optional[Callable] = None,
                 dtypes: Optional[Sequence] = None,
                 scalars: Optional[Callable] = None,
                 in_specs=None, out_specs=None, interpret=None):
        for what, value in (("in_specs", in_specs), ("out_specs", out_specs),
                            ("interpret", interpret)):
            if value is not None:
                raise MXNetError(
                    "tpu_kernel: %s= is a Pallas argument with no meaning "
                    "for a CUDA kernel; give grid=, block= and shared_mem="
                    % what)
        self.name = name or entry
        self.grid = grid
        self.block = block
        self.shared_mem = int(shared_mem)
        self.plain = plain
        self.scalars = scalars
        self._variants: Dict[Optional[torch.dtype], _Variant] = {}
        if dtypes:
            for i, d in enumerate(dtypes):
                dt = torch_dtype(d)
                if dt not in C_TYPE_OF:
                    raise MXNetError("tpu_kernel %s: no CUDA element type "
                                     "for %s" % (self.name, dt))
                ct = C_TYPE_OF[dt]
                self._variants[dt] = _Variant(
                    "%s<%s>" % (entry, ct),
                    parse_signature(re.sub(r"\bT\b", ct, signature)),
                    "mx_user_launch_%d" % i)
        else:
            self._variants[None] = _Variant(
                entry, parse_signature(signature), "mx_user_launch_0")
        self.source = generate_source(
            source, [v.entry for v in self._variants.values()])
        sigs = {v.launcher: (_LAUNCH_ARGTYPES, ctypes.c_int)
                for v in self._variants.values()}
        sigs["mx_cuda_error_string"] = ([ctypes.c_int], ctypes.c_char_p)
        self.counter = "tpu_kernel:" + self.name
        self.library = _kernels.SourceLibrary(
            re.sub(r"\W", "_", self.name), self.source, sigs, [self.counter])
        _kernels.add_user_library(self.name, self.library)

    # -- launch ------------------------------------------------------------
    def launch(self, args: Sequence, out_shape, out_dtype=None):
        """Launch over NDArrays (or tensors); returns NDArray(s) on the
        arguments' context.  Not recorded by autograd (``register`` with
        ``grad=`` makes a differentiable op)."""
        from .ndarray.ndarray import NDArray
        xs = [a.data if isinstance(a, NDArray) else a for a in args]
        structs, single = _as_structs(
            out_shape, out_dtype, xs[0].dtype if xs else torch.float32)
        with torch.no_grad():
            outs = self.run(xs, structs)
        return NDArray(outs[0]) if single else tuple(NDArray(o)
                                                     for o in outs)

    def __call__(self, *args, out_shape=None, out_dtype=None):
        if out_shape is None:
            raise MXNetError("Kernel() requires out_shape=")
        return self.launch(list(args), out_shape, out_dtype)

    def run(self, xs: Sequence[torch.Tensor], structs) -> tuple:
        """Tensors in, a tuple of tensors out: the CUDA body for CUDA
        tensors, ``plain`` for CPU tensors.  ``structs`` is
        [(shape, dtype)] per output."""
        if not all(isinstance(x, torch.Tensor) for x in xs):
            raise MXNetError("tpu_kernel %s: launch arguments are arrays; "
                             "scalar parameters come from scalars="
                             % self.name)
        devices = {x.device for x in xs}
        if len(devices) > 1:
            raise MXNetError("tpu_kernel %s: inputs on several devices %s"
                             % (self.name, sorted(map(str, devices))))
        dev = devices.pop() if devices else resolve(None)
        if dev.type == "cpu":
            return self._run_plain(xs, structs)
        if dev.type != "cuda":
            raise MXNetError("tpu_kernel %s: tensors on %s; a CUDA kernel "
                             "takes CUDA tensors (CPU tensors take plain=)"
                             % (self.name, dev))
        return self._run_cuda(xs, structs, dev)

    def _run_plain(self, xs, structs) -> tuple:
        if self.plain is None:
            raise MXNetError(
                "tpu_kernel %s: CPU tensors, and the kernel has no plain= "
                "PyTorch version; its CUDA body runs only on the card"
                % self.name)
        outs = self.plain(*xs)
        outs = tuple(outs) if isinstance(outs, (tuple, list)) else (outs,)
        got = [(tuple(o.shape), o.dtype) for o in outs]
        if got != [(tuple(s), d) for s, d in structs]:
            raise MXNetError("tpu_kernel %s: plain version returned %s, the "
                             "launch asked for %s" % (self.name, got,
                                                      structs))
        return outs

    def _variant(self, tensors) -> _Variant:
        if None in self._variants:
            return self._variants[None]
        dt = tensors[0].dtype if tensors else None
        if dt not in self._variants:
            raise MXNetError("tpu_kernel %s: built for %s, not for inputs "
                             "of %s" % (self.name, sorted(
                                 map(str, self._variants)), dt))
        return self._variants[dt]

    def _run_cuda(self, xs, structs, dev) -> tuple:
        ins = list(xs)
        var = self._variant(ins)
        ptrs = [p for p in var.params if p.pointer]
        scal = [p for p in var.params if not p.pointer]
        if len(ins) + len(structs) != len(ptrs):
            raise MXNetError(
                "tpu_kernel %s: %d inputs + %d outputs, but the signature "
                "has %d pointers" % (self.name, len(ins), len(structs),
                                     len(ptrs)))
        for i, (t, p) in enumerate(zip(ins, ptrs)):
            want = POINTER_DTYPES[p.ctype]
            if t.dtype != want:
                raise MXNetError("tpu_kernel %s: input %d (%s) is %s, the "
                                 "signature says %s* (%s)" % (
                                     self.name, i, p.name, t.dtype, p.ctype,
                                     want))
            if not t.is_contiguous():
                ins[i] = t.contiguous()      # documented copy
        outs = []
        for (shape, dt), p in zip(structs, ptrs[len(ins):]):
            if dt != POINTER_DTYPES[p.ctype]:
                raise MXNetError("tpu_kernel %s: output %s asked as %s, the "
                                 "signature says %s*" % (self.name, p.name,
                                                         dt, p.ctype))
            outs.append(torch.empty(shape, dtype=dt, device=dev))
        values = [] if self.scalars is None \
            else list(self.scalars(*ins, *outs))
        if len(values) != len(scal):
            raise MXNetError("tpu_kernel %s: %d scalar values for %d scalar "
                             "parameters %s" % (self.name, len(values),
                                                len(scal),
                                                [p.name for p in scal]))
        c_vals = [ctypes.c_void_p(t.data_ptr()) for t in ins + outs]
        for p, v in zip(scal, values):
            if p.ctype == "int" and not _INT_RANGE[0] <= int(v) \
                    <= _INT_RANGE[1]:
                raise MXNetError("tpu_kernel %s: %s = %d does not fit an "
                                 "int" % (self.name, p.name, int(v)))
            c_vals.append(SCALAR_CTYPES[p.ctype](v))
        shape0 = structs[0][0] if structs else ()
        block = _dims(self.block(shape0) if callable(self.block)
                      else self.block, "block")
        grid = None
        if self.grid is None:
            grid = (math.ceil(math.prod(shape0) / math.prod(block)),)
            if grid[0] == 0:
                return tuple(outs)           # nothing to compute
        elif not callable(self.grid):
            grid = _dims(self.grid, "grid")
        lib = self.library.load()            # nvcc at the first launch
        argv = (ctypes.c_void_p * len(c_vals))(
            *[ctypes.addressof(v) for v in c_vals])
        with torch.cuda.device(dev):
            # a callable grid runs on the launch device, after the build
            grid = _dims(self.grid(shape0) if grid is None else grid,
                         "grid")
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, var.launcher)(
                ctypes.cast(argv, ctypes.c_void_p), *grid, *block,
                self.shared_mem, stream)
        self.library.check(err, "tpu_kernel %s launch" % self.name)
        self.library.count_launch(self.counter)
        return tuple(outs)


def kernel(name: Optional[str] = None, *, source: str, signature: str,
           entry: Optional[str] = None, grid=None, block=256,
           shared_mem: int = 0, dtypes: Optional[Sequence] = None,
           scalars: Optional[Callable] = None, in_specs=None,
           out_specs=None, interpret=None):
    """Decorator form: over the kernel's plain PyTorch version, returns a
    launchable :class:`Kernel` whose ``entry`` (and ``name``) default to
    the decorated function's name."""

    def _wrap(plain: Callable) -> Kernel:
        return Kernel(source, entry or plain.__name__, signature,
                      name=name or plain.__name__, grid=grid, block=block,
                      shared_mem=shared_mem, plain=plain, dtypes=dtypes,
                      scalars=scalars, in_specs=in_specs,
                      out_specs=out_specs, interpret=interpret)

    return _wrap


class _UserOp(torch.autograd.Function):
    """A registered user kernel with a ``grad``: forward launches the
    kernel; backward calls ``grad(cotangents, *inputs)`` on tensors, the
    cotangents always a tuple."""

    @staticmethod
    def forward(ctx, kern, structs, grad, *xs):
        ctx.grad = grad
        ctx.save_for_backward(*xs)
        return kern.run(xs, structs)

    @staticmethod
    def backward(ctx, *cts):
        xs = ctx.saved_tensors
        gr = tuple(ctx.grad(tuple(cts), *xs))
        if len(gr) != len(xs):
            raise MXNetError("user kernel grad returned %d cotangents for "
                             "%d inputs" % (len(gr), len(xs)))
        return (None, None, None) + gr


def _aval(x: torch.Tensor) -> torch.Tensor:
    """A tensor's shape and dtype without storage (the counterpart of
    ``jax.ShapeDtypeStruct``)."""
    return torch.empty(x.shape, dtype=x.dtype, device="meta")


def register(name: str, *, out_shape_fn: Callable,
             grad: Optional[Callable] = None, aliases: Sequence[str] = (),
             source: str, signature: str, entry: Optional[str] = None,
             grid=None, block=256, shared_mem: int = 0,
             dtypes: Optional[Sequence] = None,
             scalars: Optional[Callable] = None, in_specs=None,
             out_specs=None, interpret=None):
    """Register a user kernel as a framework op: after

        @mx.tpu_kernel.register("my_op", out_shape_fn=lambda x: x,
                                source=SRC, signature=SIG)
        def my_op_kernel(x):        # the plain version
            ...

    ``mx.nd.my_op(x)`` dispatches it like a built-in.
    ``out_shape_fn(*avals)`` gets ``meta``-device tensors (shape and dtype)
    and returns the outputs' (a tensor, a shape, or a list of them).
    ``grad(cotangents, *inputs) -> tuple`` on tensors supplies the backward
    (a ``torch.autograd.Function``); without it the op is registered
    non-differentiable, so its output under ``autograd.record()`` carries no
    gradient.  The same name registered again replaces the op and launches
    the new body.  Returns the :class:`Kernel`."""

    def _wrap(plain: Callable) -> Kernel:
        k = Kernel(source, entry or plain.__name__, signature, name=name,
                   grid=grid, block=block, shared_mem=shared_mem,
                   plain=plain, dtypes=dtypes, scalars=scalars,
                   in_specs=in_specs, out_specs=out_specs,
                   interpret=interpret)

        def impl(*xs):
            structs, single = _as_structs(
                out_shape_fn(*[_aval(x) for x in xs]), None,
                xs[0].dtype if xs else torch.float32)
            if grad is None:
                outs = k.run(xs, structs)
            else:
                outs = _UserOp.apply(k, structs, grad, *xs)
            return outs[0] if single else tuple(outs)

        impl.__name__ = name
        impl.__doc__ = plain.__doc__ or ("user kernel %s" % name)
        _registry.register(name, impl, differentiable=grad is not None,
                           aliases=aliases, replace=True)
        return k

    return _wrap
