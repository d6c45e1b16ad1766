"""Devices of the PyTorch port.

Counterpart of ``mxnet_tpu/device.py``.  A :class:`Context` names a device:
``mx.gpu(i)`` is ``torch.device("cuda", i)`` (the role the JAX package's
first-class accelerator context ``mx.tpu(i)`` plays there) and ``mx.cpu()``
is the host.  ``with mx.cpu():`` / ``with mx.gpu(0):`` set the default of
the current thread, which :func:`current_context` reads.

The default context is the GPU.  This deliberately differs from the
reference's CPU default: the port's entry points run on the card unless the
caller asks for the CPU (``ctx=mx.cpu()``, ``device="cpu"`` or a ``with``
scope), and asking for the GPU on a machine without one raises rather than
moving to the CPU.
"""
from __future__ import annotations

import threading
from typing import Optional, Union

import torch

from .base import MXNetError

__all__ = ["Context", "Device", "cpu", "gpu", "cpu_pinned",
           "current_context",
           "current_device", "default_device", "resolve", "as_context",
           "in_context",
           "num_gpus", "gpu_memory_info"]


class Context:
    """A device context; ``device_type`` is 'cpu', 'gpu' or 'cpu_pinned'.

    'cpu_pinned' (device type 3) names host memory and aliases the CPU, as
    in the reference: it is the same torch device as 'cpu', equal to
    ``cpu(i)`` of the same id, and an array made on it holds the same
    values (the port does not pin it; pinning changes no value)."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}
    _default_ctx = threading.local()

    __slots__ = ("device_typeid", "device_id", "_old_ctx")

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        elif isinstance(device_type, str):
            if device_type not in Context.devstr2type:
                raise MXNetError("unknown device type %r (cpu, gpu or "
                                 "cpu_pinned)" % device_type)
            self.device_typeid = Context.devstr2type[device_type]
            self.device_id = int(device_id)
        else:
            self.device_typeid = int(device_type)
            self.device_id = int(device_id)
        self._old_ctx: Optional[Context] = None

    @property
    def device_type(self) -> str:
        return Context.devtype2str[self.device_typeid]

    @property
    def canonical_type(self) -> str:
        """'cpu_pinned' is the host, 'cpu'."""
        t = self.device_type
        return "cpu" if t == "cpu_pinned" else t

    def __hash__(self):
        return hash((self.canonical_type, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.canonical_type == other.canonical_type
                and self.device_id == other.device_id)

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device`` this context names (no availability
        check; :func:`resolve` makes it)."""
        if self.canonical_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def holds(self, device: torch.device) -> bool:
        """Whether a tensor on ``device`` can belong to this context:
        ``cpu(i)`` for any host tensor (the host is one torch device;
        the contexts ``cpu(0)``, ``cpu(1)`` ... tell copies apart, as in
        the reference), ``gpu(i)`` for one on ``cuda:i``."""
        if self.canonical_type == "cpu":
            return device.type == "cpu"
        return device.type == "cuda" and (device.index or 0) == \
            self.device_id

    @staticmethod
    def from_torch(device: torch.device) -> "Context":
        """The context of a tensor's device, for a tensor made without
        one (a host tensor: ``cpu(0)``)."""
        if device.type == "cuda":
            return Context("gpu", device.index or 0)
        if device.type == "cpu":
            return Context("cpu", 0)
        raise MXNetError("no context for device %s" % device)

    # -- default-context stack (reference: with mx.Context(...)) ---------
    def __enter__(self):
        self._old_ctx = current_context()
        Context._default_ctx.value = self
        return self

    def __exit__(self, *exc):
        Context._default_ctx.value = self._old_ctx
        return False


#: the reference's 2.x name of :class:`Context`
Device = Context

DeviceLike = Union[str, torch.device, Context, None]


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    """Host memory (the reference's pinned staging context): the CPU."""
    return Context("cpu_pinned", device_id)


def current_context() -> Context:
    """The current thread's default context: the innermost ``with``
    scope's, else ``gpu(0)``."""
    ctx = getattr(Context._default_ctx, "value", None)
    return ctx if ctx is not None else Context("gpu", 0)


current_device = current_context


def num_gpus() -> int:
    """The number of CUDA devices (0 without CUDA)."""
    return torch.cuda.device_count()


def gpu_memory_info(device_id: int = 0):
    """``(free, total)`` bytes of GPU ``device_id``; raises
    :class:`MXNetError` without CUDA, as the reference's upstream does."""
    dev = resolve(Context("gpu", device_id))
    return torch.cuda.mem_get_info(dev)


def default_device() -> torch.device:
    """The device an entry point uses when none is given: the current
    context's, which is the GPU unless a ``with mx.cpu():`` scope says
    otherwise."""
    return current_context().torch_device


def resolve(device: DeviceLike = None) -> torch.device:
    """``device`` (a ``torch.device``, its name, a :class:`Context`, or None
    for :func:`current_context`) as a ``torch.device``.  Raises
    :class:`MXNetError` for a CUDA device when CUDA is unavailable, and
    for ``gpu(i)`` past the visible cards, naming how many there are (the
    reference's ``jax_device``)."""
    if device is None:
        dev = default_device()
    elif isinstance(device, Context):
        dev = device.torch_device
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "device %s requested%s but torch.cuda.is_available() is "
                "False; pass device='cpu' or ctx=mx.cpu() to run on the CPU"
                % (dev, " (the default)" if device is None else ""))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        n = torch.cuda.device_count()
        if dev.index >= n:
            raise MXNetError("gpu(%d): device_id %d out of range (%d gpu "
                             "device(s) visible)" % (dev.index, dev.index, n))
    elif dev.type != "cpu":
        raise MXNetError("unsupported device %s (cpu or cuda)" % dev)
    return dev


def as_context(device: DeviceLike = None) -> Context:
    """``device`` as a :class:`Context`: a context as it is, None as the
    current context, a ``torch.device`` or its name as its context."""
    if isinstance(device, Context):
        return device
    if device is None:
        return current_context()
    return Context.from_torch(torch.device(device))


def in_context(ctx: Context, fn):
    """``fn`` wrapped to run in (a copy of) context ``ctx``: a worker
    thread's current context is its own (the default, the GPU), not that
    of the thread that made it."""
    def run(*args, **kwargs):
        with Context(ctx):
            return fn(*args, **kwargs)
    return run
