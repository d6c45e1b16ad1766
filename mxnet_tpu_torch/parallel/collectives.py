"""The collectives over one mesh axis, as autograd Functions.

Counterpart of the ``lax`` collectives that ``mxnet_tpu/parallel/ring.py``,
``pipeline.py`` and ``moe.py`` call inside ``shard_map``.  The reference
runs one program over a device mesh; the port runs one process a rank, and
each rank calls these on its own shard, over the process group of one axis
of a :class:`~.mesh.Mesh`.  Every rank of the axis must call the same
collectives in the same order, forward and backward.

Each is a ``torch.autograd.Function`` whose backward is JAX's transpose:

* :func:`ppermute` shifts along the axis (index i sends to i + shift);
  its backward is the inverse shift.
* :func:`all_to_all` (tiled: split ``split_axis`` into n chunks, chunk j
  to index j, received chunks concatenated along ``concat_axis`` in
  source order); its backward is the swapped ``all_to_all``.
* :func:`psum` sums over the axis into a value that every rank holds
  alike.  A loss computed from it on every rank is one loss, not n, so
  the backward passes each rank's cotangent through unchanged (JAX's
  transpose of a sum into an axis-invariant value).  An all-reduce of the
  cotangents (``torch.distributed.nn.functional.all_reduce``) would count
  such a loss n times.
* :func:`pmean` is the sum over n; its backward divides by n.
* :func:`pvary` marks a value that every rank holds alike (a
  ``shard_map`` input replicated over the axis) as used by each rank on
  its own: the identity forward, the sum of every rank's cotangent
  backward, so each rank's gradient is the whole one.
* :func:`all_gather` concatenates every rank's piece along a dimension
  (``lax.all_gather(tiled=True)``).  Its backward depends on how the
  whole value is used: ``backward="slice"`` (a weight used whole by a
  computation every rank of the axis repeats alike, as a tp rank does)
  takes this rank's slice of the cotangent, which every rank holds
  alike; ``backward="reduce_scatter"`` (the batch is split over the
  axis, as over fsdp, so each rank's cotangent is a partial sum) sums
  the ranks' cotangents and keeps this rank's slice.
* :func:`reduce_scatter` sums over the axis and keeps this rank's slice
  of a dimension (``lax.psum_scatter(tiled=True)``); its backward is the
  all-gather.
* :func:`axis_slice` takes this rank's slice of a value every rank holds
  alike; its backward all-gathers the cotangents (the transpose of a
  slice of an axis-invariant value).

With these rules a value every rank holds alike carries its cotangent
once, and a value each rank holds its own carries its own, as in the
reference.

**Global batch statistics.**  :func:`global_batch_norm` is BatchNorm's
training forward over a batch split over an axis, normalised by the
statistics of the whole batch, as the reference's ``jnp.mean`` over a
dp-sharded batch gives them (XLA turns it into a ``psum``).  Its forward
all-reduces the per-channel count and sum, then the sum of squared
deviations from the global mean (two passes, without the cancellation of
E[x^2] - E[x]^2); its backward all-reduces the two per-channel sums the
input's gradient needs (of dy and of dy x the normalised input).
``gamma`` and ``beta`` get this rank's own sums, as every parameter's
gradient is this rank's before the step's all-reduce.  PyTorch's
``torch.nn.SyncBatchNorm`` refuses CPU tensors, and the gloo backend on
the host is what the CPU tests run, so it is written here over these
collectives.  :class:`batch_stats_scope` is the scope in which
``nn.BatchNorm`` takes it (``TrainStep`` enters it around the forward
over a dp axis of more than one rank); its ``stats`` list the last
forward's (mean, variance) of each layer, in call order.

**Transport.**  NCCL takes device tensors.  Gloo moves host memory: its
``all_reduce``, ``broadcast`` and ``all_gather`` copy CUDA tensors through
the host themselves, but its send/recv and ``all_to_all`` hand a CUDA
pointer to the socket, which fails (``writev: Bad address`` on the H100
machine).  So on a gloo group a CUDA tensor's point-to-point and
all-to-all exchanges are staged here through pinned host buffers: a copy
to the host, the exchange, a copy back.  The rule is the group's backend,
never a caught error.  :func:`stats` counts each operation's calls, bytes
sent, bytes staged and host seconds; :func:`record` lists the operations
this process issued, in order, so that tests can show that every rank
issues the same sequence.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..base import MXNetError
from .mesh import Mesh

__all__ = ["ppermute", "all_to_all", "psum", "pmean", "pvary",
           "all_gather", "reduce_scatter", "axis_slice", "gather_along",
           "scatter_sum_along", "axis_index", "axis_size", "stats",
           "reset_stats", "record", "global_batch_norm",
           "batch_stats_scope", "batch_stats_line"]

_STATS: Dict[str, Dict[str, float]] = {}
_RECORD: Optional[List[Tuple]] = None


def axis_index(axis: str, mesh: Mesh) -> int:
    """This rank's index along ``axis`` (``lax.axis_index``)."""
    return mesh.axis_index(axis)


def axis_size(axis: str, mesh: Mesh) -> int:
    """The number of ranks along ``axis`` (``lax.psum(1, axis)``)."""
    return mesh.axis_size(axis)


def stats() -> Dict[str, Dict[str, float]]:
    """Per operation: ``calls``, ``bytes`` (this rank's payload sent),
    ``staged_bytes`` (copied through the host) and ``seconds`` (host
    clock around the exchange; on a staged exchange it includes the copies
    and the waits for them)."""
    return {k: dict(v) for k, v in _STATS.items()}


def reset_stats() -> None:
    _STATS.clear()


class record:
    """``with record() as ops:`` lists, in issue order, every collective
    this process issues inside the block: (op, axis, shape, dtype)."""

    def __enter__(self) -> List[Tuple]:
        global _RECORD
        self._prev, _RECORD = _RECORD, []
        return _RECORD

    def __exit__(self, *exc) -> bool:
        global _RECORD
        _RECORD = self._prev
        return False


def _account(op: str, axis: str, x: torch.Tensor, staged: bool,
             seconds: float) -> None:
    nbytes = x.numel() * x.element_size()
    s = _STATS.setdefault(op, {"calls": 0, "bytes": 0, "staged_bytes": 0,
                               "seconds": 0.0})
    s["calls"] += 1
    s["bytes"] += nbytes
    s["staged_bytes"] += nbytes if staged else 0
    s["seconds"] += seconds
    if _RECORD is not None:
        _RECORD.append((op, axis, tuple(x.shape), str(x.dtype)))


def _staged(group, x: torch.Tensor) -> bool:
    """Whether a point-to-point or all-to-all exchange of ``x`` goes
    through the host: a CUDA tensor on a gloo group."""
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _to_host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)                      # waits for x's producers and the copy
    return h


def _from_host(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    out = torch.empty(h.shape, dtype=h.dtype, device=like.device)
    out.copy_(h, non_blocking=True)
    return out


def _line(mesh: Mesh, axis: str):
    return mesh.line(axis), mesh.group(axis), mesh.axis_index(axis)


def _shift(x: torch.Tensor, mesh, axis: str, shift: int) -> torch.Tensor:
    """Index i sends ``x`` to index i + shift and returns what index
    i - shift sent."""
    line, group, i = _line(mesh, axis)
    n = len(line)
    if n == 1 or shift % n == 0:
        return x.clone()
    t0 = time.perf_counter()
    x = x.contiguous()
    staged = _staged(group, x)
    send = _to_host(x) if staged else x
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, line[(i + shift) % n], group),
           dist.P2POp(dist.irecv, recv, line[(i - shift) % n], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = _from_host(recv, x) if staged else recv
    _account("ppermute", axis, x, staged, time.perf_counter() - t0)
    return out


def _exchange(x: torch.Tensor, mesh, axis: str, split_axis: int,
              concat_axis: int) -> torch.Tensor:
    """The tiled all-to-all: chunk j of ``split_axis`` to index j; the
    chunks received concatenated along ``concat_axis`` by source index."""
    line, group, _ = _line(mesh, axis)
    n = len(line)
    if n == 1:
        return x.clone()
    if x.shape[split_axis] % n:
        raise MXNetError("all_to_all: dimension %d (%d) does not split into "
                         "%d chunks over %r" % (split_axis,
                                                x.shape[split_axis], n, axis))
    t0 = time.perf_counter()
    chunks = x.chunk(n, dim=split_axis)
    # a group's ranks are numbered in ascending global rank; the line is
    # in axis order
    order = [line.index(r) for r in sorted(line)]
    inp = torch.stack([chunks[j] for j in order]).contiguous()
    staged = _staged(group, inp)
    send = _to_host(inp) if staged else inp
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    out = _from_host(recv, inp) if staged else recv
    pieces = [out[order.index(j)] for j in range(n)]
    _account("all_to_all", axis, inp, staged, time.perf_counter() - t0)
    return torch.cat(pieces, dim=concat_axis)


def _sum(x: torch.Tensor, mesh, axis: str, op: str = "psum"
         ) -> torch.Tensor:
    line, group, _ = _line(mesh, axis)
    out = x.clone()
    if len(line) > 1:
        t0 = time.perf_counter()
        dist.all_reduce(out, group=group)
        _account(op, axis, out, False, time.perf_counter() - t0)
    return out


def gather_along(x: torch.Tensor, mesh, axis: str, dim: int
                 ) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated along ``dim`` in
    axis order (no autograd)."""
    line, group, _ = _line(mesh, axis)
    n = len(line)
    if n == 1:
        return x.clone()
    t0 = time.perf_counter()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    # gloo's and NCCL's all_gather take CUDA tensors (gloo copies them
    # through the host itself); the list is in group order, which is
    # ascending global rank, and the line is in axis order
    dist.all_gather(parts, x, group=group)
    by_rank = dict(zip(sorted(line), parts))
    out = torch.cat([by_rank[r] for r in line], dim=dim)
    _account("all_gather", axis, x, False, time.perf_counter() - t0)
    return out


def scatter_sum_along(x: torch.Tensor, mesh, axis: str, dim: int
                      ) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of every rank's ``x``
    over ``axis`` (no autograd).  On NCCL one ``reduce_scatter_tensor``;
    gloo has no reduce-scatter for CUDA tensors, so on a gloo group it is
    an ``all_reduce`` and a slice (each rank moves the whole payload)."""
    line, group, i = _line(mesh, axis)
    n = len(line)
    if n == 1:
        return x.clone()
    if x.shape[dim] % n:
        raise MXNetError("reduce_scatter: dimension %d (%d) does not split "
                         "into %d over %r" % (dim, x.shape[dim], n, axis))
    t0 = time.perf_counter()
    if dist.get_backend(group) == dist.Backend.NCCL and \
            list(line) == sorted(line):
        moved = x.movedim(dim, 0).contiguous()
        out = torch.empty((moved.shape[0] // n,) + moved.shape[1:],
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, moved, group=group)
        out = out.movedim(0, dim).contiguous()
        _account("reduce_scatter", axis, x, False, time.perf_counter() - t0)
        return out
    full = x.contiguous().clone()
    dist.all_reduce(full, group=group)
    out = full.chunk(n, dim=dim)[i].contiguous()
    _account("reduce_scatter", axis, x, False, time.perf_counter() - t0)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, backward):
        ctx.args = mesh, axis, dim, backward
        return gather_along(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, backward = ctx.args
        if backward == "slice":
            n, i = mesh.axis_size(axis), mesh.axis_index(axis)
            out = g.chunk(n, dim=dim)[i].contiguous()
        else:
            out = scatter_sum_along(g, mesh, axis, dim)
        return out, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = mesh, axis, dim
        return scatter_sum_along(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return gather_along(g, mesh, axis, dim), None, None, None


class _AxisSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = mesh, axis, dim
        n, i = mesh.axis_size(axis), mesh.axis_index(axis)
        if x.shape[dim] % n:
            raise MXNetError("axis_slice: dimension %d (%d) does not split "
                             "into %d over %r" % (dim, x.shape[dim], n, axis))
        return x.chunk(n, dim=dim)[i].contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return gather_along(g, mesh, axis, dim), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _shift(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh, ctx.axis, -ctx.shift), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = mesh, axis, split_axis, concat_axis
        return _exchange(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_axis, concat_axis = ctx.args
        return (_exchange(g, mesh, axis, concat_axis, split_axis), None,
                None, None, None)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, scale):
        ctx.scale = scale
        out = _sum(x, mesh, axis)
        return out if scale == 1.0 else out.mul_(scale)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.scale == 1.0 else g * ctx.scale), None, None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous(), ctx.mesh, ctx.axis), None, None


def ppermute(x: torch.Tensor, axis: str, mesh: Mesh,
             shift: int = 1) -> torch.Tensor:
    """The cyclic shift ``lax.ppermute(x, axis, [(j, j + shift)])``."""
    return _PPermute.apply(x, mesh, axis, int(shift))


def all_to_all(x: torch.Tensor, axis: str, split_axis: int,
               concat_axis: int, mesh: Mesh) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``."""
    nd = x.dim()
    return _AllToAll.apply(x, mesh, axis, split_axis % nd, concat_axis % nd)


def psum(x: torch.Tensor, axis: str, mesh: Mesh) -> torch.Tensor:
    """The sum over ``axis``, held alike by every rank of it."""
    return _Psum.apply(x, mesh, axis, 1.0)


def pmean(x: torch.Tensor, axis: str, mesh: Mesh) -> torch.Tensor:
    """The mean over ``axis``, held alike by every rank of it."""
    return _Psum.apply(x, mesh, axis, 1.0 / mesh.axis_size(axis))


def all_gather(x: torch.Tensor, axis: str, dim: int, mesh: Mesh,
               backward: str = "slice") -> torch.Tensor:
    """Every rank's piece along ``dim``, in axis order; ``backward`` is
    ``"slice"`` (the whole value is used alike by every rank of the axis)
    or ``"reduce_scatter"`` (each rank's use is a partial: the batch is
    split over the axis)."""
    if backward not in ("slice", "reduce_scatter"):
        raise ValueError("all_gather: backward is 'slice' or "
                         "'reduce_scatter', not %r" % (backward,))
    return _AllGather.apply(x, mesh, axis, dim % x.dim(), backward)


def reduce_scatter(x: torch.Tensor, axis: str, dim: int,
                   mesh: Mesh) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum over ``axis``."""
    return _ReduceScatter.apply(x, mesh, axis, dim % x.dim())


def axis_slice(x: torch.Tensor, axis: str, dim: int,
               mesh: Mesh) -> torch.Tensor:
    """This rank's slice along ``dim`` of ``x``, held alike over
    ``axis``."""
    return _AxisSlice.apply(x, mesh, axis, dim % x.dim())


def pvary(x: torch.Tensor, axis: str, mesh: Mesh) -> torch.Tensor:
    """``x``, held alike over ``axis``, used by each rank on its own: the
    backward sums the ranks' cotangents."""
    return _Pvary.apply(x, mesh, axis)


# ---------------------------------------------------------------------------
# global batch statistics (the synchronised BatchNorm of the dp step)
# ---------------------------------------------------------------------------

_BN = threading.local()


class batch_stats_scope:
    """``with batch_stats_scope(mesh, axis):`` -- every ``nn.BatchNorm``
    that normalises by batch statistics inside the block normalises by
    those of the batch split over ``axis`` (:func:`global_batch_norm`).
    ``stats`` lists each such forward's (mean, biased variance) in call
    order."""

    def __init__(self, mesh: Mesh, axis: str):
        self.line = (mesh, axis)
        self.stats: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def __enter__(self) -> "batch_stats_scope":
        self._prev = getattr(_BN, "scope", None)
        _BN.scope = self
        return self

    def __exit__(self, *exc) -> bool:
        _BN.scope = self._prev
        return False


def batch_stats_line() -> Optional[batch_stats_scope]:
    """The innermost :class:`batch_stats_scope`, or None."""
    return getattr(_BN, "scope", None)


def _channel(t: torch.Tensor, ndim: int, ax: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[ax] = -1
    return t.reshape(shape)


class _GlobalBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, ax, mesh, axis):
        red = [i for i in range(x.dim()) if i != ax]
        # float32 at least, as the reference takes the statistics
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        n = x.numel() // x.shape[ax]
        s = _sum(torch.cat([xf.sum(red), xf.new_tensor([float(n)])]),
                 mesh, axis, "batch_norm")
        count = s[-1]
        mean = s[:-1] / count
        xc = xf - _channel(mean, x.dim(), ax)
        var = _sum((xc * xc).sum(red), mesh, axis, "batch_norm") / count
        invstd = torch.rsqrt(var + eps)
        xhat = xc * _channel(invstd, x.dim(), ax)
        out = xhat * _channel(gamma.to(xf.dtype), x.dim(), ax) + \
            _channel(beta.to(xf.dtype), x.dim(), ax)
        ctx.save_for_backward(xhat, invstd, gamma, count)
        ctx.ax, ctx.mesh, ctx.axis = ax, mesh, axis
        ctx.mark_non_differentiable(mean, var)
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, invstd, gamma, count = ctx.saved_tensors
        ax, nd = ctx.ax, xhat.dim()
        red = [i for i in range(nd) if i != ax]
        dyf = dy.to(xhat.dtype)
        sum_dy = dyf.sum(red)
        sum_dy_xhat = (dyf * xhat).sum(red)
        c = sum_dy.numel()
        both = _sum(torch.cat([sum_dy, sum_dy_xhat]), ctx.mesh, ctx.axis,
                    "batch_norm") / count
        dx = _channel(gamma.to(xhat.dtype) * invstd, nd, ax) * (
            dyf - _channel(both[:c], nd, ax)
            - xhat * _channel(both[c:], nd, ax))
        return (dx.to(dy.dtype), sum_dy_xhat.to(gamma.dtype),
                sum_dy.to(gamma.dtype), None, None, None, None)


def global_batch_norm(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, eps: float, axis_dim: int,
                      mesh: Mesh, axis: str):
    """BatchNorm's training output over ``x``, this rank's part of a
    batch split over mesh axis ``axis``, normalised by the whole batch's
    per-channel mean and biased variance (channels on ``axis_dim``);
    returns ``(out, mean, var)``, the statistics in float32 (float64 for
    float64 data) and without gradient.  Every rank of the axis must call it alike."""
    ax = axis_dim % x.dim()
    return _GlobalBatchNorm.apply(x, gamma, beta, float(eps), ax, mesh,
                                  axis)
