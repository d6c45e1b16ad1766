"""Fusion buckets: the gradient exchange coalesced into a few flat
payloads.

Counterpart of ``mxnet_tpu/kvstore/bucketing.py``.  A deterministic planner
puts small dense keys into flat buckets of one dtype each, of up to
``MX_KVSTORE_BUCKET_KB`` (default 4 MB), so a step does a few bucket
collectives instead of one for each parameter.

The layout is a pure function of the ordered ``(key, shape, dtype)``
descriptors and the byte cap, so every rank derives the same key->bucket
mapping without talking to the others.  A bucket's name carries a CRC of
its members' ``key:shape:dtype`` descriptors: a change of any member
renames the bucket, and with it the error-feedback residual kept under
that name.  A dtype is described by its numpy name (``float32``,
``bfloat16``), never by torch's, so the names are the JAX package's.
Values over the cap stay solo.
"""
from __future__ import annotations

import zlib
from typing import Callable, Dict, List, Sequence, Set, Tuple

import torch

from ..base import get_env

__all__ = ["Bucket", "bucket_bytes", "plan_buckets", "ReadinessPlanner"]


def bucket_bytes() -> int:
    """The bucket capacity in bytes (``MX_KVSTORE_BUCKET_KB``); 0 turns
    buckets off."""
    return max(0, int(get_env("MX_KVSTORE_BUCKET_KB", 4096, int))) * 1024


class Bucket:
    """One fusion bucket: the slice layout of its member keys in one flat
    payload."""

    __slots__ = ("name", "positions", "keys", "offsets", "sizes", "shapes",
                 "dtype", "total")

    def __init__(self, index: int, positions: Sequence[int],
                 keys: Sequence, sizes: Sequence[int],
                 shapes: Sequence[Tuple[int, ...]], dtype: str):
        self.positions = list(positions)     # indices into the caller's keys
        self.keys = list(keys)
        self.sizes = list(sizes)
        self.shapes = [tuple(s) for s in shapes]
        self.dtype = dtype
        self.offsets = []
        off = 0
        for n in self.sizes:
            self.offsets.append(off)
            off += n
        self.total = off
        desc = ";".join("%s:%s:%s" % (k, "x".join(map(str, s)), dtype)
                        for k, s in zip(self.keys, self.shapes))
        self.name = "__fusedb%d_%08x" % (index, zlib.crc32(desc.encode()))

    def slices(self):
        """(position, offset, size, shape) of each member, in layout
        order."""
        return zip(self.positions, self.offsets, self.sizes, self.shapes)

    def exchange(self, members: Sequence[torch.Tensor],
                 collective: Callable) -> List[torch.Tensor]:
        """Exchange ``members`` (the tensors of :attr:`positions`, in that
        order) as one flat payload: ``collective(flat)`` returns the
        exchanged payload (it may work in place: ``flat`` is the bucket's
        own), and each member comes back as a view of it in its shape."""
        flat = collective(torch.cat([m.reshape(-1) for m in members]))
        return [flat[off:off + size].view(shape) for off, size, shape
                in zip(self.offsets, self.sizes, self.shapes)]

    def __repr__(self):
        return "Bucket(%s, n=%d, total=%d, %s)" % (
            self.name, len(self.keys), self.total, self.dtype)


def plan_buckets(keys: Sequence, shapes: Sequence[Tuple[int, ...]],
                 dtypes: Sequence[str], itemsizes: Sequence[int],
                 stypes: Sequence[str], max_bytes: int,
                 reverse: bool = False):
    """Greedy first fit in key order, one dtype a bucket: ``(buckets,
    solo_positions)``.  Sparse values, values over the cap and a dtype's
    lone member stay solo.

    ``reverse=True`` packs in reverse key order: backward gives the last
    layers' gradients first, so their buckets are the first to fill and
    the overlap scheduler (:class:`ReadinessPlanner`) can launch them
    while earlier layers are still being differentiated.
    """
    solo: List[int] = []
    open_by_dtype = {}    # dtype -> (positions, nbytes)
    closed: List[List[int]] = []

    def close(dtype):
        poss, _ = open_by_dtype.pop(dtype)
        if len(poss) > 1:
            closed.append(poss)
        else:
            solo.extend(poss)

    indices = range(len(shapes) - 1, -1, -1) if reverse \
        else range(len(shapes))
    for pos in indices:
        shape, dtype, isz, stype = (shapes[pos], dtypes[pos],
                                    itemsizes[pos], stypes[pos])
        size = 1
        for d in shape:
            size *= int(d)
        nbytes = size * int(isz)
        if stype != "default" or max_bytes <= 0 or nbytes > max_bytes:
            solo.append(pos)
            continue
        poss, used = open_by_dtype.get(dtype, ([], 0))
        if poss and used + nbytes > max_bytes:
            close(dtype)
            poss, used = [], 0
        poss.append(pos)
        open_by_dtype[dtype] = (poss, used + nbytes)
    for dtype in list(open_by_dtype):
        close(dtype)

    buckets = []
    order_key = (lambda p: -p[0]) if reverse else (lambda p: p[0])
    for bi, poss in enumerate(sorted(closed, key=order_key)):
        sizes = []
        for p in poss:
            n = 1
            for d in shapes[p]:
                n *= int(d)
            sizes.append(n)
        buckets.append(Bucket(bi, poss, [keys[p] for p in poss], sizes,
                              [shapes[p] for p in poss],
                              str(dtypes[poss[0]])))
    return buckets, sorted(solo)


class ReadinessPlanner:
    """Overlap scheduling: close an exchange *unit* (a fusion bucket or a
    solo key) the moment its last member's gradient is final.

    ``note(pos)`` records one position's gradient and returns the units
    that just closed, which the caller launches at once.  A position with
    several copies closes when every copy has landed.  A second event for
    a position already complete (a second backward, ``grad_req='add'``)
    sets :attr:`stale`: the caller relaunches every unit at drain, since
    launched exchanges read values that have changed since.
    """

    def __init__(self, buckets: Sequence[Bucket], solo: Sequence[int],
                 copies: int = 1):
        self._units: List = [("bucket", b) for b in buckets] + \
            [("solo", int(p)) for p in solo]
        self._unit_of_pos: Dict[int, int] = {}
        self._remaining: List[int] = []
        for u, (kind, obj) in enumerate(self._units):
            members = obj.positions if kind == "bucket" else [obj]
            self._remaining.append(len(members))
            for p in members:
                self._unit_of_pos[int(p)] = u
        self._copies = max(1, int(copies))
        self._seen: Dict[int, Set[int]] = {}
        self._closed: List[bool] = [False] * len(self._units)
        self.stale = False

    def __len__(self):
        return len(self._units)

    def unit(self, u: int):
        """(kind, obj): ('bucket', Bucket) or ('solo', position)."""
        return self._units[u]

    def note(self, pos: int, copy: int = 0) -> List[int]:
        """Record that copy ``copy`` of ``pos``'s gradient is final;
        returns the units this event closed (usually [] or [u])."""
        u = self._unit_of_pos.get(int(pos))
        if u is None:
            return []
        seen = self._seen.setdefault(int(pos), set())
        if self._closed[u] or copy in seen:
            self.stale = True
            return []
        seen.add(copy)
        if len(seen) < self._copies:
            return []
        self._remaining[u] -= 1
        if self._remaining[u] == 0:
            self._closed[u] = True
            return [u]
        return []

    def pending(self) -> List[int]:
        """The units not closed yet (drain launches these)."""
        return [u for u, c in enumerate(self._closed) if not c]

    def all_units(self) -> List[int]:
        return list(range(len(self._units)))
