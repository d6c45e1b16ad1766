"""``nd.save`` / ``nd.load``: lists and dicts of NDArrays in the
reference's binary format.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py`` ``save_bytes`` /
``load_bytes`` / ``save`` / ``load`` (reference:
src/ndarray/ndarray.cc ``NDArray::Save`` / ``Load`` and
src/c_api/c_api.cc ``MXNDArraySave``), byte for byte:

* file: uint64 list magic ``0x112``, uint64 reserved (0), uint64 count,
  the arrays, uint64 name count, then each name as uint64 length + utf-8
  bytes (no names for a list);
* array: uint32 magic ``0xF993FAC9``, int32 storage type (0, dense),
  uint32 ndim and a uint32 per dimension, the saved context as two int32
  (1, 0: ``cpu(0)``), int32 mshadow type flag (:data:`DTYPE_TO_FLAG`),
  then the raw little-endian data.  bfloat16 (flag 12) is written as its
  16-bit patterns (``view(torch.int16)``), with no float round trip.

A file with the V1 magic ``0xF993FAC8`` (no storage type) or the V3 magic
``0xF993FACA`` loads too.  A row-sparse (1) or CSR (2) array in a file
raises: sparse storage is Queue 1 item 8.  A loaded array lands on the
current context, as the reference's do, in the dtype the port's arrays
hold for its flag (``base.NARROWED``: int64 as int32, uint64 as uint32;
float64 stays float64, which the port's arrays keep and the reference's
narrow to float32).  The port keeps its own copy of the constants and
imports nothing of the JAX package.
"""
from __future__ import annotations

import io
import struct
from typing import Callable, List

import torch

from ..base import MXNetError
from ..device import current_context
from .ndarray import NDArray, array

__all__ = ["save", "load", "save_bytes", "load_bytes", "DTYPE_TO_FLAG",
           "FLAG_TO_DTYPE"]

#: mshadow type flags (3rdparty/mshadow/mshadow/base.h ``TypeFlag``)
DTYPE_TO_FLAG = {
    torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.uint8: 3,
    torch.int32: 4, torch.int8: 5, torch.int64: 6, torch.bool: 7,
    torch.int16: 8, torch.uint16: 9, torch.uint32: 10, torch.uint64: 11,
    torch.bfloat16: 12,
}
FLAG_TO_DTYPE = {v: k for k, v in DTYPE_TO_FLAG.items()}

_LIST_MAGIC = 0x112
_NDARRAY_V1_MAGIC = 0xF993FAC8
_NDARRAY_V2_MAGIC = 0xF993FAC9
_NDARRAY_V3_MAGIC = 0xF993FACA
_SPARSE = {1: "row_sparse", 2: "csr"}


def _host(a: NDArray) -> torch.Tensor:
    """``a``'s data on the host, contiguous, in a type the format has
    (any other becomes float32, as the reference's writer casts it)."""
    t = a.data.detach()
    if t.dtype not in DTYPE_TO_FLAG:
        t = t.float()
    return t.contiguous().cpu()


def _raw(t: torch.Tensor) -> memoryview:
    """The bytes of a host tensor (a bf16 one as its 16-bit patterns)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return memoryview(t.numpy()).cast("B")


def _write_one(write: Callable, a: NDArray) -> None:
    if not isinstance(a, NDArray):
        raise TypeError("nd.save takes NDArrays, got %s" % type(a).__name__)
    t = _host(a)
    write(struct.pack("<Ii", _NDARRAY_V2_MAGIC, 0))    # dense storage
    write(struct.pack("<I", t.dim()))
    for d in t.shape:
        write(struct.pack("<I", d))
    write(struct.pack("<ii", 1, 0))                     # saved ctx cpu(0)
    write(struct.pack("<i", DTYPE_TO_FLAG[t.dtype]))
    write(_raw(t))


def _write(write: Callable, data) -> None:
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names, arrays = list(data.keys()), list(data.values())
    else:
        names, arrays = [], list(data)
    write(struct.pack("<QQQ", _LIST_MAGIC, 0, len(arrays)))
    for a in arrays:
        _write_one(write, a)
    write(struct.pack("<Q", len(names)))
    for n in names:
        nb = str(n).encode("utf-8")
        write(struct.pack("<Q", len(nb)))
        write(nb)


def save_bytes(data) -> bytes:
    """An NDArray, a list of them or a dict name -> NDArray (in key order)
    in the reference's file format."""
    buf = io.BytesIO()
    _write(buf.write, data)
    return buf.getvalue()


def save(fname: str, data) -> None:
    """Write :func:`save_bytes` of ``data`` to ``fname``, one array at a
    time."""
    with open(fname, "wb") as f:
        _write(f.write, data)


class _Reader:
    def __init__(self, raw):
        self.raw = raw
        self.pos = 0

    def take(self, fmt: str):
        vals = struct.unpack_from("<" + fmt, self.raw, self.pos)
        self.pos += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def tensor(self, dtype: torch.dtype, shape) -> torch.Tensor:
        """The next ``shape`` entries of ``dtype`` (a view of the
        buffer)."""
        count = 1
        for d in shape:
            count *= d
        wire = torch.int16 if dtype == torch.bfloat16 else dtype
        nbytes = count * wire.itemsize
        if self.pos + nbytes > len(self.raw):
            raise MXNetError("NDArray file is truncated: %d bytes needed "
                             "at offset %d, %d left" % (
                                 nbytes, self.pos, len(self.raw) - self.pos))
        t = torch.frombuffer(self.raw, dtype=wire, count=count,
                             offset=self.pos) if count else \
            torch.empty(0, dtype=wire)
        self.pos += nbytes
        return t.view(dtype).reshape(shape)


def _read_dense(r: _Reader) -> NDArray:
    shape = tuple(int(r.take("I")) for _ in range(r.take("I")))
    r.take("ii")                                        # saved ctx
    flag = r.take("i")
    if flag not in FLAG_TO_DTYPE:
        raise MXNetError("unknown type flag %d in NDArray file" % flag)
    return array(r.tensor(FLAG_TO_DTYPE[flag], shape),
                 ctx=current_context())


def _read_one(r: _Reader) -> NDArray:
    magic = r.take("I")
    if magic == _NDARRAY_V1_MAGIC:
        return _read_dense(r)
    if magic not in (_NDARRAY_V2_MAGIC, _NDARRAY_V3_MAGIC):
        raise MXNetError("invalid NDArray magic 0x%x" % magic)
    stype = r.take("i")
    if stype == 0:
        return _read_dense(r)
    if stype in _SPARSE:
        raise MXNetError("NDArray file holds a %s array: sparse storage is "
                         "Queue 1 item 8" % _SPARSE[stype])
    raise MXNetError("unknown storage type %d in file" % stype)


def load_bytes(raw):
    """The arrays of a file's bytes: a dict name -> NDArray when the file
    has names, else a list."""
    r = _Reader(raw if isinstance(raw, bytearray) else bytearray(raw))
    magic, _ = r.take("QQ")
    if magic != _LIST_MAGIC:
        raise MXNetError("invalid NDArray file magic")
    arrays: List[NDArray] = [_read_one(r) for _ in range(r.take("Q"))]
    n_names = r.take("Q")
    if n_names == 0:
        return arrays
    names = []
    for _ in range(n_names):
        ln = r.take("Q")
        names.append(bytes(r.raw[r.pos:r.pos + ln]).decode("utf-8"))
        r.pos += ln
    return dict(zip(names, arrays))


def load(fname: str):
    """:func:`load_bytes` of the file ``fname``."""
    with open(fname, "rb") as f:
        return load_bytes(bytearray(f.read()))
