"""mx.recordio: the .rec/.idx container.

Counterpart of ``mxnet_tpu/recordio.py`` (reference:
python/mxnet/recordio.py: MXRecordIO, MXIndexedRecordIO, IRHeader,
pack/unpack/pack_img/unpack_img over dmlc-core's recordio.h).  The same
bytes as the reference's files, both ways: every record is the magic
``0xced7230a``, ``(cflag << 29) | length`` and the payload padded to 4
bytes, and a payload that embeds the magic is split into chunks at it.
The parser is the native C++ of ``src/recordio.cc``, built by the port's
own loader (:mod:`._native`); a pure-Python reader and writer of the same
format take over when no compiler is available.  Corrupt records raise
``OSError`` naming the file and byte offset, or, with
``MX_RECORDIO_TOLERATE_CORRUPT=1``, are skipped and counted.  Image
payloads (``pack_img``/``unpack_img``) use PIL, the role OpenCV plays in
the reference.
"""
from __future__ import annotations

import ctypes
import io as _io
import numbers
import os
import struct
import threading
import warnings
from collections import namedtuple

import numpy as _np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img"]

_MAGIC = 0xced7230a


def _native():
    try:
        from . import _native
        lib = _native.load("recordio")
    except OSError:
        return None
    lib.MXRecordIOWriterCreate.restype = ctypes.c_void_p
    lib.MXRecordIOWriterCreate.argtypes = [ctypes.c_char_p]
    lib.MXRecordIOWriterWrite.restype = ctypes.c_int64
    lib.MXRecordIOWriterWrite.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_uint64]
    lib.MXRecordIOWriterTell.restype = ctypes.c_int64
    lib.MXRecordIOWriterTell.argtypes = [ctypes.c_void_p]
    lib.MXRecordIOWriterClose.argtypes = [ctypes.c_void_p]
    lib.MXRecordIOReaderCreate.restype = ctypes.c_void_p
    lib.MXRecordIOReaderCreate.argtypes = [ctypes.c_char_p]
    lib.MXRecordIOReaderNext.restype = ctypes.c_int
    lib.MXRecordIOReaderNext.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_char_p),
                                         ctypes.POINTER(ctypes.c_uint64)]
    lib.MXRecordIOReaderSeek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.MXRecordIOReaderTell.restype = ctypes.c_int64
    lib.MXRecordIOReaderTell.argtypes = [ctypes.c_void_p]
    lib.MXRecordIOReaderClose.argtypes = [ctypes.c_void_p]
    return lib


_LIB = None
_LIB_TRIED = False


def _get_lib():
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB = _native()
        _LIB_TRIED = True
    return _LIB


class MXRecordIO:
    """Sequential .rec reader/writer (reference: MXRecordIO)."""

    def __init__(self, uri: str, flag: str):
        if flag not in ("r", "w"):
            raise ValueError("flag must be 'r' or 'w'")
        self.uri = uri
        self.flag = flag
        self.is_open = False
        self._handle = None
        self._lib = None      # pinned per instance so close() survives
        self._pyfile = None   # python fallback
        self._read_lock = threading.Lock()
        self.corrupt_skipped = 0   # records dropped under tolerate mode
        self._corrupt_eof = False  # tolerated damage: reads report EOF
        self.open()

    # -- lifecycle ----------------------------------------------------------
    def open(self):
        self._lib = _get_lib()
        if self._lib is not None:
            if self.flag == "w":
                self._handle = self._lib.MXRecordIOWriterCreate(
                    self.uri.encode())
            else:
                self._handle = self._lib.MXRecordIOReaderCreate(
                    self.uri.encode())
            if not self._handle:
                raise OSError("cannot open %r" % self.uri)
        else:
            self._pyfile = open(self.uri, "wb" if self.flag == "w" else "rb")
        self._corrupt_eof = False     # reset()/reopen clears the latch
        self.is_open = True

    def close(self):
        if not self.is_open:
            return
        if self._handle is not None and self._lib is not None:
            if self.flag == "w":
                self._lib.MXRecordIOWriterClose(self._handle)
            else:
                self._lib.MXRecordIOReaderClose(self._handle)
            self._handle = None
        if self._pyfile is not None:
            self._pyfile.close()
            self._pyfile = None
        self.is_open = False

    def reset(self):
        """Reopen at the beginning (reference: MXRecordIO.reset)."""
        self.close()
        self.open()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass  # interpreter shutdown: module globals may be gone

    def __getstate__(self):
        """Readers are picklable for multiprocess DataLoader workers —
        the handle is dropped and each process reopens on unpickle
        (reference: recordio reopening across _MultiWorkerIter forks).
        Writers hold buffered state and must not cross processes."""
        if self.flag != "r":
            raise RuntimeError("MXRecordIO writers are not picklable")
        state = self.__dict__.copy()
        state["_handle"] = None
        state["_lib"] = None
        state["_pyfile"] = None
        state["is_open"] = False
        state.pop("_read_lock", None)     # locks do not pickle
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._read_lock = threading.Lock()
        self.open()

    # -- IO ------------------------------------------------------------------
    def write(self, buf: bytes) -> None:
        assert self.flag == "w"
        if self._handle is not None:
            pos = self._lib.MXRecordIOWriterWrite(self._handle, buf,
                                                  len(buf))
            if pos < 0:
                raise OSError("recordio write failed")
            self._last_pos = pos
        else:
            self._last_pos = self._py_write(buf)

    def read(self):
        """Next record payload as bytes, or None at EOF."""
        assert self.flag == "r"
        if self._corrupt_eof:
            # a tolerated corruption ended this pass: stay EOF (and keep
            # the count stable) instead of re-detecting the same damage
            # on every subsequent call — reset() clears the latch
            return None
        if self._handle is not None:
            data = ctypes.c_char_p()
            size = ctypes.c_uint64()
            rc = self._lib.MXRecordIOReaderNext(
                self._handle, ctypes.byref(data), ctypes.byref(size))
            if rc == 1:
                return None
            if rc != 0:
                return self._corrupt_record(
                    self._lib.MXRecordIOReaderTell(self._handle),
                    "corrupt record")
            return ctypes.string_at(data, size.value)
        return self._py_read()

    def _corrupt_record(self, offset: int, why: str):
        """Corruption policy, shared by both reader backends.

        The classic damage is a tail record cut short by a mid-write
        crash; default is a loud OSError naming the uri and byte offset
        so the operator knows exactly what to truncate or re-pack.
        With ``MX_RECORDIO_TOLERATE_CORRUPT=1`` the damaged record is
        skipped-and-counted (``self.corrupt_skipped``) and the read
        reports EOF — resuming a job over the damaged file keeps every
        intact record before the tear."""
        from .base import get_env
        if get_env("MX_RECORDIO_TOLERATE_CORRUPT", dtype=bool):
            self.corrupt_skipped += 1
            warnings.warn(
                "recordio: skipping %s in %r at byte offset %d "
                "(MX_RECORDIO_TOLERATE_CORRUPT=1; %d skipped so far)"
                % (why, self.uri, offset, self.corrupt_skipped))
            self._corrupt_eof = True         # damaged tail: stop here
            if self._pyfile is not None:
                self._pyfile.seek(0, 2)
            return None
        raise OSError(
            "%s in recordio file %r at byte offset %d (set "
            "MX_RECORDIO_TOLERATE_CORRUPT=1 to skip damaged records, "
            "e.g. a tail torn by a mid-write crash)"
            % (why, self.uri, offset))

    def tell(self) -> int:
        if self._handle is not None:
            if self.flag == "w":
                return self._lib.MXRecordIOWriterTell(self._handle)
            return self._lib.MXRecordIOReaderTell(self._handle)
        return self._pyfile.tell()

    # -- pure-python fallback (same wire format) -----------------------------
    def _py_write(self, buf: bytes) -> int:
        f = self._pyfile
        pos = f.tell()
        magic_bytes = struct.pack("<I", _MAGIC)
        # split on embedded magics like the native writer
        chunks = []
        start = 0
        while True:
            hit = buf.find(magic_bytes, start)
            if hit < 0:
                chunks.append(buf[start:])
                break
            chunks.append(buf[start:hit])
            start = hit + 4
        for i, chunk in enumerate(chunks):
            if len(chunks) == 1:
                cflag = 0
            elif i == 0:
                cflag = 1
            elif i == len(chunks) - 1:
                cflag = 3
            else:
                cflag = 2
            lrec = (cflag << 29) | len(chunk)
            f.write(magic_bytes)
            f.write(struct.pack("<I", lrec))
            f.write(chunk)
            pad = (4 - (len(chunk) & 3)) & 3
            f.write(b"\x00" * pad)
        return pos

    def _py_read(self):
        f = self._pyfile
        start = f.tell()             # record start: reported on damage
        out = []
        in_multi = False
        while True:
            head = f.read(4)
            if not head and not in_multi:
                return None          # clean EOF on a record boundary
            if len(head) != 4:
                return self._corrupt_record(
                    start, "truncated record header (mid-write tear)")
            if struct.unpack("<I", head)[0] != _MAGIC:
                return self._corrupt_record(
                    start, "corrupt record header (bad magic)")
            lenb = f.read(4)
            if len(lenb) != 4:
                return self._corrupt_record(
                    start, "truncated record length field")
            lrec = struct.unpack("<I", lenb)[0]
            cflag, clen = lrec >> 29, lrec & ((1 << 29) - 1)
            if in_multi:
                out.append(struct.pack("<I", _MAGIC))
            data = f.read(clen)
            if len(data) != clen:
                return self._corrupt_record(
                    start, "truncated record payload (%d of %d bytes)"
                    % (len(data), clen))
            f.read((4 - (clen & 3)) & 3)
            out.append(data)
            if cflag in (0, 3):
                return b"".join(out)
            in_multi = True


class MXIndexedRecordIO(MXRecordIO):
    """Random-access .rec via a .idx sidecar of ``key\\toffset`` lines
    (reference: MXIndexedRecordIO — what ImageRecordIter seeks with)."""

    def __init__(self, idx_path: str, uri: str, flag: str,
                 key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if flag == "r" and os.path.isfile(idx_path):
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) != 2:
                        continue
                    key = key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if self.flag == "w" and self.is_open:
            with open(self.idx_path, "w") as f:
                for key in self.keys:
                    f.write("%s\t%d\n" % (key, self.idx[key]))
        super().close()

    def seek(self, idx):
        assert self.flag == "r"
        # the corrupt-EOF latch is a sequential-pass concept; a seek
        # repositions the stream, so one tolerated bad record must not
        # swallow every other (intact) record of a random-access pass
        self._corrupt_eof = False
        pos = self.idx[idx]
        if self._handle is not None:
            self._lib.MXRecordIOReaderSeek(self._handle, pos)
        else:
            self._pyfile.seek(pos)

    def read_idx(self, idx):
        # seek+read must be atomic: DataLoader's thread_pool path (and any
        # user threads) share one reader, and an interleaved seek silently
        # returns the WRONG record
        with self._read_lock:
            self.seek(idx)
            return self.read()

    def write_idx(self, idx, buf: bytes):
        assert self.flag == "w"
        self.write(buf)
        self.idx[idx] = self._last_pos
        self.keys.append(idx)


# -- IRHeader + pack/unpack ---------------------------------------------------

IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    """Serialize header+payload (reference: recordio.pack).  ``flag`` > 0
    means the label is a vector of ``flag`` floats prepended to the
    payload."""
    label = header.label
    if not isinstance(label, numbers.Number):
        label = _np.asarray(label, dtype=_np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, header.flag, header.label, header.id,
                       header.id2) + s


def unpack(s: bytes):
    """Inverse of pack → (IRHeader, payload bytes)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = _np.frombuffer(s[:header.flag * 4], dtype=_np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header: IRHeader, img, quality: int = 95,
             img_fmt: str = ".jpg") -> bytes:
    """Encode an HWC uint8 image (numpy or NDArray) into a packed record
    (reference: recordio.pack_img; PIL plays OpenCV's role)."""
    from PIL import Image
    if hasattr(img, "asnumpy"):
        img = img.asnumpy()
    img = _np.asarray(img, dtype=_np.uint8)
    pil = Image.fromarray(img)
    buf = _io.BytesIO()
    fmt = img_fmt.lstrip(".").upper()
    if fmt in ("JPG", "JPEG"):
        pil.save(buf, format="JPEG", quality=quality)
    elif fmt == "PNG":
        pil.save(buf, format="PNG")
    else:
        raise ValueError("unsupported img_fmt %r" % img_fmt)
    return pack(header, buf.getvalue())


def unpack_img(s: bytes, iscolor=1):
    """Inverse of pack_img → (IRHeader, HWC uint8 ndarray)."""
    from PIL import Image
    header, payload = unpack(s)
    pil = Image.open(_io.BytesIO(payload))
    if iscolor == 0:
        pil = pil.convert("L")
    elif pil.mode != "RGB":
        pil = pil.convert("RGB")
    return header, _np.asarray(pil)
