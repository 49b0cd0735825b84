"""RecordIO — the reference's binary record container format.

Port of ``mxnet_tpu/recordio.py``: the same bytes and the same ``.idx``
text, so each package reads the other's files.  Reference surface:
``python/mxnet/recordio.py`` (``MXRecordIO``, ``MXIndexedRecordIO``,
``IRHeader``, ``pack/unpack/pack_img/unpack_img``)
backed by ``dmlc::RecordIOWriter/Reader`` in ``3rdparty/dmlc-core``
(SURVEY.md §3.1 "dmlc-core" row, anchor ``dmlc::RecordIOWriter``; §3.2
"io / recordio / image" row).

File layout (dmlc recordio, public format):

  record := uint32 kMagic(0xced7230a)
          | uint32 lrec          # upper 3 bits = cflag, lower 29 = length
          | data[length]
          | pad to 4-byte boundary

cflag encodes multi-part records for payloads that themselves contain the
magic; this writer always emits whole records (cflag=0) and the reader
reassembles split ones, matching dmlc semantics.

The reference reads through its native C++ library when one is built;
that library is not ported (ROADMAP "Not queued"), so this pure-Python
reader is the port's only one.
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple

import numpy as onp

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img"]

_KMAGIC = 0xCED7230A
_CFLAG_BITS = 29
_LEN_MASK = (1 << _CFLAG_BITS) - 1


def _encode_lrec(cflag: int, length: int) -> int:
    return (cflag << _CFLAG_BITS) | length


def _decode_lrec(lrec: int):
    return lrec >> _CFLAG_BITS, lrec & _LEN_MASK


class MXRecordIO:
    """Sequential reader/writer for ``.rec`` files.

    Matches the reference API: ``open/close/reset/write/read/tell/seek``
    (seek only on readers via byte offsets, as used by the indexed variant).
    """

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        self.record = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError(f"Invalid flag {self.flag!r}")
        self.is_open = True

    def close(self):
        if self.is_open:
            self.record.close()
            self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def reset(self):
        self.close()
        self.open()

    def tell(self) -> int:
        return self.record.tell()

    def seek(self, pos: int):
        if self.writable:
            raise MXNetError("seek only supported on readers")
        self.record.seek(pos)

    def write(self, buf: bytes):
        if not self.writable:
            raise MXNetError("not opened for writing")
        if not isinstance(buf, (bytes, bytearray, memoryview)):
            raise MXNetError("write expects bytes")
        self.record.write(struct.pack("<II", _KMAGIC,
                                      _encode_lrec(0, len(buf))))
        self.record.write(buf)
        pad = (-len(buf)) % 4
        if pad:
            self.record.write(b"\x00" * pad)

    def read(self):
        """Read the next record; ``None`` at EOF."""
        if self.writable:
            raise MXNetError("not opened for reading")
        parts = []
        while True:
            head = self.record.read(8)
            if len(head) < 8:
                if parts:
                    raise MXNetError("truncated multi-part record")
                return None
            magic, lrec = struct.unpack("<II", head)
            if magic != _KMAGIC:
                raise MXNetError(f"bad record magic {magic:#x}")
            cflag, length = _decode_lrec(lrec)
            data = self.record.read(length)
            if len(data) < length:
                raise MXNetError("truncated record payload")
            self.record.read((-length) % 4)
            parts.append(data)
            # dmlc cflag: 0 whole, 1 first-of-many, 2 middle, 3 last
            if cflag == 0:
                return data
            if cflag == 3:
                return b"".join(parts)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access reader/writer using a sidecar ``.idx`` text file
    (``key\\tbyte_offset`` per line, the reference's im2rec layout)."""

    def __init__(self, idx_path: str, uri: str, flag: str,
                 key_type: type = int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.isfile(self.idx_path):
            with open(self.idx_path) as f:
                for line in f:
                    line = line.strip().split("\t")
                    if len(line) < 2:
                        continue
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)
        elif self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def read_idx(self, idx):
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf: bytes):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{key}\t{pos}\n")
        self.idx[key] = pos
        self.keys.append(key)


# --------------------------------------------------------------------- #
# IRHeader packing (image records)
# --------------------------------------------------------------------- #
IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    """Pack a string payload with an ``IRHeader``.  If ``header.label`` is an
    array, ``flag`` is set to its length and the float32 label vector is
    written between header and payload (reference ``recordio.pack``)."""
    header = IRHeader(*header)
    label = header.label
    if isinstance(label, (list, tuple)) or hasattr(label, "ndim"):
        label = onp.asarray(label, dtype=onp.float32)
        header = header._replace(flag=label.size, label=0.0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, int(header.flag), float(header.label),
                       int(header.id), int(header.id2)) + s


def unpack(s: bytes):
    """Inverse of :func:`pack` → ``(IRHeader, payload_bytes)``."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = onp.frombuffer(s[:4 * header.flag], dtype=onp.float32)
        header = header._replace(label=label)
        s = s[4 * header.flag:]
    return header, s


def pack_img(header: IRHeader, img, quality: int = 95,
             img_fmt: str = ".jpg") -> bytes:
    """Encode an HWC uint8 image array and pack it (reference
    ``recordio.pack_img``; OpenCV, else PIL)."""
    from .image import imencode
    return pack(header, imencode(img, quality=quality, img_fmt=img_fmt))


def unpack_img(s: bytes, iscolor: int = -1):
    """→ ``(IRHeader, HWC uint8 numpy image)``."""
    from .image import imdecode_np
    header, img_bytes = unpack(s)
    return header, imdecode_np(img_bytes, iscolor=iscolor)
