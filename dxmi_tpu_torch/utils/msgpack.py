"""A standard-library reader of flax's msgpack checkpoints.

``msgpack_restore(data)`` returns what ``flax.serialization.msgpack_restore``
returns for the same bytes: the msgpack document as nested dicts, lists
and scalars (nil, bool, every int and uint width, float32 and float64, str,
bin as ``bytes``, array as ``list``, map as ``dict``), with flax's ext types
(``flax/serialization.py`` ``_MsgpackExtType``) decoded:

- 1, ndarray: a packed ``(shape, dtype name, C-order bytes)``, returned as a
  numpy array (``bfloat16``, which numpy lacks, as a ``torch.bfloat16``
  tensor of the same shape and bits);
- 2, native complex: a packed ``(real, imag)``, returned as ``complex``;
- 3, numpy scalar: an ndarray payload, returned as its 0-d element (a
  numpy scalar; a 0-d ``torch.bfloat16`` tensor for bfloat16).

Other ext codes come back as ``ExtType(code, data)``, as msgpack's own
reader returns them. A leaf that flax split into chunks
(``__msgpack_chunked_array__``, arrays above 2^30 bytes) is reassembled as
flax's ``_unchunk_array_leaves_in_place`` does. Truncated input or bytes
after the document raise ``ValueError``. The port reads checkpoints with
this module alone: the card has no ``msgpack`` package.
"""
from __future__ import annotations

import struct
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class ExtType(NamedTuple):
    """An ext value of a code that flax does not define."""
    code: int
    data: bytes


# fixed-width scalars: first byte -> struct format
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# length-prefixed str, bin and ext, arrays and maps: first byte -> width of
# the length field
_STR = {0xd9: 1, 0xda: 2, 0xdb: 4}
_BIN = {0xc4: 1, 0xc5: 2, 0xc6: 4}
_EXT = {0xc7: 1, 0xc8: 2, 0xc9: 4}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_ARRAY = {0xdc: 2, 0xdd: 4}
_MAP = {0xde: 2, 0xdf: 4}
_UINT = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack: truncated input ({n} bytes wanted at "
                             f"offset {self.pos} of {len(self.buf)})")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def length(self, width: int) -> int:
        return struct.unpack(_UINT[width], self.take(width))[0]

    def text(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def ext(self, code: int, n: int) -> Any:
        return _ext(code, bytes(self.take(n)))

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.text(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SCALARS:
            fmt = _SCALARS[b]
            return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]
        if b in _STR:
            return self.text(self.length(_STR[b]))
        if b in _BIN:
            return bytes(self.take(self.length(_BIN[b])))
        if b in _EXT:
            n = self.length(_EXT[b])
            return self.ext(struct.unpack(">b", self.take(1))[0], n)
        if b in _FIXEXT:
            return self.ext(struct.unpack(">b", self.take(1))[0], _FIXEXT[b])
        if b in _ARRAY:
            return [self.value() for _ in range(self.length(_ARRAY[b]))]
        if b in _MAP:
            return self.map(self.length(_MAP[b]))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at offset "
                         f"{self.pos - 1}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data) -> Any:
    """One msgpack document from ``data``, with flax's ext types decoded;
    raises ``ValueError`` on truncated input and on bytes after the
    document."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes after the "
                         "document")
    return out


def _ndarray(data: bytes):
    """flax's ``_ndarray_from_bytes``: (shape, dtype name, bytes)."""
    shape, name, buf = unpackb(data)
    shape = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"msgpack: array dtype {name!r} is not readable "
                         "without its package") from e
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def _ext(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_COMPLEX:
        re_, im = unpackb(data)
        return complex(re_, im)
    if code == EXT_NPSCALAR:
        arr = _ndarray(data)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    return ExtType(code, data)


def _ordered(d: dict) -> Tuple[Any, ...]:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(d: dict):
    """flax's ``_unchunk``: the chunks concatenated, in the stored shape."""
    shape, chunks = _ordered(d["shape"]), _ordered(d["chunks"])
    if chunks and isinstance(chunks[0], torch.Tensor):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d: Any) -> Any:
    """flax's ``_unchunk_array_leaves_in_place``: a chunked leaf at the top
    or anywhere down a chain of dicts is reassembled."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            d[k] = _unchunk_leaves(v)
    return d


def msgpack_restore(data) -> Any:
    """``flax.serialization.msgpack_restore`` without flax or msgpack."""
    return _unchunk_leaves(unpackb(data))


def read(path: str) -> Any:
    """The tree of a flax msgpack file."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
