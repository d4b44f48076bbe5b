"""A standard-library reader and writer of flax's msgpack checkpoints.

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
after the document raise ``ValueError``.

``msgpack_serialize(tree)`` returns the bytes that
``flax.serialization.msgpack_serialize`` writes for the same tree: dicts
(their keys sorted, as flax's ``tree_map`` copy sorts them), lists, nil, bool, int, float (as float64), str and
bytes in msgpack's shortest encodings, numpy arrays and torch tensors
(``bfloat16`` included) as the ndarray ext type and numpy scalars as the
scalar ext type; an array above ``MAX_CHUNK_SIZE`` bytes that is the tree or
a value of a chain of dicts is split into flax's chunked form first. As
flax packs with ``strict_types``, a tuple raises ``TypeError``. The port
reads and writes checkpoints with this module alone: the card has no
``msgpack`` package.
"""
from __future__ import annotations

import os
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


# flax's MAX_CHUNK_SIZE: arrays above it are stored in chunks of this many
# bytes (msgpack caps an object at 2^31 - 1 bytes)
MAX_CHUNK_SIZE = 2 ** 30


def _length(out: bytearray, n: int, small: int, fix: int,
            wide: Tuple[Tuple[int, int, str], ...]) -> None:
    """A length header: ``fix | n`` below ``small``, else the first of
    ``wide``'s (limit, type byte, struct format) that holds ``n``."""
    if n < small:
        out.append(fix | n)
        return
    for limit, code, fmt in wide:
        if n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


_STR_W = ((0xff, 0xd9, ">B"), (0xffff, 0xda, ">H"),
          (0xffffffff, 0xdb, ">I"))
_BIN_W = ((0xff, 0xc4, ">B"), (0xffff, 0xc5, ">H"),
          (0xffffffff, 0xc6, ">I"))
_ARR_W = ((0xffff, 0xdc, ">H"), (0xffffffff, 0xdd, ">I"))
_MAP_W = ((0xffff, 0xde, ">H"), (0xffffffff, 0xdf, ">I"))
_FIXEXT_CODE = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
_EXT_W = ((0xff, 0xc7, ">B"), (0xffff, 0xc8, ">H"),
          (0xffffffff, 0xc9, ">I"))


def _int(out: bytearray, v: int) -> None:
    """msgpack's shortest integer encoding, as msgpack-python packs it."""
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif 0 <= v:
        for limit, code, fmt in ((0xff, 0xcc, ">B"), (0xffff, 0xcd, ">H"),
                                 (0xffffffff, 0xce, ">I"),
                                 (0xffffffffffffffff, 0xcf, ">Q")):
            if v <= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: int {v} too large")
    else:
        for limit, code, fmt in ((-0x80, 0xd0, ">b"), (-0x8000, 0xd1, ">h"),
                                 (-0x80000000, 0xd2, ">i"),
                                 (-0x8000000000000000, 0xd3, ">q")):
            if v >= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: int {v} too small")


def _array_parts(a) -> Tuple[Tuple[int, ...], str, bytes]:
    """(shape, dtype name, C-order bytes) of a numpy array or torch tensor,
    flax's ``_ndarray_to_bytes`` triple (``bfloat16`` by name)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        if a.dtype == torch.bfloat16:
            return (tuple(a.shape), "bfloat16",
                    a.view(torch.int16).numpy().tobytes())
        a = a.numpy()
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes are not "
                         "serialisable")
    return a.shape, a.dtype.name, a.tobytes("C")


def _ext_out(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    if n in _FIXEXT_CODE:
        out.append(_FIXEXT_CODE[n])
    else:
        _length(out, n, 0, 0, _EXT_W)
    out += struct.pack(">b", code) + data


def _pack(out: bytearray, x: Any) -> None:
    t = type(x)
    if x is None:
        out.append(0xc0)
    elif t is bool:
        out.append(0xc3 if x else 0xc2)
    elif t is int:
        _int(out, x)
    elif t is float:
        out.append(0xcb)
        out += struct.pack(">d", x)
    elif t is str:
        raw = x.encode("utf-8")
        _length(out, len(raw), 32, 0xa0, _STR_W)
        out += raw
    elif t in (bytes, bytearray, memoryview):
        raw = bytes(x)
        _length(out, len(raw), 0, 0, _BIN_W)
        out += raw
    elif t is dict:
        _length(out, len(x), 16, 0x80, _MAP_W)
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif t is list:
        _length(out, len(x), 16, 0x90, _ARR_W)
        for v in x:
            _pack(out, v)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _ext_out(out, EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.generic):
        _ext_out(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    elif t is complex:
        inner = bytearray()
        _length(inner, 2, 16, 0x90, _ARR_W)
        _pack(inner, x.real)
        _pack(inner, x.imag)
        _ext_out(out, EXT_COMPLEX, bytes(inner))
    else:
        raise TypeError(f"msgpack: can not serialize {t.__name__!r} object")


def _ndarray_bytes(a) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``packb((shape, name, bytes))``."""
    shape, name, raw = _array_parts(a)
    out = bytearray()
    _length(out, 3, 16, 0x90, _ARR_W)
    _length(out, len(shape), 16, 0x90, _ARR_W)
    for n in shape:
        _int(out, int(n))
    _pack(out, name)
    _pack(out, raw)
    return bytes(out)


def packb(x: Any) -> bytes:
    """One msgpack document of ``x`` with flax's ext types (flax's
    ``msgpack.packb(..., default=_msgpack_ext_pack, strict_types=True)``)."""
    out = bytearray()
    _pack(out, x)
    return bytes(out)


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) \
        else a.size * a.dtype.itemsize


def _chunk(a) -> dict:
    """flax's ``_chunk``: the flat array in chunks of MAX_CHUNK_SIZE bytes."""
    itemsize = (a.element_size() if isinstance(a, torch.Tensor)
                else a.dtype.itemsize)
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = a.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(a.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _chunk_leaves(d: Any) -> Any:
    """flax's ``_chunk_array_leaves_in_place`` on a copy of the dict chain:
    an array above MAX_CHUNK_SIZE bytes at the top or as a value of nested
    dicts becomes its chunked dict."""
    if isinstance(d, dict):
        out = {}
        for k, v in d.items():
            if isinstance(v, (np.ndarray, torch.Tensor)):
                out[k] = _chunk(v) if _nbytes(v) > MAX_CHUNK_SIZE else v
            elif isinstance(v, dict):
                out[k] = _chunk_leaves(v)
            else:
                out[k] = v
        return out
    if isinstance(d, (np.ndarray, torch.Tensor)) and \
            _nbytes(d) > MAX_CHUNK_SIZE:
        return _chunk(d)
    return d


def _sorted(d: Any) -> Any:
    """A copy with every dict's keys sorted, as the ``jax.tree_util.tree_map``
    copy that ``msgpack_serialize`` starts from rebuilds them."""
    if isinstance(d, dict):
        return {k: _sorted(d[k]) for k in sorted(d)}
    if isinstance(d, list):
        return [_sorted(v) for v in d]
    return d


def msgpack_serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize`` without flax or msgpack."""
    return packb(_chunk_leaves(_sorted(tree)))


def write(path: str, tree: Any) -> None:
    """Write ``tree`` as a flax msgpack file: to ``path + '.tmp'``, then
    ``os.replace``, so a reader never sees half a file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_serialize(tree))
    os.replace(tmp, path)
