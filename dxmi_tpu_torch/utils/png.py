"""PNG files with the standard library (``zlib``, ``struct``): the port's
counterpart of ``dxmi_tpu/utils/native_io.py`` (``csrc/dxmi_io.cpp``) and of
PIL, which the card's machine does not have.

``write_png`` writes an 8-bit RGB image (filter None on every row, zlib
level 1, as the native writer); ``PNGWriter`` writes batches on a thread
pool (``zlib`` releases the interpreter lock while it compresses).
``read_png`` reads non-interlaced 8-bit grayscale, RGB and RGBA files with
any of the five row filters and returns RGB, as PIL's ``convert('RGB')``
does (gray replicated, alpha dropped); ``read_png_raw`` returns the file's
own channels. Any other file raises and names it.
"""
from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
COMPRESS_LEVEL = 1
# colour type -> channels of the 8-bit forms read here
CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """The bytes of an 8-bit RGB PNG of ``img`` (H, W, 3) uint8."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape} "
                         f"{img.dtype}")
    h, w, _ = img.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # filter byte 0 on each row
    raw[:, 1:] = img.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), COMPRESS_LEVEL))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write ``img`` (H, W, 3) uint8 as an 8-bit RGB PNG."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


class PNGWriter:
    """Writes batches of images as ``<out_dir>/<prefix>_<index>.png`` on a
    pool of threads while the caller goes on sampling. ``close`` waits for
    every write and raises the first failure."""

    def __init__(self, out_dir: str, prefix: str = "0", n_threads: int = 4):
        self.out_dir = out_dir
        self.prefix = prefix
        self._pool = ThreadPoolExecutor(n_threads)
        self._futures: List[Future] = []

    def put_batch(self, start_idx: int, batch_u8: np.ndarray) -> None:
        for j, img in enumerate(np.asarray(batch_u8)):
            path = os.path.join(self.out_dir,
                                f"{self.prefix}_{start_idx + j}.png")
            self._futures.append(self._pool.submit(write_png, path, img))

    def close(self) -> int:
        """Wait for the queued writes; the number written."""
        try:
            for fut in self._futures:
                fut.result()
        finally:
            self._pool.shutdown(wait=True)
        return len(self._futures)

    def __enter__(self) -> "PNGWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self._pool.shutdown(wait=True, cancel_futures=True)


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    a, b, c = (v.astype(np.int16) for v in (a, b, c))
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a,
                    np.where(pb <= pc, b, c)).astype(np.uint8)


def _unfilter(data: bytes, h: int, w: int, bpp: int,
              path: str) -> np.ndarray:
    """Undo the row filters of a non-interlaced 8-bit image: (h, w * bpp)."""
    stride = w * bpp
    if len(data) != h * (stride + 1):
        raise ValueError(f"{path}: {len(data)} bytes of image data, "
                         f"{h * (stride + 1)} expected")
    rows = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum by channel, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            cur = np.zeros(stride, np.uint8)
            zero = np.zeros(bpp, np.uint8)
            for x in range(0, stride, bpp):
                left = cur[x - bpp:x] if x else zero
                up = prior[x:x + bpp]
                if kind == 3:
                    pred = ((left.astype(np.uint16) + up) // 2).astype(
                        np.uint8)
                else:
                    upleft = prior[x - bpp:x] if x else zero
                    pred = _paeth(left, up, upleft)
                cur[x:x + bpp] = line[x:x + bpp] + pred
        else:
            raise ValueError(f"{path}: unknown row filter {kind}")
        out[y] = cur
        prior = cur
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit non-interlaced grayscale, RGB or RGBA PNG as (H, W, 3)
    uint8 RGB."""
    img = read_png_raw(path)
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def read_png_raw(path: str) -> np.ndarray:
    """An 8-bit non-interlaced grayscale, RGB or RGBA PNG as (H, W, C)
    uint8 in its own channels (C = 1, 3 or 4: PIL's modes L, RGB, RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: {kind!r} chunk truncated or corrupt")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in CHANNELS or interlace:
        raise ValueError(
            f"{path}: bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace}; only non-interlaced 8-bit grayscale, RGB and "
            "RGBA PNGs are read")
    bpp = CHANNELS[ctype]
    return _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp,
                     path).reshape(h, w, bpp)
