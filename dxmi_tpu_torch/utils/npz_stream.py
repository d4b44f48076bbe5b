"""Streaming npz writer (``dxmi_tpu.utils.npz_stream.NpzStreamWriter``):
append uint8 image batches to ``arr_0`` of an .npz without holding the whole
array, so that 50k samples never sit on the host at once.

The member is STORED (uncompressed), as ``np.savez`` writes it; zipfile
computes its CRC and sizes while it streams, so the row count is declared
up front. Small arrays (the class labels) can be added with ``add``; they are
written as further members when the writer closes.
"""
from __future__ import annotations

import zipfile
from typing import Dict

import numpy as np


class NpzStreamWriter:
    """Incremental writer of an npz whose first array has a known row count.

    >>> w = NpzStreamWriter(path, n_total=50000, shape_tail=(64, 64, 3))
    >>> w.write(batch)  # (B, 64, 64, 3) uint8, repeatedly
    >>> w.add("arr_1", labels)
    >>> w.close()       # raises if the row count does not match

    As a context manager it closes on exit; after an exception in the block
    it closes the file without the row-count check, so that the first error
    is the one raised.
    """

    def __init__(self, path: str, n_total: int, shape_tail,
                 dtype=np.uint8, key: str = "arr_0"):
        self.path = path
        self.n_total = int(n_total)
        self.shape_tail = tuple(int(s) for s in shape_tail)
        self.dtype = np.dtype(dtype)
        self.n = 0
        self._extra: Dict[str, np.ndarray] = {}
        self._zf = zipfile.ZipFile(path, "w", zipfile.ZIP_STORED)
        self._f = self._zf.open(key + ".npy", "w", force_zip64=True)
        shape = (self.n_total,) + self.shape_tail
        np.lib.format.write_array_header_1_0(
            self._f, {"descr": np.lib.format.dtype_to_descr(self.dtype),
                      "fortran_order": False, "shape": shape})

    def write(self, batch: np.ndarray) -> None:
        batch = np.ascontiguousarray(batch, dtype=self.dtype)
        if batch.shape[1:] != self.shape_tail:
            raise ValueError(f"NpzStreamWriter: batch of shape {batch.shape},"
                             f" rows of {self.shape_tail} declared")
        if self.n + len(batch) > self.n_total:
            raise ValueError(f"NpzStreamWriter: {self.n + len(batch)} rows, "
                             f"{self.n_total} declared")
        self._f.write(batch.tobytes())
        self.n += len(batch)

    def add(self, key: str, array: np.ndarray) -> None:
        """Keep ``array`` to be written as member ``key`` at ``close``."""
        self._extra[key] = np.asarray(array)

    def __enter__(self) -> "NpzStreamWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self._f.close()
            self._zf.close()

    def close(self) -> None:
        self._f.close()
        try:
            for key, array in self._extra.items():
                with self._zf.open(key + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, array, allow_pickle=False)
        finally:
            self._zf.close()
        if self.n != self.n_total:
            raise ValueError(
                f"NpzStreamWriter: wrote {self.n} rows, declared "
                f"{self.n_total}; the npz at {self.path} is inconsistent")
