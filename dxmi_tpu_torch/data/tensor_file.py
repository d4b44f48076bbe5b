"""Tensor-file datasets (``dxmi_tpu.data.tensor_file``,
``tensor_file.py:17-77``): the reference README's MVTec layout,
``datasets/mvtec/train_data.pth``.

A file holds a tensor, a (data, labels) tuple or list, or a dict with the
images under ``data``, ``images``, ``x`` or ``train_data`` (labels under
``labels`` or ``y``), else its first array. Images go to NHWC float32 in
[-1, 1] from [0, 255] (max above 1.5), [0, 1] (min at least 0) or
[-1, 1], as the JAX loader infers the range; ``tensor_batches`` yields
shuffled batches from ``RandomState(seed)`` in the JAX loader's order.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch


def _to_nhwc_pm1(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr, np.float32)
    if arr.ndim != 4:
        raise ValueError(f"expected a 4-D image tensor, got {arr.shape}")
    if arr.shape[1] in (1, 3) and arr.shape[-1] not in (1, 3):
        arr = arr.transpose(0, 2, 3, 1)
    amax, amin = float(arr.max()), float(arr.min())
    if amax > 1.5:
        arr = arr / 127.5 - 1.0
    elif amin >= 0.0:
        arr = arr * 2.0 - 1.0
    return arr


def _numpy(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def load_tensor_dataset(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(images NHWC float32 in [-1, 1], labels or None) of a tensor file."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    labels = None
    if isinstance(obj, (tuple, list)) and len(obj) >= 1:
        if len(obj) >= 2 and hasattr(obj[1], "shape"):
            labels = _numpy(obj[1])
        obj = obj[0]
    elif isinstance(obj, dict):
        for k in ("data", "images", "x", "train_data"):
            if k in obj:
                for lk in ("labels", "y"):
                    if lk in obj and hasattr(obj[lk], "shape"):
                        labels = _numpy(obj[lk])
                        break
                obj = obj[k]
                break
        else:
            obj = next(v for v in obj.values() if hasattr(v, "shape"))
    return _to_nhwc_pm1(_numpy(obj)), labels


def tensor_batches(path: str, batch_size: int, seed: int = 0,
                   image_size: Optional[int] = None
                   ) -> Iterator[Tuple[np.ndarray, dict]]:
    """Infinite shuffled batches ``(x NHWC, {'y': labels}`` or ``{})`` of a
    tensor file: a permutation of ``RandomState(seed)`` an epoch, whole
    batches only. Raises when the images are not ``image_size`` square."""
    imgs, labels = load_tensor_dataset(path)
    if image_size is not None and imgs.shape[1] != image_size:
        raise ValueError(
            f"{path} holds {imgs.shape[1]}x{imgs.shape[2]} images; set "
            f"--image_size {imgs.shape[1]} (got {image_size})")
    rng = np.random.RandomState(seed)
    n = len(imgs)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            extra = {}
            if labels is not None:
                extra["y"] = np.asarray(labels[idx], np.int32)
            yield imgs[idx], extra
