"""Activations of an image directory (``dxmi_tpu/fid/image_dir.py``,
pytorch_fid's ``ImagePathDataset`` path) and the statistics files.

Images are read by ``utils/png.py``; the other extensions that the JAX
package lists (decoded there by PIL, which the card's machine does not
have) raise.
"""
from __future__ import annotations

import os
from typing import Callable, List, Tuple

import numpy as np

from dxmi_tpu_torch.fid.stats import activation_statistics
from dxmi_tpu_torch.utils.png import read_png

IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".tiff", ".webp"}


def list_images(path: str) -> List[str]:
    out = []
    for root, _dirs, files in os.walk(path):
        for f in sorted(files):
            if os.path.splitext(f)[1].lower() in IMG_EXTS:
                out.append(os.path.join(root, f))
    return sorted(out)


def load_batch(paths: List[str]) -> np.ndarray:
    """(B, H, W, 3) float32 in [0, 1] of PNG files."""
    imgs = []
    for p in paths:
        if os.path.splitext(p)[1].lower() != ".png":
            raise ValueError(f"{p}: only PNG images are read by the port "
                             "(the other formats need PIL; ROADMAP.md)")
        imgs.append(read_png(p).astype(np.float32) / 255.0)
    return np.stack(imgs)


def dir_activations(path: str, extract_fn: Callable, batch: int = 50
                    ) -> np.ndarray:
    """``extract_fn`` (NHWC [0, 1] numpy -> (B, D) numpy) over every image
    under ``path``, in sorted order."""
    files = list_images(path)
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    return np.concatenate([np.asarray(extract_fn(load_batch(files[i:i + batch])))
                           for i in range(0, len(files), batch)])


def compute_dir_statistics(path: str, extract_fn: Callable, batch: int = 50
                           ) -> Tuple[np.ndarray, np.ndarray]:
    return activation_statistics(dir_activations(path, extract_fn, batch))


def save_stats(path: str, mu: np.ndarray, sigma: np.ndarray) -> None:
    np.savez(path, mu=mu, sigma=sigma)
