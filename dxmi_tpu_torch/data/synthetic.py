"""Class-structured synthetic images for ``--fake_data``: the port's own copy
of ``dxmi_tpu.data.synthetic.structured_class_images`` (numpy only)."""
from __future__ import annotations

import numpy as np


def structured_class_images(n: int, res: int, n_class: int,
                            seed: int = 0) -> tuple:
    """``n`` images in [-1, 1], NHWC float32, and their int32 labels: a
    per-class gradient orientation plus a class-coloured blob, so that a
    class-conditional net has a distribution to learn."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / max(res - 1, 1)
    imgs = np.empty((n, res, res, 3), np.float32)
    labels = rng.integers(0, max(n_class, 1), n).astype(np.int32)
    dirs = [(1, 0), (0, 1), (1, 1), (1, -1), (-1, 1), (0, -1), (-1, 0),
            (-1, -1)]
    for i in range(n):
        c = int(labels[i])
        a, b = dirs[c % len(dirs)]
        base = 0.5 + 0.35 * (a * xx + b * yy) / (abs(a) + abs(b))
        cx, cy = rng.uniform(0.25, 0.75, 2)
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 0.03))
        for ch in range(3):
            w = 1.0 if ch == c % 3 else 0.3
            imgs[i, :, :, ch] = np.clip(
                base * rng.uniform(0.6, 1.0) + w * 0.5 * blob
                + rng.normal(0, 0.02, (res, res)), 0, 1)
    return 2.0 * imgs - 1.0, labels
