"""Synthetic data, numpy only: the port's own copy of
``dxmi_tpu.data.synthetic``. Class-structured images for ``--fake_data``
(``structured_class_images``) and the 2D experiment's distributions,
energies and exact 8-gaussians density (``sample2d``, ``energy2d``,
``pdf_8gaussian``)."""
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


# ---- the 2D experiment (``synthetic.py:11-86``) ---------------------------

_SQ2 = 1.0 / np.sqrt(2)
_CENTERS_8G = np.array([(1, 0), (-1, 0), (0, 1), (0, -1), (_SQ2, _SQ2),
                        (-_SQ2, _SQ2), (_SQ2, -_SQ2), (-_SQ2, -_SQ2)]) * 4.0


def sample2d(data: str, batch_size: int = 200,
             rng: np.random.RandomState | None = None,
             scale_factor: float = 1.0) -> np.ndarray:
    """``batch_size`` float32 points of a named 2D distribution
    (``8gaussians``, ``2spirals``, ``checkerboard``), drawn from ``rng`` in
    the JAX package's order, so the same ``RandomState`` gives the same
    points."""
    if rng is None:
        rng = np.random.RandomState()
    if data == "8gaussians":
        idx = rng.randint(0, 8, size=batch_size)
        points = rng.randn(batch_size, 2) * 0.5 + _CENTERS_8G[idx]
        return (points / 1.414).astype(np.float32) * scale_factor
    if data == "2spirals":
        n = np.sqrt(rng.rand(batch_size // 2, 1)) * 540 * (2 * np.pi) / 360
        d1x = -np.cos(n) * n + rng.rand(batch_size // 2, 1) * 0.5
        d1y = np.sin(n) * n + rng.rand(batch_size // 2, 1) * 0.5
        x = np.vstack([np.hstack([d1x, d1y]), np.hstack([-d1x, -d1y])]) / 3
        x += rng.randn(*x.shape) * 0.1
        return x.astype(np.float32) * scale_factor
    if data == "checkerboard":
        x1 = rng.rand(batch_size) * 4 - 2
        x2_ = rng.rand(batch_size) - rng.randint(0, 2, batch_size) * 2
        x2 = x2_ + np.floor(x1) % 2
        out = np.stack([x1, x2], axis=1) * 2
        return out.astype(np.float32) * scale_factor
    raise ValueError(f"unknown 2d dataset: {data}")


def energy2d(data: str, z: np.ndarray) -> np.ndarray:
    """The unnormalised 2D energies U1-U4 (float64)."""
    z = np.asarray(z, dtype=np.float64)
    z1, z2 = z[:, 0], z[:, 1]
    w1 = np.sin(2 * np.pi * z1 / 4)
    if data == "U1":
        return 0.5 * ((np.linalg.norm(z, axis=1) - 2) / 0.4) ** 2 - np.log(
            np.exp(-0.5 * ((z1 - 2) / 0.6) ** 2)
            + np.exp(-0.5 * ((z1 + 2) / 0.6) ** 2) + 1e-12)
    if data == "U2":
        return 0.5 * ((z2 - w1) / 0.4) ** 2
    if data == "U3":
        w2 = 3 * np.exp(-0.5 * ((z1 - 1) / 0.6) ** 2)
        return -np.log(np.exp(-0.5 * ((z2 - w1) / 0.35) ** 2)
                       + np.exp(-0.5 * ((z2 - w1 + w2) / 0.35) ** 2) + 1e-12)
    if data == "U4":
        w3 = 3 / (1 + np.exp(-(z1 - 1) / 0.3))
        return -np.log(np.exp(-0.5 * ((z2 - w1) / 0.4) ** 2)
                       + np.exp(-0.5 * ((z2 - w1 + w3) / 0.35) ** 2) + 1e-12)
    raise ValueError(f"unknown 2d energy: {data}")


def pdf_8gaussian(x: np.ndarray, scale_factor: float = 1.0) -> np.ndarray:
    """The exact density of ``8gaussians`` at the points ``x`` (N, 2)."""
    centers = _CENTERS_8G / 1.414 * scale_factor
    std = 0.5 / 1.414 * scale_factor
    x = np.asarray(x, dtype=np.float64)[:, None, :]
    d2 = ((x - centers[None]) ** 2).sum(-1)
    comp = np.exp(-0.5 * d2 / std ** 2) / (2 * np.pi * std ** 2)
    return comp.mean(axis=1)
