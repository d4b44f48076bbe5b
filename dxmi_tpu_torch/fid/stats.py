"""Activation statistics and the Frechet distance (``dxmi_tpu/fid/stats.py``).

The statistics and the distance run on the host in float64 numpy and scipy,
as the JAX package's do: mean and ddof=1 covariance of the (N, D) pool3
activations, and the Frechet distance by the Cholesky reformulation or
scipy's ``sqrtm`` with pytorch_fid's eps-jitter fallback.
``sqrtm_newton_schulz`` is the matmul-only matrix square root, on torch
tensors of any device.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def activation_statistics(acts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) activations -> (mu (D,), sigma (D, D)) in float64, the
    covariance with ddof=1 (``np.cov``'s default)."""
    acts = np.asarray(acts, dtype=np.float64)
    return acts.mean(axis=0), np.cov(acts, rowvar=False)


def stats_from_moments(n: int, s1: np.ndarray,
                       s2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(n, sum x, sum x x^T) -> (mu, ddof=1 covariance), equal to
    ``activation_statistics`` up to the one-pass reassociation."""
    mu = s1 / n
    sigma = (s2 - n * np.outer(mu, mu)) / (n - 1)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6,
                     method: str = "auto",
                     info: Optional[Dict[str, object]] = None) -> float:
    """The Frechet distance between N(mu1, sigma1) and N(mu2, sigma2).

    ``method``: ``'cholesky'`` (with sigma1 = L L^T, sigma1 sigma2 is
    similar to the SPD matrix L^T sigma2 L, so tr sqrt(sigma1 sigma2) is the
    sum of the square roots of its eigenvalues), ``'scipy'`` (pytorch_fid's
    ``linalg.sqrtm`` with its eps-jitter and imaginary-part checks) or
    ``'auto'`` (cholesky when sigma1 is positive definite, else scipy).
    ``info``, when given, receives ``route`` (the method that gave the
    value) and ``seconds``.
    """
    from scipy import linalg

    t0 = time.perf_counter()
    mu1 = np.atleast_1d(np.asarray(mu1, dtype=np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, dtype=np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, dtype=np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, dtype=np.float64))
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"statistics of different shapes: {mu1.shape}, "
                         f"{sigma1.shape} against {mu2.shape}, "
                         f"{sigma2.shape}")

    def done(route: str, value: float) -> float:
        if info is not None:
            info.update(route=route, seconds=time.perf_counter() - t0)
        return value

    diff = mu1 - mu2
    if method in ("auto", "cholesky"):
        try:
            L = np.linalg.cholesky(sigma1)
            inner = L.T @ sigma2 @ L
            vals = np.linalg.eigvalsh((inner + inner.T) / 2.0)
            tr_covmean = float(np.sqrt(np.clip(vals, 0.0, None)).sum())
            return done("cholesky", float(diff.dot(diff) + np.trace(sigma1)
                                          + np.trace(sigma2)
                                          - 2.0 * tr_covmean))
        except np.linalg.LinAlgError:
            if method == "cholesky":
                raise
    elif method != "scipy":
        raise ValueError(f"unknown method {method!r}")

    # JAX's sqrtm(..., disp=False)[0]; scipy 1.18 drops ``disp``
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return done("scipy", float(diff.dot(diff) + np.trace(sigma1)
                               + np.trace(sigma2) - 2 * np.trace(covmean)))


def sqrtm_newton_schulz(a: torch.Tensor, iters: int = 50) -> torch.Tensor:
    """The square root of an SPD matrix by the coupled Newton-Schulz
    iteration (matrix products only), in ``a``'s dtype and on its device."""
    dim = a.shape[0]
    norm = torch.linalg.norm(a)
    y = a / norm
    z = torch.eye(dim, dtype=a.dtype, device=a.device)
    eye3 = 3.0 * torch.eye(dim, dtype=a.dtype, device=a.device)
    for _ in range(iters):
        t = 0.5 * (eye3 - z @ y)
        y = y @ t
        z = t @ z
    return y * torch.sqrt(norm)
