"""optax's update rules for the trainers, written out: Adam, RAdam, the
global-norm clip and ``apply_if_finite`` (optax 0.2's ``scale_by_adam``,
``scale_by_radam``, ``clip_by_global_norm``, ``apply_if_finite``).

``torch.optim.RAdam`` is a different rule: it adds eps to sqrt(v) before the
bias correction (``_compute_adaptive_lr``: sqrt(1 - b2^t) / (sqrt(v) + eps)),
where optax adds it to sqrt(v_hat) = sqrt(v / (1 - b2^t)); and it takes the
adaptive step when rho_t > 5, optax when rho_t >= 5. With gradients near eps
the two differ (``tests/test_torch_optim.py``), so the port keeps optax's.

An optimizer holds a list of parameters and its state, and ``step(grads)``
updates the parameters in place (optax: ``p + (-lr) * u``), all in fp32.
``state()`` and ``load_state()`` give and take that state under optax's
names and dtypes (``ScaleByAdamState``: ``count`` int32, ``mu`` and ``nu``
in the parameters' dtype; ``ApplyIfFiniteState``: ``notfinite_count`` and
``total_notfinite`` int32, ``last_finite`` bool), which
``utils/train_state.py`` lays out as the JAX package's train state.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (``optax.global_norm``)."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: unchanged when the norm is below
    ``max_norm``, else each tensor divided by the norm, times max_norm."""
    norm = global_norm(grads)
    if norm < max_norm:
        return grads
    return [g / norm * max_norm for g in grads]


def _pow32(base: float, n: int) -> np.float32:
    """base ** n in fp32 by square-and-multiply, as XLA computes a float
    raised to an integer array (optax's ``decay ** count``)."""
    acc, b = np.float32(1.0), np.float32(base)
    while n:
        if n & 1:
            acc = np.float32(acc * b)
        b = np.float32(b * b)
        n >>= 1
    return acc


class Adam:
    """``optax.adam(lr, b1, b2, eps)``. The step's scalars (bias
    corrections, RAdam's rectification) are computed in fp32 operation by
    operation as optax computes them."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def _moments(self, grads):
        """Update the moments and return their bias-corrected values."""
        self.count += 1
        bc1 = float(np.float32(1) - _pow32(self.b1, self.count))
        bc2 = float(np.float32(1) - _pow32(self.b2, self.count))
        out = []
        for m, v, g in zip(self.mu, self.nu, grads):
            m.copy_((1 - self.b1) * g + self.b1 * m)
            v.copy_((1 - self.b2) * (g * g) + self.b2 * v)
            out.append((m / bc1, v / bc2))
        return out

    def direction(self, grads):
        return [m / (torch.sqrt(v) + self.eps)
                for m, v in self._moments(grads)]

    def state(self) -> Dict[str, Any]:
        """``{'count': int32 0-d array, 'mu': [...], 'nu': [...]}`` (the
        moment tensors themselves, in the order of the parameters)."""
        return {"count": np.asarray(self.count, np.int32), "mu": self.mu,
                "nu": self.nu}

    @torch.no_grad()
    def load_state(self, count, mu: Sequence[torch.Tensor],
                   nu: Sequence[torch.Tensor]) -> None:
        """Restore ``count`` and copy ``mu`` and ``nu`` (one tensor a
        parameter, in its shape) into the moments."""
        self.count = int(count)
        for dst, src in zip(self.mu + self.nu, list(mu) + list(nu)):
            dst.copy_(torch.as_tensor(src).reshape(dst.shape))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        step = float(np.float32(-self.lr))
        for p, u in zip(self.params, self.direction(grads)):
            p.add_(u * step)


class RAdam(Adam):
    """``optax.radam(lr, b1, b2, eps, threshold=5)``: the bias-corrected
    momentum while rho_t is below the threshold, then r_t m_hat /
    (sqrt(v_hat) + eps). rho_t is a difference of two numbers near
    2 / (1 - b2), so its fp32 rounding moves r_t by ~1% at the first
    rectified steps: the port rounds as optax does."""

    threshold = 5.0

    def direction(self, grads):
        moments = self._moments(grads)
        f32 = np.float32
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        b2t = _pow32(self.b2, self.count)
        ro = f32(f32(ro_inf) - f32(f32(f32(2 * self.count) * b2t)
                                   / f32(f32(1) - b2t)))
        if not ro >= self.threshold:
            return [m for m, _ in moments]
        num = f32(f32(f32(ro - f32(4.0)) * f32(ro - f32(2.0))) * f32(ro_inf))
        den = f32(f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)
        r = float(np.sqrt(f32(num / den)))
        return [r * m / (torch.sqrt(v) + self.eps) for m, v in moments]


class ApplyIfFinite:
    """``optax.apply_if_finite(inner, max_consecutive_errors)`` over one or
    more optimizers that together hold the parameters: a step whose
    gradients are not all finite is skipped (parameters and state unchanged)
    and counted, unless more than ``max_consecutive_errors`` skips came in a
    row."""

    def __init__(self, inner: Sequence[Adam], max_consecutive_errors: int):
        self.inner = list(inner)
        self.max_consecutive_errors = max_consecutive_errors
        self.notfinite_count = 0
        self.total_notfinite = 0
        self.last_finite = True

    def state(self) -> Dict[str, np.ndarray]:
        """optax's three counters, int32 and bool 0-d arrays."""
        return {"notfinite_count": np.asarray(self.notfinite_count, np.int32),
                "last_finite": np.asarray(self.last_finite, np.bool_),
                "total_notfinite": np.asarray(self.total_notfinite, np.int32)}

    def load_state(self, notfinite_count, last_finite,
                   total_notfinite) -> None:
        self.notfinite_count = int(notfinite_count)
        self.last_finite = bool(last_finite)
        self.total_notfinite = int(total_notfinite)

    @torch.no_grad()
    def step(self, grads: Sequence[Sequence[torch.Tensor]]) -> bool:
        """``grads`` holds one list per inner optimizer; returns whether the
        update was applied."""
        finite = all(bool(torch.isfinite(g).all()) for gs in grads
                     for g in gs)
        self.last_finite = finite
        if finite:
            self.notfinite_count = 0
        else:
            self.notfinite_count += 1
            self.total_notfinite += 1
        if finite or self.notfinite_count > self.max_consecutive_errors:
            for opt, gs in zip(self.inner, grads):
                opt.step(gs)
            return True
        return False
