"""Diffusion schedule numerics.

A copy of ``dxmi_tpu/schedules.py`` (``make_beta_schedule``, ``ddpm_grid``,
``get_var_noise``, ``precompute_var_steps``, ``var_schedule``, and the
Karras/EDM ``karras_schedule``, ``edm_scalings``, ``edm_rescaled_t``), kept
here so that the port never imports the JAX package. The grids are numpy,
computed once on the host; the samplers turn them into tensors on their
device. ``edm_scalings`` and ``edm_rescaled_t`` act on tensors.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Tuple

import numpy as np
import torch

DDPM_BETA_0 = 1e-4
DDPM_BETA_T = 2e-2
DDPM_T = 1000


def make_beta_schedule(schedule: str = "linear", n_timesteps: int = 1000,
                       start: float = 1e-5, end: float = 1e-2) -> np.ndarray:
    """Beta schedule of the cost-defining forward process q."""
    if schedule == "linear":
        betas = np.linspace(start, end, n_timesteps)
    elif schedule == "quad":
        betas = np.linspace(start**0.5, end**0.5, n_timesteps) ** 2
    elif schedule == "sigmoid":
        x = np.linspace(-6.0, 6.0, n_timesteps)
        betas = 1.0 / (1.0 + np.exp(-x)) * (end - start) + start
    elif schedule == "constant":
        betas = np.ones(n_timesteps) * start
    else:
        raise ValueError(f"unknown beta schedule: {schedule}")
    return betas.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class DDPMGrid:
    """The 1000-step linear-beta DDPM grid (float32)."""

    T: int
    beta: np.ndarray
    alpha: np.ndarray
    alpha_bar: np.ndarray
    sigma: np.ndarray


@functools.lru_cache(maxsize=8)
def ddpm_grid(T: int = DDPM_T, beta_0: float = DDPM_BETA_0,
              beta_T: float = DDPM_BETA_T) -> DDPMGrid:
    beta = np.linspace(beta_0, beta_T, T, dtype=np.float32)
    alpha = 1.0 - beta
    alpha_bar = np.cumprod(alpha, dtype=np.float32)
    prev = np.concatenate([[0.0], alpha_bar[:-1]]).astype(np.float32)
    beta_tilde = beta * (1.0 - prev) / (1.0 - alpha_bar)
    return DDPMGrid(T=T, beta=beta, alpha=alpha, alpha_bar=alpha_bar,
                    sigma=np.sqrt(beta_tilde))


def bisearch(f: Callable[[float], float], domain: Tuple[float, float],
             target: float, eps: float = 1e-8, iters: int = 1000) -> float:
    """Bisection for f(x) ~ target with f decreasing in x."""
    sign = -1.0 if target < 0 else 1.0
    left, right = domain
    x = (left + right) / 2.0
    for _ in range(iters):
        x = (left + right) / 2.0
        fx = f(x)
        if fx < target:
            right = x
        elif fx > (1.0 + sign * eps) * target:
            left = x
        else:
            break
    return x


def get_var_noise(S: int, schedule: str = "quadratic",
                  beta_0: float = DDPM_BETA_0, beta_T: float = DDPM_BETA_T,
                  T: int = DDPM_T) -> np.ndarray:
    """The S-step per-step variance schedule whose product of (1 - eta)
    matches the terminal alpha_bar of the 1000-step grid."""
    target = float(np.prod(1.0 - np.linspace(beta_0, beta_T, T)))
    if schedule == "linear":
        g = lambda x: np.linspace(beta_0, x, S)
        domain = (beta_0, 0.99)
    elif schedule == "quadratic":
        g = lambda x: beta_0 * (1.0 + np.arange(S) * x) ** 2
        domain = (0.0, 0.95 / math.sqrt(beta_0) / S)
    else:
        raise ValueError(f"unknown VAR schedule: {schedule}")
    f = lambda x: float(np.prod(1.0 - g(x)))
    return g(bisearch(f, domain, target, eps=1e-4))


def _log_gamma(x):
    """Stirling approximation of log Gamma(x + 1), float64."""
    y = np.float64(x) - 1.0
    return (np.log(2.0 * np.pi * y) / 2.0 + y * (np.log(y) - 1.0)
            + np.log(1.0 + 1.0 / (12.0 * y)))


def _log_cont_noise(t, beta_0, beta_T, T: int):
    """log alpha_bar as a continuous function of the timestep, in float64:
    the function is nearly flat near t=0, so the bisection root needs it."""
    t = np.float64(t)
    beta_0 = np.float64(beta_0)
    beta_T = np.float64(beta_T)
    delta_beta = (beta_T - beta_0) / (T - 1)
    c = (1.0 - beta_0) / delta_beta
    t_1 = t + 1.0
    return t_1 * np.log(delta_beta) + _log_gamma(c + 1.0) - _log_gamma(c - t_1 + 1.0)


def precompute_var_steps(grid: DDPMGrid, user_defined_eta: np.ndarray) -> np.ndarray:
    """Continuous timestep on the 1000-step grid for each VAR noise level,
    in sampling order (first entry = most noisy step)."""
    T_user = len(user_defined_eta)
    gamma_bar = np.cumprod(1.0 - user_defined_eta.astype(np.float32))
    if not (gamma_bar[0] <= grid.alpha_bar[0]
            and gamma_bar[-1] >= grid.alpha_bar[-1]):
        raise ValueError("VAR schedule lies outside the DDPM grid")
    beta_0 = float(grid.beta[0])
    beta_T = float(grid.beta[-1])
    steps = []
    for t in range(T_user - 1, -1, -1):
        t_adapted = None
        idx = np.searchsorted(-grid.alpha_bar, -gamma_bar[t])
        for i in range(max(0, idx - 2), grid.T - 1):
            if grid.alpha_bar[i] >= gamma_bar[t] > grid.alpha_bar[i + 1]:
                t_adapted = bisearch(
                    f=lambda _t: _log_cont_noise(_t, beta_0, beta_T, grid.T),
                    domain=(i - 0.01, i + 1.01),
                    target=float(np.log(gamma_bar[t])))
                break
        if t_adapted is None:
            t_adapted = grid.T - 1
        steps.append(t_adapted)
    return np.asarray(steps, dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class VarSchedule:
    """Per-step constants of the VAR ancestral sampler, float32 arrays of
    shape (T,) indexed by sampling step (0 = most noisy)."""

    tau: np.ndarray         # continuous timestep fed to the U-Net
    x_mult: np.ndarray      # multiplier of x_prev
    eps_mult: np.ndarray    # multiplier of the predicted noise
    sigma_q: np.ndarray     # analytic ancestral std (last entry 0)
    init_sigma: np.ndarray  # init of log_betas (last = 1e-3)
    gamma_bar: np.ndarray
    eta: np.ndarray


@functools.lru_cache(maxsize=16)
def var_schedule(n_timesteps: int, schedule: str = "quadratic") -> VarSchedule:
    """The complete VAR sampling schedule for a T-step sampler."""
    grid = ddpm_grid()
    eta = get_var_noise(n_timesteps, schedule)
    taus = precompute_var_steps(grid, eta)
    gamma_bar = np.cumprod(1.0 - eta.astype(np.float64))

    T = n_timesteps
    x_mult = np.zeros(T)
    eps_mult = np.zeros(T)
    sigma_q = np.zeros(T)
    init_sigma = np.zeros(T)
    for i in range(T):
        gbar = gamma_bar[T - 1 - i]
        if i == T - 1:
            alpha_next = 1.0
            sig = 0.0
            init_sigma[i] = 1e-3
        else:
            alpha_next = gamma_bar[T - 1 - i - 1]
            sig = math.sqrt(
                (1.0 - alpha_next) / (1.0 - gbar) * (1.0 - gbar / alpha_next))
            init_sigma[i] = sig
        x_mult[i] = math.sqrt(alpha_next / gbar)
        eps_mult[i] = (math.sqrt(max(1.0 - alpha_next - sig**2, 0.0))
                       - math.sqrt(1.0 - gbar) * x_mult[i])
        sigma_q[i] = sig

    f32 = lambda a: np.asarray(a, dtype=np.float32)
    return VarSchedule(tau=f32(taus), x_mult=f32(x_mult),
                       eps_mult=f32(eps_mult),
                       sigma_q=f32(sigma_q),
                       init_sigma=f32(init_sigma),
                       gamma_bar=f32(gamma_bar), eta=f32(eta))


# ---------------------------------------------------------------------------
# Karras / EDM schedule (dxmi_tpu/schedules.py karras_sigmas .. edm_rescaled_t)
# ---------------------------------------------------------------------------


def karras_sigmas(n: int, sigma_min: float = 0.002, sigma_max: float = 80.0,
                  rho: float = 7.0) -> np.ndarray:
    """rho-spaced EDM sigma grid with a trailing zero, shape (n+1,)."""
    ramp = np.linspace(0.0, 1.0, n)
    min_inv_rho = sigma_min ** (1.0 / rho)
    max_inv_rho = sigma_max ** (1.0 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return np.concatenate([sigmas, [0.0]]).astype(np.float32)


def ancestral_split(sigmas: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split consecutive sigma pairs into (sigma_down, sigma_up) for
    Euler-ancestral sampling. Input (T+1,) -> outputs (T,)."""
    sigma_from, sigma_to = sigmas[:-1], sigmas[1:]
    sigma_up = np.sqrt(sigma_to**2 * (sigma_from**2 - sigma_to**2)
                       / np.maximum(sigma_from**2, 1e-20))
    sigma_down = np.sqrt(np.maximum(sigma_to**2 - sigma_up**2, 0.0))
    return sigma_down.astype(np.float32), sigma_up.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class KarrasSchedule:
    """Per-step constants of the EDM Euler-ancestral policy, float32 arrays
    of shape (T,) indexed by sampling step (0 = most noisy)."""

    sigmas: np.ndarray      # sigma at each sampling step
    sigma_down: np.ndarray
    sigma_up: np.ndarray    # noise actually added
    sigma_max: float
    sigma_data: float


def karras_schedule(n_timesteps: int, sigma_min: float = 0.002,
                    sigma_max: float = 80.0, rho: float = 7.0,
                    stochastic_last: bool = False,
                    sigma_data: float = 0.5) -> KarrasSchedule:
    """The EDM policy schedule. ``stochastic_last`` keeps a non-zero terminal
    sigma by building an (n+1)-point grid and dropping its final zero."""
    if stochastic_last:
        full = karras_sigmas(n_timesteps + 1, sigma_min, sigma_max, rho)[:-1]
    else:
        full = karras_sigmas(n_timesteps, sigma_min, sigma_max, rho)
    down, up = ancestral_split(full)
    return KarrasSchedule(sigmas=full[:-1], sigma_down=down, sigma_up=up,
                          sigma_max=float(sigma_max),
                          sigma_data=float(sigma_data))


def edm_scalings(sigma: torch.Tensor, sigma_data: float = 0.5):
    """EDM preconditioning (c_skip, c_out, c_in) of a sigma tensor."""
    c_skip = sigma_data**2 / (sigma**2 + sigma_data**2)
    c_out = sigma * sigma_data / torch.sqrt(sigma**2 + sigma_data**2)
    c_in = 1.0 / torch.sqrt(sigma**2 + sigma_data**2)
    return c_skip, c_out, c_in


def edm_rescaled_t(sigma: torch.Tensor) -> torch.Tensor:
    """Timestep conditioning fed to the ADM U-Net: 250 log(sigma + 1e-44).
    The 1e-44 is a float32 denormal; torch keeps it (log 0 -> -101.3),
    where XLA on the CPU flushes it to zero (-inf). The sampler never
    passes sigma = 0."""
    return 1000.0 * 0.25 * torch.log(sigma + 1e-44)
