"""DDGAN 4-step posterior sampler, the DxMI policy for CIFAR-10 T=4
(``dxmi_tpu.samplers.ddgan.DDGANSampler``), in PyTorch.

The generator predicts x0 = G(x_t, t, z) with z ~ N(0, I_nz) per step; a
step samples the DDPM posterior q(x_{t-1} | x_t, x0) = N(c1 x0 + c2 x_t,
sigma^2) on the VP-SDE schedule discretised over T steps (beta_min 0.1,
beta_max 20, eps_small 1e-3), with the per-step sigma trainable
(``log_betas``). ``sample_step`` and ``sample`` keep the d_step / d_sample
contract of the port's other samplers; the T-step loop is a Python loop.

Noise and latents come from an explicit ``torch.Generator`` (z before the
noise in each step) or are injected (``x0``, per-step ``eps`` and ``z``),
which is how the tests hold the port against the JAX package's threefry
draws.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from dxmi_tpu_torch.samplers.var import gaussian_logp_mean


class DDGANSchedule(NamedTuple):
    """Per-step posterior coefficients (fp32 numpy), indexed by sampling
    step i (i = 0 takes the noisiest state, i = T-1 emits x_0)."""
    x0_coef: np.ndarray     # coefficient of the x0 prediction
    xt_coef: np.ndarray     # coefficient of the current state
    sigma_q: np.ndarray     # analytic posterior std (the last 0)
    init_sigma: np.ndarray  # log_betas init (the last 1e-3)
    eta: np.ndarray         # per-step beta (the trainer's betas_for_q)


def _vp_variance(t: np.ndarray, beta_min: float, beta_max: float
                 ) -> np.ndarray:
    log_mean_coeff = -0.25 * t ** 2 * (beta_max - beta_min) \
        - 0.5 * t * beta_min
    return 1.0 - np.exp(2.0 * log_mean_coeff)


def ddgan_schedule(n_timesteps: int, beta_min: float = 0.1,
                   beta_max: float = 20.0, eps_small: float = 1e-3
                   ) -> DDGANSchedule:
    """The schedule in float64, rounded to fp32 at the end, as
    ``dxmi_tpu/samplers/ddgan.py:51-81`` builds it."""
    T = n_timesteps
    t = np.arange(0, T + 1, dtype=np.float64) / T
    t = t * (1.0 - eps_small) + eps_small
    alpha_bar = 1.0 - _vp_variance(t, beta_min, beta_max)
    betas = 1.0 - alpha_bar[1:] / alpha_bar[:-1]
    alphas = 1.0 - betas
    a_bar = np.cumprod(alphas)
    a_bar_prev = np.concatenate([[1.0], a_bar[:-1]])
    c1 = betas * np.sqrt(a_bar_prev) / (1.0 - a_bar)
    c2 = (1.0 - a_bar_prev) * np.sqrt(alphas) / (1.0 - a_bar)
    post_var = betas * (1.0 - a_bar_prev) / (1.0 - a_bar)
    post_std = np.sqrt(np.maximum(post_var, 0.0))
    post_std[0] = 0.0  # the t=1 -> x0 step is deterministic in DDGAN
    order = np.arange(T)[::-1]  # sampling step i is DDGAN time T - i
    init = post_std[order].copy()
    init[-1] = 1e-3
    f32 = lambda a: np.asarray(a, np.float32)
    return DDGANSchedule(x0_coef=f32(c1[order]), xt_coef=f32(c2[order]),
                         sigma_q=f32(post_std[order]), init_sigma=f32(init),
                         eta=f32(betas[order]))


class DDGANSampler(nn.Module):
    """T-step DDGAN posterior policy with trainable per-step sigma.

    ``sample_shape`` is (C, H, W), as the configs give it; ``nz`` is the
    net's ``config.nz`` when it has one."""

    def __init__(self, net: nn.Module, n_timesteps: int,
                 sample_shape: Sequence[int],
                 trainable_beta: Union[bool, str] = "fix_last",
                 use_z: bool = True, nz: int = 100, beta_min: float = 0.1,
                 beta_max: float = 20.0):
        super().__init__()
        if trainable_beta not in (True, False, "fix_last"):
            raise ValueError(f"trainable_beta={trainable_beta!r}")
        self.net = net
        self.n_timesteps = int(n_timesteps)
        self.sample_shape = tuple(int(s) for s in sample_shape)
        self.trainable_beta = trainable_beta
        self.use_z = bool(use_z)
        self.nz = int(getattr(getattr(net, "config", None), "nz", nz))
        sch = ddgan_schedule(self.n_timesteps, beta_min, beta_max)
        for name in DDGANSchedule._fields:
            self.register_buffer(name, torch.from_numpy(getattr(sch, name)),
                                 persistent=False)
        self.log_betas = nn.Parameter(
            torch.log(torch.from_numpy(sch.init_sigma)))

    @property
    def user_defined_eta(self) -> torch.Tensor:
        """The q-process betas (T,) for the trainer's running cost."""
        return self.eta

    def sigmas_all(self) -> torch.Tensor:
        """Per-step sigma (T,), respecting ``trainable_beta``."""
        if self.trainable_beta is True:
            return torch.exp(self.log_betas)
        if self.trainable_beta == "fix_last":
            sig = torch.exp(self.log_betas)
            return torch.cat([sig[:-1], sig.new_full((1,), 1e-3)])
        return torch.clamp(self.sigma_q, min=1e-3)

    def _ddgan_t(self, t: torch.Tensor) -> torch.Tensor:
        """The generator's own time index of sampling step ``t``:
        T - 1 - t (noisiest first)."""
        return (self.n_timesteps - 1 - t).float()

    def _z(self, B: int, generator: Optional[torch.Generator]
           ) -> torch.Tensor:
        device = self.log_betas.device
        if not self.use_z:
            return torch.zeros((B, self.nz), device=device)
        return torch.randn((B, self.nz), generator=generator, device=device)

    def sample_step(self, x: torch.Tensor, t: Union[int, torch.Tensor],
                    noise: Optional[torch.Tensor] = None,
                    y: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    train: bool = False,
                    z: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
        """One posterior step at sampling step ``t`` (an int, or one step
        per row as a (B,) tensor) with latent ``z`` (B, nz) and ``noise``
        (each drawn from ``generator`` when None, z first); ``y`` is
        ignored (an unconditional policy). ``train`` puts the net in
        training mode (dropout) for the call. Returns the d_step contract
        (``ddgan.py:128-164``): sample, mean, control = c1 x0 (B, C, H, W);
        sigma, logp, logp_terminal (zeros), entropy (B,). Differentiable in
        the net and in ``log_betas``."""
        del y
        B = x.shape[0]
        t = torch.as_tensor(t, device=self.x0_coef.device).expand(B)
        if z is None:
            z = self._z(B, generator)
        self.net.train(train)
        x0_pred = self.net(x, self._ddgan_t(t), z)
        bshape = (-1,) + (1,) * (x.dim() - 1)
        control = self.x0_coef[t].reshape(bshape) * x0_pred
        mean = control + self.xt_coef[t].reshape(bshape) * x
        sigma = self.sigmas_all()[t]
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=x.device)
        sample = mean + sigma.reshape(bshape) * noise
        return {"sample": sample, "mean": mean, "sigma": sigma,
                "logp": gaussian_logp_mean(sample, mean,
                                           sigma.reshape(bshape)),
                "logp_terminal": x.new_zeros(B),
                "entropy": torch.log(sigma), "control": control.to(x.dtype)}

    def sample(self, n_sample: int, generator: Optional[torch.Generator] = None,
               x0: Optional[torch.Tensor] = None,
               eps: Optional[torch.Tensor] = None,
               z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Full T-step trajectory from ``x0`` (drawn when None) with per-step
        latents ``z[t]`` and noise ``eps[t]`` (drawn when None), the net in
        eval mode. Returns the d_sample contract (``ddgan.py:206-238``):
        sample (B, C, H, W), l_sample (T+1, B, C, H, W), mean and control
        (T, B, C, H, W), sigma, logp and entropy (T, B), logp_terminal
        (B,) zeros."""
        device = self.log_betas.device
        if x0 is None:
            x0 = torch.randn((n_sample, *self.sample_shape),
                             generator=generator, device=device)
        xs = [x0]
        keys = ("mean", "sigma", "logp", "entropy", "control")
        traj = {k: [] for k in keys}
        for t in range(self.n_timesteps):
            out = self.sample_step(xs[-1], t,
                                   None if eps is None else eps[t],
                                   generator=generator,
                                   z=None if z is None else z[t])
            xs.append(out["sample"])
            for k in keys:
                traj[k].append(out[k])
        return {"sample": xs[-1], "l_sample": torch.stack(xs),
                **{k: torch.stack(v) for k, v in traj.items()},
                "logp_terminal": x0.new_zeros(x0.shape[0])}

    @torch.no_grad()
    def calibrate_quant(self, generator: Optional[torch.Generator] = None,
                        n_sample: int = 64, n_rounds: int = 2,
                        x0: Optional[torch.Tensor] = None,
                        eps: Optional[torch.Tensor] = None,
                        z: Optional[torch.Tensor] = None) -> None:
        """Calibrate the static activation scales of a ``quant_int8='static'``
        NCSN++ (``ddgan.py:166-204``): zero them, run ``n_rounds``
        full-precision trajectories of T steps at ``n_sample`` from fresh
        x ~ N(0, I), keeping each int8 layer's running maximum of
        ``calib_channel_scale``; then quantise the weights once
        (``prepare_int8``). ``x0`` (rounds, n, C, H, W), ``z`` (rounds, T, n,
        nz) and ``eps`` (rounds, T, n, C, H, W) inject the draws. JAX starts
        the maxima from the scales its ``net.init`` records; the port starts
        from zero."""
        device = self.log_betas.device
        net = self.net
        net.reset_quant_scales()
        net.set_calibrating(True)
        try:
            for r in range(n_rounds):
                x = (x0[r] if x0 is not None else torch.randn(
                    (n_sample, *self.sample_shape), generator=generator,
                    device=device))
                for t in range(self.n_timesteps):
                    x = self.sample_step(
                        x, t, None if eps is None else eps[r][t],
                        generator=generator,
                        z=None if z is None else z[r][t])["sample"]
        finally:
            net.set_calibrating(False)
        net.prepare_int8()
