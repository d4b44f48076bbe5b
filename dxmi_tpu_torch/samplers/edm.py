"""EDM Euler-ancestral policy, the DxMI sampler for ImageNet64 and LSUN
(``dxmi_tpu.samplers.edm``: ``KarrasDenoiser`` and ``EDMSampler``) in PyTorch.

Karras rho-spaced sigma grid, ancestral sigma_down/sigma_up split, trainable
per-step noise ``log_betas`` initialised from log(clamp(sigma_up, 1e-3)),
``fix_last``/``fix_last3`` masks restoring the analytic terminal sigmas, and
the 1e-4 sigma floor for the log-probability. The T-step loop is a Python
loop of network forwards; samples are NCHW. Noise and labels come from an
explicit ``torch.Generator`` or are injected (``x0``, per-step ``eps``, ``y``),
which is how the tests hold the port against the JAX package. ``sample``
returns the per-step trajectory (``l_sample``, ``mean``, ``sigma``, ``logp``,
``entropy``) that the trainers' buffer consumes; ``sample_step`` is the
differentiable policy step of the sampler update.
``calibrate_quant`` calibrates the static int8 layers of the net.
``karras_sample`` is the JAX package's standalone EDM solvers (heun, euler,
ancestral, onestep, dpm, multistep, progdist).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from dxmi_tpu_torch.samplers.var import gaussian_logp_mean
from dxmi_tpu_torch.schedules import (ancestral_split, edm_rescaled_t,
                                      edm_scalings, karras_schedule,
                                      karras_sigmas)

KARRAS_SAMPLERS = ("onestep", "heun", "euler", "ancestral", "dpm",
                   "multistep", "progdist")


class KarrasDenoiser:
    """EDM preconditioning: ``scalings`` and ``denoise``, with the
    consistency-model boundary condition when ``distillation``."""

    def __init__(self, sigma_data: float = 0.5, sigma_max: float = 80.0,
                 sigma_min: float = 0.002, rho: float = 7.0,
                 weight_schedule: str = "uniform", distillation: bool = False,
                 loss_norm: str = "l2"):
        self.sigma_data = sigma_data
        self.sigma_max = sigma_max
        self.sigma_min = sigma_min
        self.rho = rho
        self.weight_schedule = weight_schedule
        self.distillation = distillation
        self.loss_norm = loss_norm

    def scalings(self, sigma: torch.Tensor):
        if not self.distillation:
            return edm_scalings(sigma, self.sigma_data)
        c_skip = self.sigma_data**2 / ((sigma - self.sigma_min) ** 2
                                       + self.sigma_data**2)
        c_out = ((sigma - self.sigma_min) * self.sigma_data
                 / torch.sqrt(sigma**2 + self.sigma_data**2))
        c_in = 1.0 / torch.sqrt(sigma**2 + self.sigma_data**2)
        return c_skip, c_out, c_in

    def denoise(self, net: nn.Module, x: torch.Tensor, sigma: torch.Tensor,
                y: Optional[torch.Tensor] = None,
                train: Optional[bool] = None):
        """-> (model output, denoised x0 estimate); ``sigma`` is (B,).
        ``train`` (the JAX package's ``train``: dropout on) puts ``net`` in
        that mode for this call alone and restores its mode after; None
        leaves the mode as it is."""
        c_skip, c_out, c_in = (s.reshape(-1, *([1] * (x.dim() - 1)))
                               for s in self.scalings(sigma))
        if train is None:
            out = net(c_in * x, edm_rescaled_t(sigma), y)
        else:
            was = net.training
            net.train(train)
            try:
                out = net(c_in * x, edm_rescaled_t(sigma), y)
            finally:
                net.train(was)
        return out, c_out * out + c_skip * x


class EDMSampler(nn.Module):
    """T-step Euler-ancestral policy over a Karras sigma grid. Parameters:
    ``net`` and ``log_betas`` (T,), the keys of a reference ``sampler.pth``.
    ``sample_shape`` is (C, H, W), as the configs give it."""

    def __init__(self, net: nn.Module, diffusion: Optional[KarrasDenoiser],
                 n_timesteps: int, sample_shape: Sequence[int],
                 class_cond: bool = False, num_classes: Optional[int] = 0,
                 trainable_beta: Union[bool, str] = False,
                 sigma_min: float = 0.002, sigma_max: float = 80.0,
                 stochastic_last: bool = False, rho: float = 7.0):
        super().__init__()
        if trainable_beta not in (True, False, "fix_last", "fix_last3"):
            raise ValueError(f"trainable_beta={trainable_beta!r}")
        self.net = net
        self.diffusion = diffusion or KarrasDenoiser(
            sigma_min=sigma_min, sigma_max=sigma_max, rho=rho)
        self.n_timesteps = int(n_timesteps)
        self.sample_shape = tuple(int(s) for s in sample_shape)
        self.class_cond = bool(class_cond)
        self.num_classes = int(num_classes or 0)
        self.trainable_beta = trainable_beta
        self.sigma_max = float(sigma_max)
        sch = karras_schedule(self.n_timesteps, sigma_min, sigma_max, rho,
                              stochastic_last=stochastic_last)
        for name in ("sigmas", "sigma_down", "sigma_up"):
            self.register_buffer(name, torch.from_numpy(getattr(sch, name)),
                                 persistent=False)
        self.log_betas = nn.Parameter(
            torch.log(torch.clamp(self.sigma_up, min=1e-3)))

    @property
    def betas_for_q_default(self) -> torch.Tensor:
        """The trainer's q-process betas: sigmas^2 (``edm.py:110-113``)."""
        return self.sigmas ** 2

    def sigmas_up_all(self) -> torch.Tensor:
        """Effective per-step injected-noise sigma (T,)."""
        if self.trainable_beta is False:
            return self.sigma_up
        sig = torch.exp(self.log_betas)
        if self.trainable_beta == "fix_last":
            sig = torch.cat([sig[:-1], self.sigma_up[-1:]])
        elif self.trainable_beta == "fix_last3":
            keep = torch.arange(self.n_timesteps, device=sig.device) \
                < self.n_timesteps - 3
            sig = torch.where(keep, sig, self.sigma_up)
        return sig

    @torch.no_grad()
    def calibrate_quant(self, generator: Optional[torch.Generator] = None,
                        n_sample: int = 8, n_rounds: int = 2,
                        x0: Optional[torch.Tensor] = None,
                        eps: Optional[torch.Tensor] = None,
                        y: Optional[torch.Tensor] = None) -> None:
        """Calibrate the static activation scales of a ``quant_int8='static'``
        net (``dxmi_tpu.samplers.edm.EDMSampler.calibrate_quant``): zero them,
        run ``n_rounds`` full-precision trajectories of T Euler-ancestral
        steps at ``n_sample`` with fresh x ~ N(0, 1) * sigma_max and fresh
        labels each round, keeping each layer's running maximum; then
        quantise the weights once (``prepare_int8``). ``x0`` (rounds, n, C,
        H, W), ``eps`` (rounds, T, n, C, H, W) and ``y`` (rounds, n) inject
        the draws, which the JAX package takes from threefry keys."""
        device = self.log_betas.device
        net = self.net
        net.reset_quant_scales()
        net.set_calibrating(True)
        try:
            for r in range(n_rounds):
                yr = None
                if self.class_cond:
                    yr = y[r] if y is not None else torch.randint(
                        0, self.num_classes, (n_sample,), generator=generator,
                        device=device)
                x = (x0[r] if x0 is not None else torch.randn(
                    (n_sample, *self.sample_shape), generator=generator,
                    device=device) * self.sigma_max)
                for t in range(self.n_timesteps):
                    x = self.sample_step(x, t, None if eps is None
                                         else eps[r][t], yr,
                                         generator)["sample"]
        finally:
            net.set_calibrating(False)
        net.prepare_int8()

    def sample_step(self, x: torch.Tensor, t: Union[int, torch.Tensor],
                    noise: Optional[torch.Tensor] = None,
                    y: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    train: bool = False) -> Dict[str, torch.Tensor]:
        """One Euler-ancestral step at sampling step ``t`` (an int, or one
        step per row as a (B,) tensor): denoise, ODE step to sigma_down, add
        sigma_up noise (``noise``, or drawn from ``generator``). Returns
        sample, mean, control (B, C, H, W) and sigma (clamped to >= 1e-4),
        logp, entropy (B,) (``edm.py:190-224``). Differentiable in the net
        and in ``log_betas`` when called with gradients on; ``train`` puts
        the net in training mode (dropout) for the call, as the JAX
        package's ``train=True``."""
        B = x.shape[0]
        t = torch.as_tensor(t, device=self.sigmas.device).expand(B)
        self.net.train(train)
        sigma = self.sigmas[t]
        _, denoised = self.diffusion.denoise(self.net, x, sigma, y)
        sigma_b = sigma[:, None, None, None]
        d = (x - denoised) / sigma_b
        dt = (self.sigma_down[t] - sigma)[:, None, None, None]
        mu = x + d * dt
        sigma_up = self.sigmas_up_all()[t]
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=x.device,
                                dtype=x.dtype)
        sample = mu + noise * sigma_up[:, None, None, None]
        sigma_out = torch.clamp(sigma_up, min=1e-4)
        return {"sample": sample, "mean": mu, "sigma": sigma_out,
                "logp": gaussian_logp_mean(sample, mu,
                                           sigma_out[:, None, None, None]),
                "logp_terminal": x.new_zeros(B),
                "entropy": torch.log(sigma_out), "control": d * dt}

    def sample(self, n_sample: int, generator: Optional[torch.Generator] = None,
               x0: Optional[torch.Tensor] = None,
               eps: Optional[torch.Tensor] = None,
               y: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Full T-step trajectory from ``x0`` (N(0, I) * sigma_max when None)
        with per-step noise ``eps[t]`` (drawn when None) and class labels
        ``y`` (uniform when None and class-conditional)."""
        device = self.log_betas.device
        if self.class_cond and y is None:
            y = torch.randint(0, self.num_classes, (n_sample,),
                              generator=generator, device=device)
        if x0 is None:
            x0 = torch.randn((n_sample, *self.sample_shape),
                             generator=generator, device=device) * self.sigma_max
        xs = [x0]
        keys = ("mean", "sigma", "logp", "entropy")
        traj = {k: [] for k in keys}
        for t in range(self.n_timesteps):
            out = self.sample_step(xs[-1], t, None if eps is None else eps[t],
                                   y, generator)
            xs.append(out["sample"])
            for k in keys:
                traj[k].append(out[k])
        return {"sample": xs[-1], "l_sample": torch.stack(xs),
                **{k: torch.stack(v) for k, v in traj.items()},
                "logp_terminal": x0.new_zeros(n_sample), "y": y}


def _f32(v) -> float:
    """The value of ``v`` rounded to fp32, as a Python float (the JAX
    package computes these step scalars in fp32)."""
    return float(np.float32(v))


@torch.no_grad()
def karras_sample(diffusion: KarrasDenoiser, net: nn.Module,
                  shape: Sequence[int], steps: int, sampler: str = "heun",
                  sigma_min: float = 0.002, sigma_max: float = 80.0,
                  rho: float = 7.0, clip_denoised: bool = True,
                  s_churn: float = 0.0, s_tmin: float = 0.0,
                  s_tmax: float = float("inf"), s_noise: float = 1.0,
                  y: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  x: Optional[torch.Tensor] = None,
                  noise: Optional[Sequence[torch.Tensor]] = None
                  ) -> torch.Tensor:
    """The standalone EDM samplers of ``dxmi_tpu.samplers.edm.karras_sample``
    (``edm.py:277-430``): ``onestep``, ``heun``, ``euler``, ``ancestral``,
    ``dpm``, ``multistep`` and ``progdist``, ``s_churn`` adding EDM's
    stochastic churn on ``heun``, ``euler`` and ``dpm``. ``shape`` is
    (B, C, H, W) and the samples are NCHW, clipped to [-1, 1]. The net runs
    in eval mode. ``x`` is the initial state (N(0, I) * sigma_max when
    None); ``noise[i]`` is step i's standard normal draw (the churn's on
    heun/euler/dpm, the injected noise on ancestral/multistep), drawn from
    ``generator`` when None."""
    if sampler not in KARRAS_SAMPLERS:
        raise ValueError(f"unknown sampler: {sampler}")
    sigmas = karras_sigmas(steps, sigma_min, sigma_max, rho)
    if x is None:
        x = torch.randn(tuple(shape), generator=generator,
                        device=next(net.parameters()).device) * sigma_max

    def draw(i: int, like: torch.Tensor) -> torch.Tensor:
        if noise is not None:
            return noise[i]
        return torch.randn(like.shape, generator=generator,
                           device=like.device, dtype=like.dtype)

    def denoise(xc: torch.Tensor, sigma: float) -> torch.Tensor:
        s = torch.full((xc.shape[0],), sigma, device=xc.device)
        den = diffusion.denoise(net, xc, s, y, train=False)[1]
        return den.clamp(-1, 1) if clip_denoised else den

    if sampler == "onestep":
        return denoise(x, float(sigmas[0]))

    def churned(xc, s_i, i):
        # EDM churn (edm.py:307-316): sigma bumped by gamma inside
        # [s_tmin, s_tmax] and matching noise added
        gamma = (min(s_churn / (len(sigmas) - 1), 2 ** 0.5 - 1)
                 if s_tmin <= s_i <= s_tmax else 0.0)
        s_hat = np.float32(s_i) * (np.float32(1.0) + np.float32(gamma))
        eps = draw(i, xc) * s_noise
        amp = np.sqrt(np.maximum(s_hat * s_hat - np.float32(s_i) ** 2,
                                 np.float32(0)))
        return xc + eps * float(amp), float(s_hat)

    if sampler in ("heun", "euler", "dpm"):
        for i in range(steps):
            s_i, s_n = float(sigmas[i]), float(sigmas[i + 1])
            xc = x
            if s_churn > 0.0:
                xc, s_i = churned(xc, s_i, i)
            d = (xc - denoise(xc, s_i)) / s_i
            if sampler == "euler" or s_n == 0.0:
                x = xc + d * _f32(s_n - s_i)
            elif sampler == "heun":
                x_e = xc + d * _f32(s_n - s_i)
                d2 = (x_e - denoise(x_e, s_n)) / s_n
                x = xc + 0.5 * (d + d2) * _f32(s_n - s_i)
            else:
                # DPM-Solver-2 midpoint in log sigma (edm.py:369-383)
                mid = _f32(np.exp(np.float32(0.5) * (
                    np.log(np.float32(s_i))
                    + np.log(np.maximum(np.float32(s_n), np.float32(1e-8))))))
                x_mid = xc + d * _f32(mid - s_i)
                d2 = (x_mid - denoise(x_mid, mid)) / mid
                x = xc + d2 * _f32(s_n - s_i)
        return x.clamp(-1, 1)

    if sampler == "ancestral":
        down, up = ancestral_split(sigmas)
        for i in range(steps):
            s_i = float(sigmas[i])
            d = (x - denoise(x, s_i)) / s_i
            x = x + d * _f32(down[i] - sigmas[i])
            x = x + draw(i, x) * float(up[i])
        return x.clamp(-1, 1)

    if sampler == "multistep":
        # the stochastic iterative sampler over its own t grid
        # (edm.py:388-411)
        ts = np.asarray([(sigma_max ** (1 / rho) + i / max(steps - 1, 1)
                          * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho)))
                         ** rho for i in range(steps)], np.float32)
        for i in range(steps):
            den = denoise(x, float(ts[i]))
            nxt = np.clip(ts[min(i + 1, steps - 1)], np.float32(sigma_min),
                          np.float32(sigma_max))
            amp = np.sqrt(np.maximum(nxt * nxt - np.float32(sigma_min ** 2),
                                     np.float32(0)))
            x = den + draw(i, den) * float(amp)
        return x.clamp(-1, 1)

    # progdist: Euler over an (steps + 1)-point grid without its zero
    # (edm.py:414-427), never stepping to sigma = 0
    sig = karras_sigmas(steps + 1, sigma_min, sigma_max, rho)[:-1]
    for i in range(steps):
        s_i, s_n = float(sig[i]), float(sig[i + 1])
        x = x + (x - denoise(x, s_i)) / s_i * _f32(s_n - s_i)
    return x.clamp(-1, 1)
