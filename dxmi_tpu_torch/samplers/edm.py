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
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn

from dxmi_tpu_torch.samplers.var import gaussian_logp_mean
from dxmi_tpu_torch.schedules import (edm_rescaled_t, edm_scalings,
                                      karras_schedule)


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
                y: Optional[torch.Tensor] = None):
        """-> (model output, denoised x0 estimate); ``sigma`` is (B,)."""
        c_skip, c_out, c_in = (s.reshape(-1, *([1] * (x.dim() - 1)))
                               for s in self.scalings(sigma))
        out = net(c_in * x, edm_rescaled_t(sigma), y)
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
