"""VAR (user-defined variance) DDPM ancestral sampler: the DxMI policy for
CIFAR-10 (``dxmi_tpu.samplers.var.VARSampler``) in PyTorch.

The T-step loop is a Python loop of network forwards. Noise comes from an
explicit ``torch.Generator`` or is injected (``x0`` and per-step ``eps``),
which is how the tests hold the port against the JAX package: the two
frameworks' random streams differ.

``trainable_beta``: True (all T sigmas learned), "fix_last" (last step pinned
to 1e-3) or False (analytic schedule sigmas, last pinned to 1e-3).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn

from dxmi_tpu_torch.schedules import var_schedule

LOG_2PI = math.log(2.0 * math.pi)


def gaussian_logp_mean(x: torch.Tensor, mean: torch.Tensor,
                       sigma: torch.Tensor) -> torch.Tensor:
    """Per-sample Normal log-density, averaged over the non-batch dims.
    ``x`` is data (detached); gradients flow through ``mean`` and
    ``sigma``."""
    x = x.detach()
    if sigma.dim() < x.dim():
        sigma = sigma.expand_as(x)
    z = (x - mean) / sigma
    logp = -0.5 * z * z - torch.log(sigma) - 0.5 * LOG_2PI
    return logp.reshape(x.shape[0], -1).mean(dim=1)


class VARSampler(nn.Module):
    """T-step DDPM policy with per-step variance ``log_betas``.

    ``sample_shape`` is (C, H, W), as the configs give it."""

    def __init__(self, net: nn.Module, n_timesteps: int,
                 sample_shape: Sequence[int],
                 trainable_beta: Union[bool, str] = True):
        super().__init__()
        if trainable_beta not in (True, False, "fix_last"):
            raise ValueError(f"trainable_beta={trainable_beta!r}")
        self.net = net
        self.n_timesteps = int(n_timesteps)
        self.sample_shape = tuple(int(s) for s in sample_shape)
        self.trainable_beta = trainable_beta
        sch = var_schedule(self.n_timesteps)
        for name in ("tau", "x_mult", "eps_mult", "sigma_q", "init_sigma",
                     "eta"):
            self.register_buffer(name, torch.from_numpy(getattr(sch, name)),
                                 persistent=False)
        self.log_betas = nn.Parameter(
            torch.log(torch.from_numpy(sch.init_sigma)))

    def sigmas_all(self) -> torch.Tensor:
        """Per-step sigma (T,), respecting ``trainable_beta``."""
        if self.trainable_beta is True:
            return torch.exp(self.log_betas)
        sig = (torch.exp(self.log_betas) if self.trainable_beta == "fix_last"
               else self.sigma_q)
        return torch.cat([sig[:-1], sig.new_full((1,), 1e-3)])

    @property
    def user_defined_eta(self) -> torch.Tensor:
        """The q-process betas (T,) that the trainer's ``use_sampler_beta``
        reads (``var.py:76-83``)."""
        return self.eta

    def sample_step(self, x: torch.Tensor, t: Union[int, torch.Tensor],
                    noise: Optional[torch.Tensor] = None,
                    y: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    train: bool = False) -> Dict[str, torch.Tensor]:
        """One ancestral step at sampling step ``t`` (an int, or one step per
        row as a (B,) tensor) with ``noise`` (drawn from ``generator`` when
        None); ``y`` is ignored (an unconditional policy). ``train`` puts the
        net in training mode (dropout) for the call, as the JAX package's
        ``train=True``. Returns the d_step contract (``var.py:111-149``):
        sample, mean, control (B, C, H, W); sigma, logp, logp_terminal,
        entropy (B,). Differentiable in the net and in ``log_betas``."""
        del y
        B = x.shape[0]
        t = torch.as_tensor(t, device=self.tau.device).expand(B)
        self.net.train(train)
        eps = self.net(x, self.tau[t])
        bshape = (-1,) + (1,) * (x.dim() - 1)
        control = self.eps_mult[t].reshape(bshape) * eps
        mean = x * self.x_mult[t].reshape(bshape) + control
        sigma = self.sigmas_all()[t]
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=x.device)
        sample = mean + sigma.reshape(bshape) * noise
        return {"sample": sample, "mean": mean, "sigma": sigma,
                "logp": gaussian_logp_mean(sample, mean,
                                           sigma.reshape(bshape)),
                "logp_terminal": x.new_zeros(B),
                "entropy": torch.log(sigma), "control": control}

    def sample(self, n_sample: int, generator: Optional[torch.Generator] = None,
               x0: Optional[torch.Tensor] = None,
               eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Full T-step trajectory from ``x0`` (drawn when None) with per-step
        noise ``eps[t]`` (drawn when None), the net in eval mode. Returns the
        d_sample contract (``var.py:161-225``): sample (B, C, H, W), l_sample
        (T+1, B, C, H, W), mean and control (T, B, C, H, W), sigma, logp and
        entropy (T, B), logp_terminal (B,)."""
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
                                   generator=generator)
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
                        eps: Optional[torch.Tensor] = None) -> None:
        """Calibrate the static activation scales of a ``quant_int8='static'``
        net (``dxmi_tpu.samplers.var.VARSampler.calibrate_quant``): zero them,
        run ``n_rounds`` full-precision trajectories of T steps at
        ``n_sample`` from fresh x ~ N(0, I), keeping each int8 layer's
        running maximum of ``calib_channel_scale``; then quantise the
        weights once (``prepare_int8``). ``x0`` (rounds, n, C, H, W) and
        ``eps`` (rounds, T, n, C, H, W) inject the draws, which the JAX
        package takes from threefry keys. JAX starts the maxima from the
        scales its ``net.init`` records; the port starts from zero."""
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
                    x = self.sample_step(x, t, None if eps is None
                                         else eps[r][t],
                                         generator=generator)["sample"]
        finally:
            net.set_calibrating(False)
        net.prepare_int8()

    def log_prob_step(self, x_prev: torch.Tensor, x_next: torch.Tensor,
                      t: Union[int, torch.Tensor]) -> torch.Tensor:
        """log p(x_next | x_prev, t) (B,) under the current policy mean with
        the schedule's initial std, the net in eval mode
        (``var.py:257-271``)."""
        B = x_prev.shape[0]
        t = torch.as_tensor(t, device=self.tau.device).expand(B)
        self.net.train(False)
        eps = self.net(x_prev, self.tau[t])
        bshape = (-1,) + (1,) * (x_prev.dim() - 1)
        mean = (x_prev * self.x_mult[t].reshape(bshape)
                + self.eps_mult[t].reshape(bshape) * eps)
        return gaussian_logp_mean(x_next, mean,
                                  self.init_sigma[t].reshape(bshape))
