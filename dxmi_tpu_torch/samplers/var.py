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
        for name in ("tau", "x_mult", "eps_mult", "sigma_q"):
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

    def sample_step(self, x: torch.Tensor, t: int,
                    noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
        """One ancestral step at sampling step ``t``: sample, mean, control
        (B, C, H, W) and sigma (B,)."""
        B = x.shape[0]
        eps = self.net(x, self.tau[t].expand(B))
        control = self.eps_mult[t] * eps
        mean = x * self.x_mult[t] + control
        sigma = self.sigmas_all()[t]
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=x.device)
        return {"sample": mean + sigma * noise, "mean": mean,
                "sigma": sigma.expand(B), "control": control}

    def sample(self, n_sample: int, generator: Optional[torch.Generator] = None,
               x0: Optional[torch.Tensor] = None,
               eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Full T-step trajectory from ``x0`` (drawn when None) with per-step
        noise ``eps[t]`` (drawn when None). Returns sample (B, C, H, W),
        l_sample (T+1, B, C, H, W), mean (T, B, C, H, W) and sigma (T, B)."""
        device = self.log_betas.device
        if x0 is None:
            x0 = torch.randn((n_sample, *self.sample_shape),
                             generator=generator, device=device)
        xs, means, sigmas = [x0], [], []
        for t in range(self.n_timesteps):
            out = self.sample_step(xs[-1], t,
                                   None if eps is None else eps[t], generator)
            xs.append(out["sample"])
            means.append(out["mean"])
            sigmas.append(out["sigma"])
        return {"sample": xs[-1], "l_sample": torch.stack(xs),
                "mean": torch.stack(means), "sigma": torch.stack(sigmas)}
