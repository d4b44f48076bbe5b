"""The 2D experiment's MLPs (``dxmi_tpu.models.mlp``, ``mlp.py:20-56``) in
PyTorch: ``EpsMLP``, the sinusoidal-t-conditioned eps policy, and
``ValueMLP``, the (x, t) value and energy.

The layers carry flax's names (``dense_<i>``, ``out``), so the flax tree
maps onto the state dict by a transpose of each kernel. Weights are drawn
as flax's ``nn.Dense`` draws them, ``lecun_normal`` (a normal truncated to
two standard deviations, of variance 1 / fan_in) with zero biases, from an
explicit ``torch.Generator``: with torch's default ``Linear`` init the 2D
recipe diverges (CONVERGENCE.md §2).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dxmi_tpu_torch.models.flax_init import lecun_normal_
from dxmi_tpu_torch.models.unet_small import timestep_embedding


def _dense(cin: int, cout: int, generator: Optional[torch.Generator]
           ) -> nn.Linear:
    lin = nn.Linear(cin, cout)
    lecun_normal_(lin.weight, generator)
    with torch.no_grad():
        lin.bias.zero_()
    return lin


class EpsMLP(nn.Module):
    """eps prediction for 2D points: ``forward(x (B, 2), t (B,))`` ->
    (B, 2)."""

    def __init__(self, hidden: Sequence[int] = (128, 128, 128),
                 in_dim: int = 2, temb_dim: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.temb_dim = temb_dim
        widths = [in_dim + temb_dim, *hidden]
        for i in range(len(hidden)):
            setattr(self, f"dense_{i}", _dense(widths[i], widths[i + 1],
                                               generator))
        self.n_hidden = len(hidden)
        self.out = _dense(widths[-1], in_dim, generator)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        temb = timestep_embedding(t.float(), self.temb_dim)
        h = torch.cat([x, temb], dim=-1)
        for i in range(self.n_hidden):
            h = F.silu(getattr(self, f"dense_{i}")(h))
        return self.out(h)


class ValueMLP(nn.Module):
    """(x, t) -> (B, 1) value / energy for 2D points; ``time_dependent``
    conditions on t's sinusoidal embedding (t may be a scalar)."""

    def __init__(self, hidden: Sequence[int] = (128, 128),
                 temb_dim: int = 32, time_dependent: bool = True,
                 in_dim: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.temb_dim = temb_dim
        self.time_dependent = time_dependent
        widths = [in_dim + (temb_dim if time_dependent else 0), *hidden]
        for i in range(len(hidden)):
            setattr(self, f"dense_{i}", _dense(widths[i], widths[i + 1],
                                               generator))
        self.n_hidden = len(hidden)
        self.out = _dense(widths[-1], 1, generator)

    def forward(self, x: torch.Tensor, t: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        del y
        h = x
        if self.time_dependent and t is not None:
            t = torch.as_tensor(t, device=x.device).float().expand(
                x.shape[0])
            h = torch.cat([x, timestep_embedding(t, self.temb_dim)], dim=-1)
        for i in range(self.n_hidden):
            h = F.silu(getattr(self, f"dense_{i}")(h))
        return self.out(h)
