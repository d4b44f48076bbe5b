"""``TimeIndependentValue`` (``dxmi_tpu.models.value``, ``value.py:15-24``):
any image -> scalar network as the trainers' ``V(x, t[, y])``, ignoring t."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class TimeIndependentValue(nn.Module):
    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.net(x) if y is None else self.net(x, y)
