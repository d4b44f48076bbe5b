"""The Wide-ResNet value net (``dxmi_tpu.models.wideresnet.WideResNet``,
``wideresnet.py:1-84``; the target of configs/lsun/T4_wide.yaml) in PyTorch.

A 3x3 stem conv (16 channels), three groups of ``(depth - 4) / 6``
pre-activation ``WideBasic`` blocks of widths 16k, 32k and 64k (k the widen
factor; the stride 2 in ``conv2`` of the first block of groups 2 and 3, a
1x1 ``shortcut`` wherever the width or the stride changes), then GroupNorm
and SiLU, the mean over H and W and a ``linear`` head. ``norm: group<G>``
is flax's ``nn.GroupNorm``: G groups, eps 1e-6. Parameter names are the
flax module paths joined with dots (``block2_0.norm1.weight``,
``block2_0.shortcut.weight``, ``linear.bias``), as the JAX package's net
has no reference layout.

The norms run ``F.group_norm``: the JAX net uses flax's ``nn.GroupNorm``,
no Pallas kernel, and its native backward keeps only the statistics, where
K1's gradient would recompute a plain fp32 graph of the whole 256x256 map.
The net computes in fp32, the JAX module's default dtype (no config sets
another). Dropout runs only when ``deterministic=False`` is passed, as the
JAX module, whose callers never pass it. Inputs are NCHW; the output is
(B, num_classes) fp32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-6  # flax nn.GroupNorm's default


def norm_groups(norm: Optional[str]) -> Optional[int]:
    """The group count of a ``norm`` option (``group4`` -> 4, ``group`` ->
    32), None for no norm; other norms raise, as in the JAX net."""
    if norm is None or norm == "none":
        return None
    if norm.startswith("group"):
        return int(norm[len("group"):] or 32)
    raise ValueError(f"unsupported norm: {norm}")


def _norm(groups: Optional[int], channels: int) -> nn.Module:
    """flax ``nn.GroupNorm(num_groups=groups)`` (eps 1e-6), or none."""
    return (nn.Identity() if groups is None
            else nn.GroupNorm(groups, channels, eps=GN_EPS))


class WideBasic(nn.Module):
    """norm1 -> SiLU -> conv1 -> dropout -> norm2 -> SiLU -> conv2 (stride)
    plus the input, through ``shortcut`` where the width or stride
    changes."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 dropout: float = 0.0, norm: Optional[str] = "group4"):
        super().__init__()
        groups = norm_groups(norm)
        self.norm1 = _norm(groups, in_features)
        self.conv1 = nn.Conv2d(in_features, features, 3, padding=1)
        self.norm2 = _norm(groups, features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride,
                               padding=1)
        if in_features != features or stride != 1:
            self.shortcut = nn.Conv2d(in_features, features, 1, stride=stride)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, deterministic: bool = True
                ) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if not deterministic and self.dropout > 0:
            h = F.dropout(h, self.dropout, training=True)
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "shortcut"):
            x = self.shortcut(x)
        return x + h


class WideResNet(nn.Module):
    """``forward(x_nchw) -> (B, num_classes)`` fp32."""

    def __init__(self, depth: int = 16, widen_factor: int = 10,
                 num_classes: int = 1, dropout: float = 0.0,
                 norm: Optional[str] = "group4", in_chan: int = 3):
        super().__init__()
        if (depth - 4) % 6:
            raise ValueError(f"depth {depth}: must be 6n+4")
        n = (depth - 4) // 6
        widths = [16, 16 * widen_factor, 32 * widen_factor, 64 * widen_factor]
        self.conv1 = nn.Conv2d(in_chan, widths[0], 3, padding=1)
        ch = widths[0]
        for group, width in enumerate(widths[1:], start=1):
            for i in range(n):
                stride = 2 if (group > 1 and i == 0) else 1
                self.add_module(f"block{group}_{i}",
                                WideBasic(ch, width, stride, dropout, norm))
                ch = width
        self.blocks = [f"block{g}_{i}" for g in (1, 2, 3) for i in range(n)]
        self.norm_out = _norm(norm_groups(norm), ch)
        self.linear = nn.Linear(ch, num_classes)

    def forward(self, x: torch.Tensor, deterministic: bool = True
                ) -> torch.Tensor:
        h = self.conv1(x.float())
        for name in self.blocks:
            h = getattr(self, name)(h, deterministic)
        return self.linear(F.silu(self.norm_out(h)).mean(dim=(2, 3)))
