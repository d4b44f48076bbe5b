"""The IGEBM-style convolutional energy / value encoder
(``dxmi_tpu.models.igebm.IGEBMEncoder``, ``igebm.py:91-160``) in PyTorch.

conv stem -> 6 leaky-ReLU residual blocks (3 downsamples) -> ReLU -> spatial
sum (or adaptive-average) pool -> linear head, optional class-embedding FiLM
and learned affine output scale. Parameter names are the reference
``IGEBMEncoderV2``'s (``conv1``, ``blocks.<i>.conv1``, ``blocks.<i>.skip.0``,
``linear``, ``out_scale``), so a reference ``value.pth`` loads with
``load_state_dict``. Inputs are NCHW. ``dtype`` is the torso's compute
dtype, as the JAX module's: the parameters stay fp32, the stem and the
residual blocks (convs, class FiLM, activations, pooling) run in ``dtype``
with the weights cast where they are used, and the head (``linear``,
``out_scale``) runs in fp32 after the ReLU. Spectral normalisation is not
ported yet (``use_spectral_norm=True`` raises).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dxmi_tpu_torch.models._layers import _conv

OUT_ACTIVATIONS = {
    "linear": lambda x: x, "relu": F.relu, "sigmoid": torch.sigmoid,
    "softplus": F.softplus, "tanh": torch.tanh, "swish": F.silu,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.2)}


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return F.leaky_relu(x, 0.2)
    # XLA's bf16 form: the slope enters rounded to bf16, the product rounds
    return torch.where(x >= 0, x, x * torch.tensor(0.2, dtype=x.dtype))


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2. In bf16 as XLA on the CPU runs flax's
    ``avg_pool``: the window summed in row-major order, each add rounded,
    then divided by 4."""
    if x.dtype == torch.float32:
        return F.avg_pool2d(x, 2)
    s = x[:, :, 0::2, 0::2] + x[:, :, 0::2, 1::2]
    s = s + x[:, :, 1::2, 0::2]
    return (s + x[:, :, 1::2, 1::2]) / 4


class ResBlockEBM(nn.Module):
    """conv3 -> (class FiLM) -> lrelu -> conv3 -> (class FiLM) -> + skip ->
    (avgpool 2 when downsampling) -> lrelu (``igebm.py:24-82``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 n_class: Optional[int] = None, downsample: bool = False):
        super().__init__()
        bias = n_class is None
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                               bias=bias)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                               bias=bias)
        self.n_class = n_class
        if n_class is not None:
            self.class_embed = nn.Embedding(n_class, out_channels * 4)
            with torch.no_grad():
                self.class_embed.weight.zero_()
                self.class_embed.weight[:, :out_channels * 2] = 1.0
        if in_channels != out_channels or downsample:
            self.skip = nn.Sequential(nn.Conv2d(in_channels, out_channels, 1,
                                                bias=False))
        self.downsample = downsample

    def forward(self, x: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = _conv(self.conv1, x)
        if self.n_class is not None:
            w1, w2, b1, b2 = self.class_embed(y).to(x.dtype)[
                :, :, None, None].chunk(4, 1)
            out = w1 * out + b1
        out = _conv(self.conv2, leaky_relu(out))
        if self.n_class is not None:
            out = w2 * out + b2
        out = out + (_conv(self.skip[0], x) if hasattr(self, "skip") else x)
        if self.downsample:
            out = avg_pool2(out)
        return leaky_relu(out)


class IGEBMEncoder(nn.Module):
    """``forward(x_nchw[, y]) -> (B, out_chan)`` fp32."""

    def __init__(self, in_chan: int = 3, out_chan: int = 1,
                 n_class: Optional[int] = None,
                 use_spectral_norm: bool = False, keepdim: bool = True,
                 out_activation: str = "linear", avg_pool_dim: int = 1,
                 learn_out_scale: bool = False, nh: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype {dtype}: fp32 or bf16")
        self.dtype = dtype
        if use_spectral_norm:
            raise NotImplementedError(
                "IGEBMEncoder use_spectral_norm=True: not ported yet "
                "(ROADMAP.md, the CIFAR-10 training slice)")
        if out_activation not in OUT_ACTIVATIONS:
            raise ValueError(f"unknown out_activation: {out_activation}")
        self.conv1 = nn.Conv2d(in_chan, nh, 3, padding=1)
        specs = [(nh, nh, True), (nh, nh, False), (nh, 2 * nh, True),
                 (2 * nh, 2 * nh, False), (2 * nh, 2 * nh, True),
                 (2 * nh, 2 * nh, False)]
        self.blocks = nn.ModuleList(
            [ResBlockEBM(i, o, n_class, down) for i, o, down in specs])
        self.keepdim = keepdim
        self.avg_pool_dim = avg_pool_dim
        self.linear = (nn.Conv2d(2 * nh, out_chan, 1) if keepdim
                       else nn.Linear(2 * nh, out_chan))
        if learn_out_scale:
            self.out_scale = nn.Linear(1, 1)
        self.out_activation = out_activation

    def forward(self, x: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = leaky_relu(_conv(self.conv1, x.to(self.dtype)))
        for block in self.blocks:
            out = block(out, y)
        out = F.relu(out).float()
        if self.keepdim:
            out = F.adaptive_avg_pool2d(out, self.avg_pool_dim)
            # flattened in the JAX package's (h, w, c) order
            out = self.linear(out).permute(0, 2, 3, 1).flatten(1)
        else:
            out = self.linear(out.sum(dim=(2, 3)))
        if hasattr(self, "out_scale"):
            out = self.out_scale(out)
        return OUT_ACTIVATIONS[self.out_activation](out)
