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
``out_scale``) runs in fp32 after the ReLU.

``use_spectral_norm`` normalises the stem and every block conv (not the
head) as flax's ``nn.SpectralNorm`` does (flax 0.12,
``linen/normalization.py:1121-1180``), which is not torch's
``spectral_norm``: the HWIO kernel flattened to (-1, out); one power
iteration from the stored ``u`` (1, out) on every call, u and v out of the
gradient, sigma = v W u^T in it; the kernel divided by sigma (by 1 where
sigma is 0); biases untouched. Each such conv keeps ``u`` and ``sigma``
as buffers (``conv1.u``, ``blocks.0.skip.0.sigma``, ...), JAX's
``sn_stats`` collection; a forward stores the iterated ones only inside
``update_sn_stats(net)``, as ``update_stats=True`` does, and reads them
otherwise. ``u`` starts as a standard normal draw, ``sigma`` at 1.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

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


SN_EPS = 1e-12


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + SN_EPS)


def add_sn_stats(conv: nn.Conv2d) -> None:
    """Give ``conv`` flax's ``sn_stats`` buffers: ``u`` (1, out) drawn from
    a standard normal and ``sigma`` 1."""
    conv.register_buffer("u", torch.randn(1, conv.out_channels))
    conv.register_buffer("sigma", torch.ones(()))


def sn_weight(conv: nn.Conv2d, update: bool) -> torch.Tensor:
    """``conv``'s weight divided by its spectral norm's power-iteration
    estimate (one step from ``conv.u``); stores the new u and sigma when
    ``update``."""
    w = conv.weight
    mat = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])  # HWIO as (-1, out)
    with torch.no_grad():
        v0 = _l2_normalize(conv.u @ mat.t())
        u0 = _l2_normalize(v0 @ mat)
    sigma = (v0 @ mat @ u0.t())[0, 0]
    if update:
        with torch.no_grad():
            conv.u.copy_(u0)
            conv.sigma.copy_(sigma)
    return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


@contextlib.contextmanager
def update_sn_stats(net: nn.Module) -> Iterator[None]:
    """Forwards of the spectral-norm IGEBMs inside ``net`` store their
    power-iteration state while the context is open (flax's
    ``update_stats=True``)."""
    mods = [m for m in net.modules()
            if isinstance(m, IGEBMEncoder) and m.use_spectral_norm]
    for m in mods:
        m.update_sn = True
    try:
        yield
    finally:
        for m in mods:
            m.update_sn = False


class ResBlockEBM(nn.Module):
    """conv3 -> (class FiLM) -> lrelu -> conv3 -> (class FiLM) -> + skip ->
    (avgpool 2 when downsampling) -> lrelu (``igebm.py:24-82``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 n_class: Optional[int] = None, downsample: bool = False,
                 use_spectral_norm: bool = False):
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
        self.use_spectral_norm = use_spectral_norm
        if use_spectral_norm:
            # flax creates the SpectralNorm modules in this order
            for conv in (self.conv1, self.conv2, *(
                    self.skip if hasattr(self, "skip") else ())):
                add_sn_stats(conv)

    def _c(self, conv: nn.Conv2d, x: torch.Tensor,
           update: bool) -> torch.Tensor:
        if not self.use_spectral_norm:
            return _conv(conv, x)
        return _conv(conv, x, sn_weight(conv, update))

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                update: bool = False) -> torch.Tensor:
        out = self._c(self.conv1, x, update)
        if self.n_class is not None:
            w1, w2, b1, b2 = self.class_embed(y).to(x.dtype)[
                :, :, None, None].chunk(4, 1)
            out = w1 * out + b1
        out = self._c(self.conv2, leaky_relu(out), update)
        if self.n_class is not None:
            out = w2 * out + b2
        out = out + (self._c(self.skip[0], x, update)
                     if hasattr(self, "skip") else x)
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
        self.use_spectral_norm = use_spectral_norm
        self.update_sn = False
        if out_activation not in OUT_ACTIVATIONS:
            raise ValueError(f"unknown out_activation: {out_activation}")
        self.conv1 = nn.Conv2d(in_chan, nh, 3, padding=1)
        if use_spectral_norm:
            add_sn_stats(self.conv1)
        specs = [(nh, nh, True), (nh, nh, False), (nh, 2 * nh, True),
                 (2 * nh, 2 * nh, False), (2 * nh, 2 * nh, True),
                 (2 * nh, 2 * nh, False)]
        self.blocks = nn.ModuleList(
            [ResBlockEBM(i, o, n_class, down, use_spectral_norm)
             for i, o, down in specs])
        self.keepdim = keepdim
        self.avg_pool_dim = avg_pool_dim
        self.linear = (nn.Conv2d(2 * nh, out_chan, 1) if keepdim
                       else nn.Linear(2 * nh, out_chan))
        if learn_out_scale:
            self.out_scale = nn.Linear(1, 1)
        self.out_activation = out_activation

    def forward(self, x: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        x, sn = x.to(self.dtype), self.use_spectral_norm
        out = leaky_relu(_conv(self.conv1, x, sn_weight(
            self.conv1, self.update_sn) if sn else None))
        for block in self.blocks:
            out = block(out, y, self.update_sn)
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
