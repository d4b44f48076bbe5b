"""The small DDPM U-Net (``dxmi_tpu.models.unet_small.UNetSmall``) in PyTorch.

Parameter names and the NCHW weight layout are the reference checkpoint's
(``temb.dense.0``, ``down.1.block.0.norm1``, ``mid.attn_1.q``, ``up.0.upsample``,
...), so a reference ``sampler_best.pth`` loads with ``load_state_dict``.
Activations run in ``torch.channels_last``: ``x.permute(0, 2, 3, 1)`` is then
a contiguous NHWC view, which the kernels take in the JAX package's layouts
without a copy.

The kernels carry the default configuration: ``fuse_gn_conv=True`` sends
every ResnetBlock's GN+SiLU+conv3x3 through K3, ``attn_impl='fused'`` sends
each attention block whose shape K2 admits through K2 (through K7 when the
batch block ``block_b`` or ``DXMI_FUSED_ATTN_BB`` is above 1), and every other
GroupNorm goes through K1. On CPU tensors the same calls run the kernels'
plain versions.

In training mode (``net.train()``) dropout acts after each ResnetBlock's
second GroupNorm+SiLU, as the JAX ``ResnetBlock`` does, and that GN+conv pair
is then not fused. ``inject_dropout_masks`` replays given keep masks in call
order instead of drawing them (the tests replay the JAX package's).
"""
from __future__ import annotations

import collections
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dxmi_tpu_torch.ops.attn_block import attn_block, fused_attn_available
from dxmi_tpu_torch.ops.conv_fused import fused_conv_available, gn_silu_conv
from dxmi_tpu_torch.ops.groupnorm import group_norm
from dxmi_tpu_torch.ops.trig import reduce_mod_2pi

GN_EPS = 1e-6


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding: frequencies exp(-log(10000) i/(half-1))
    built on the host (the exponent product in f32, exp in f64 rounded to
    f32), arguments reduced mod 2*pi before sin/cos."""
    half = dim // 2
    c = math.log(max_period) / (half - 1)
    exponents = np.arange(half, dtype=np.float32) * np.float32(-c)
    freqs = torch.from_numpy(
        np.exp(exponents.astype(np.float64)).astype(np.float32)).to(t.device)
    r = reduce_mod_2pi(t.float()[:, None] * freqs[None, :])
    emb = torch.cat([torch.sin(r), torch.cos(r)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC view of an NCHW tensor (copies unless channels_last)."""
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def _nchw(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 3, 1, 2)


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32) with fp32 statistics, eps 1e-6 and an optional fused
    SiLU, through K1."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=GN_EPS)

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        return _nchw(group_norm(_nhwc(x), self.weight, self.bias,
                                self.num_groups, self.eps, silu))


class DropoutMasks:
    """Keep masks to replay in call order: ``queue`` is None while dropout
    draws its own masks; those are appended to ``record`` when it is a
    list."""

    def __init__(self):
        self.queue: Optional[collections.deque] = None
        self.record: Optional[list] = None


class Dropout(nn.Dropout):
    """Dropout that replays the next injected keep mask, when ``masks`` holds
    any, as flax's ``nn.Dropout`` applies it: where(mask, h / keep, 0)."""

    def __init__(self, p: float, masks: DropoutMasks):
        super().__init__(p)
        self.masks = masks

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0:
            return h
        if self.masks.queue is None:
            if self.masks.record is None:
                return F.dropout(h, self.p, True)
            mask = torch.rand(h.shape, device=h.device) >= self.p
            self.masks.record.append(mask)
        elif not self.masks.queue:
            raise RuntimeError("dropout: no injected mask left")
        else:
            mask = self.masks.queue.popleft().to(h.device)
        if mask.shape != h.shape:
            raise ValueError(f"dropout: injected mask {tuple(mask.shape)} "
                             f"for activations {tuple(h.shape)}")
        return torch.where(mask, h / (1.0 - self.p), torch.zeros_like(h))


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 dropout: float, fuse_gn_conv: bool,
                 masks: Optional[DropoutMasks] = None):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.temb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm32(out_channels)
        self.dropout = Dropout(dropout, masks or DropoutMasks())
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1)
        self.fuse_gn_conv = fuse_gn_conv

    def _gn_conv(self, x, norm, conv, dropout: bool = False):
        # the GN+conv pair fuses only while dropout is inactive
        if (self.fuse_gn_conv
                and fused_conv_available(conv.in_channels, conv.out_channels,
                                         x.shape[-1])
                and not (dropout and self.training and self.dropout.p > 0)):
            return _nchw(gn_silu_conv(_nhwc(x), norm.weight, norm.bias,
                                      _hwio(conv), conv.bias, 32, GN_EPS))
        h = norm(x, silu=True)
        return conv(self.dropout(h) if dropout else h)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self._gn_conv(x, self.norm1, self.conv1)
        h = h + self.temb_proj(swish(temb))[:, :, None, None]
        h = self._gn_conv(h, self.norm2, self.conv2, dropout=True)
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the flattened map. ``attn_impl``
    'fused' runs the whole block through K2 where ``fused_attn_available``
    admits the shape (K7 when the batch block ``block_b``, or
    ``DXMI_FUSED_ATTN_BB`` when None, clamps above 1); elsewhere (and for
    'einsum') GN goes through K1 and the products through torch.matmul, as
    the JAX einsum path does."""

    def __init__(self, channels: int, attn_impl: str = "fused",
                 block_b: Optional[int] = None):
        super().__init__()
        if attn_impl not in ("fused", "einsum"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.norm = GroupNorm32(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)
        self.attn_impl = attn_impl
        self.block_b = block_b

    @staticmethod
    def _mat(conv: nn.Conv2d) -> torch.Tensor:
        """(Cin, Cout) matrix of a 1x1 conv."""
        return conv.weight[:, :, 0, 0].t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        S = H * W
        if self.attn_impl == "fused" and fused_attn_available(S, C, 1):
            w_qkv = torch.cat([self._mat(self.q), self._mat(self.k),
                               self._mat(self.v)], dim=1)
            b_qkv = torch.cat([self.q.bias, self.k.bias, self.v.bias])
            y = attn_block(_nhwc(x).reshape(B, S, C), self.norm.weight,
                           self.norm.bias, w_qkv, b_qkv,
                           self._mat(self.proj_out).contiguous(),
                           self.proj_out.bias, num_heads=1, eps=GN_EPS,
                           block_b=self.block_b)
            return _nchw(y.reshape(B, H, W, C))
        h = _nhwc(self.norm(x)).reshape(B, S, C)
        q = h @ self._mat(self.q) + self.q.bias
        k = h @ self._mat(self.k) + self.k.bias
        v = h @ self._mat(self.v) + self.v.bias
        w = torch.softmax((q @ k.transpose(1, 2)) * C ** -0.5, dim=-1)
        a = (w @ v) @ self._mat(self.proj_out) + self.proj_out.bias
        return x + _nchw(a.reshape(B, H, W, C))


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # asymmetric (0, 1) pad, then a stride-2 VALID conv
        x = F.pad(x, (0, 1, 0, 1)).contiguous(memory_format=torch.channels_last)
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class UNetSmall(nn.Module):
    """DDPM CIFAR U-Net. ``forward(x_nchw, t) -> eps_nchw`` (channels_last).

    Constructor arguments follow the reference (and ``dxmi_tpu``) config:
    ch, out_ch, ch_mult, num_res_blocks, attn_resolutions, dropout,
    in_channels, resolution (resampling always with a conv). ``block_b`` is
    the attention blocks' batch block (``AttnBlock``)."""

    def __init__(self, ch: int = 128, out_ch: int = 3,
                 ch_mult: Sequence[int] = (1, 2, 2, 2),
                 num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (16,),
                 dropout: float = 0.0, in_channels: int = 3,
                 resolution: int = 32, fuse_gn_conv: bool = True,
                 attn_impl: str = "fused", block_b: Optional[int] = None):
        super().__init__()
        self.dropout_masks = DropoutMasks()
        self.ch = ch
        self.resolution = resolution
        self.num_resolutions = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        temb_ch = ch * 4
        blk = dict(temb_channels=temb_ch, dropout=dropout,
                   fuse_gn_conv=fuse_gn_conv, masks=self.dropout_masks)

        self.temb = nn.Module()
        self.temb.dense = nn.ModuleList([nn.Linear(ch, temb_ch),
                                         nn.Linear(temb_ch, temb_ch)])
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)

        skips = [ch]
        cur, res = ch, resolution
        self.down = nn.ModuleList()
        for i_level, mult in enumerate(ch_mult):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlock(cur, ch * mult, **blk))
                cur = ch * mult
                if res in attn_resolutions:
                    level.attn.append(AttnBlock(cur, attn_impl, block_b))
                skips.append(cur)
            if i_level != self.num_resolutions - 1:
                level.downsample = Downsample(cur)
                skips.append(cur)
                res //= 2
            self.down.append(level)

        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(cur, cur, **blk)
        self.mid.attn_1 = AttnBlock(cur, attn_impl, block_b)
        self.mid.block_2 = ResnetBlock(cur, cur, **blk)

        up_levels = []
        for i_level in reversed(range(self.num_resolutions)):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            for _ in range(num_res_blocks + 1):
                level.block.append(ResnetBlock(cur + skips.pop(),
                                               ch * ch_mult[i_level], **blk))
                cur = ch * ch_mult[i_level]
                if res in attn_resolutions:
                    level.attn.append(AttnBlock(cur, attn_impl, block_b))
            if i_level != 0:
                level.upsample = Upsample(cur)
                res *= 2
            up_levels.insert(0, level)
        self.up = nn.ModuleList(up_levels)

        self.norm_out = GroupNorm32(cur)
        self.conv_out = nn.Conv2d(cur, out_ch, 3, padding=1)

    def inject_dropout_masks(self, masks: Optional[Sequence[torch.Tensor]]
                             ) -> None:
        """Replay ``masks`` (bool keep masks, NCHW, one per ResnetBlock in
        call order: encoder, middle, decoder) in the training-mode forwards
        that follow; None draws masks again."""
        self.dropout_masks.queue = (None if masks is None
                                    else collections.deque(masks))

    def record_dropout_masks(self, on: bool = True) -> list:
        """Keep the masks that dropout draws from now on (``on``) in the
        list returned, in call order; ``on=False`` stops and returns them."""
        got = self.dropout_masks.record
        self.dropout_masks.record = [] if on else None
        return self.dropout_masks.record if on else (got or [])

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if x.shape[2] != self.resolution or x.shape[3] != self.resolution:
            raise ValueError(f"input {tuple(x.shape)} does not match "
                             f"resolution {self.resolution}")
        temb = timestep_embedding(t, self.ch)
        temb = self.temb.dense[0](temb)
        temb = self.temb.dense[1](swish(temb))

        x = x.contiguous(memory_format=torch.channels_last)
        hs = [self.conv_in(x)]
        for i_level, level in enumerate(self.down):
            for i_block, block in enumerate(level.block):
                h = block(hs[-1], temb)
                if len(level.attn):
                    h = level.attn[i_block](h)
                hs.append(h)
            if i_level != self.num_resolutions - 1:
                hs.append(level.downsample(hs[-1]))

        h = self.mid.block_1(hs[-1], temb)
        h = self.mid.attn_1(h)
        h = self.mid.block_2(h, temb)

        for i_level in reversed(range(self.num_resolutions)):
            level = self.up[i_level]
            for i_block, block in enumerate(level.block):
                h = block(torch.cat([h, hs.pop()], dim=1), temb)
                if len(level.attn):
                    h = level.attn[i_block](h)
            if i_level != 0:
                h = level.upsample(h)

        h = self.norm_out(h, silu=True)
        return self.conv_out(h)
