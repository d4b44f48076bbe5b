"""The DDGAN generator, NCSN++ with adaptive GroupNorm and a z-mapping
network (``dxmi_tpu.models.ncsnpp.NCSNpp``), in PyTorch.

``forward(x, t, z) -> x0`` predicts the denoised image in [-1, 1] (a tanh
head) from the state ``x`` (B, C, H, W), the generator's own time index
``t`` (B,) and the latent ``z`` (B, nz).

NCSN++ has no reference PyTorch layout (the reference ships no module for
it), so parameter names follow the flax tree: ``down_{l}_block_{b}`` with
``norm1.film``, ``conv1``, ``temb_proj``, ``norm2.film``, ``conv2`` and
``shortcut``; ``down_{l}_attn_{b}`` with ``norm``, ``q``, ``k``, ``v``,
``proj_out``; ``pyramid_{l}``, ``z_mlp_{i}``, ``temb_dense{0,1}``,
``conv_in``, ``norm_out``, ``conv_out``. A flax kernel maps to ``weight``
(Dense (in, out) to (out, in), HWIO to OIHW), a GroupNorm ``scale`` to
``weight`` (``utils/convert.py::ncsnpp_from_flax``).

Every GroupNorm, the adaptive ones (no affine, ``AdaGN``) and the attention
blocks' and ``norm_out`` (affine), goes through K1 with SiLU off, eps 1e-6
and ``_num_groups(C)`` groups, fp32 statistics; the SiLU, the FiLM and the
residual sums follow in the compute dtype, as the JAX module runs them. FIR
resampling is a depthwise ``F.conv2d`` (an XLA conv in JAX, outside
Pallas), and the attention is products and a softmax in the compute dtype
(XLA einsums in JAX).

``dtype=torch.bfloat16`` computes in bf16 with fp32 parameters (cast where
used; the bias added to the rounded product), each operation rounded to
bf16; ``conv_out`` runs on the output widened to fp32. ``quant_int8``
('static' or True) runs each ResBlock's conv1, conv2 and shortcut and the
attention 1x1s as ``QConv`` (K8 on the card) with outputs in the compute
dtype; ``quant_skip_attn`` keeps the attention 1x1s in full precision;
``conv_in``, the pyramid convs and ``conv_out`` never quantise. Dropout
(``NCSNppArgs.dropout``) acts after each ResBlock's second SiLU in training
mode, with replayable masks (``inject_dropout_masks``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dxmi_tpu_torch.models._layers import _conv, _linear
from dxmi_tpu_torch.models.unet_small import (QUANT_MODES, Dropout,
                                              DropoutMasks, NetControls,
                                              _conv_layer, _nchw, _nhwc,
                                              swish, timestep_embedding)
from dxmi_tpu_torch.ops.groupnorm import group_norm
from dxmi_tpu_torch.ops.quant import QConv

GN_EPS = 1e-6


@dataclasses.dataclass
class NCSNppArgs:
    """DDGAN CIFAR-10 generator hyperparameters (the published run's
    defaults, ``dxmi_tpu/models/ncsnpp.py:28-44``)."""

    image_size: int = 32
    num_channels: int = 3
    nf: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 2, 2)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    dropout: float = 0.0
    nz: int = 100
    z_emb_dim: int = 256
    n_mlp: int = 3
    skip_rescale: bool = True
    use_tanh: bool = True


_FIR_KERNEL = np.array([1.0, 3.0, 3.0, 1.0])


def _fir_filter_2d(gain: float = 1.0) -> np.ndarray:
    k = np.outer(_FIR_KERNEL, _FIR_KERNEL)
    return (k / k.sum()).astype(np.float32) * np.float32(gain)


@functools.lru_cache(maxsize=None)
def _fir_weight(C: int, gain: float, device: torch.device,
                dtype: torch.dtype) -> torch.Tensor:
    k = torch.from_numpy(_fir_filter_2d(gain)).to(device, dtype)
    return k.expand(C, 1, 4, 4).contiguous()


def _depthwise(x: torch.Tensor, gain: float) -> torch.Tensor:
    """The FIR filter (times ``gain``) as a depthwise conv weight for ``x``,
    made once per width, device and dtype."""
    return _fir_weight(x.shape[1], gain, x.device, x.dtype)


def fir_downsample(x: torch.Tensor) -> torch.Tensor:
    """FIR antialiased 2x downsample of NCHW ``x``: a depthwise 4x4 conv at
    stride 2 over the map padded (1, 2) on each axis."""
    return F.conv2d(F.pad(x, (1, 2, 1, 2)), _depthwise(x, 1.0), stride=2,
                    groups=x.shape[1])


def fir_upsample(x: torch.Tensor) -> torch.Tensor:
    """FIR antialiased 2x upsample of NCHW ``x``: zero-stuff, pad (2, 1) on
    each axis, a depthwise 4x4 conv with gain 4."""
    B, C, H, W = x.shape
    up = x.new_zeros((B, C, 2 * H, 2 * W))
    up[:, :, ::2, ::2] = x
    return F.conv2d(F.pad(up, (2, 1, 2, 1)), _depthwise(x, 4.0), groups=C)


def _num_groups(C: int) -> int:
    """score_sde's convention: min(C // 4, 32) groups."""
    return max(min(C // 4, 32), 1)


def _rescale(h: torch.Tensor) -> torch.Tensor:
    """h / sqrt(2) in fp32: JAX divides by the numpy scalar
    ``np.sqrt(2.0)``, which is not weakly typed, so a bf16 sum comes out
    fp32 and the residual stream between the blocks of the bf16 net is
    fp32."""
    return h.float() / math.sqrt(2.0)


def _in_dtype(conv: nn.Conv2d, x: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """``conv`` of ``x`` as a flax conv of compute dtype ``dtype`` runs it:
    a full-precision conv casts x to ``dtype``; an int8 ``QConv`` takes x
    as it is (its activations are quantised from x's own values)."""
    return _conv(conv, x if isinstance(conv, QConv) else x.to(dtype))


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` in the logits' dtype: exp(x - max) rounded, its
    sum accumulated in fp32 and rounded, then the division."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True, dtype=torch.float32).to(e.dtype)


class GN(nn.Module):
    """GroupNorm through K1 (SiLU off), eps 1e-6, ``_num_groups(C)``
    groups, fp32 statistics; the output keeps the input's dtype. Without
    ``affine`` the scale and bias are ones and zeros (buffers)."""

    def __init__(self, channels: int, affine: bool = True):
        super().__init__()
        self.num_groups = _num_groups(channels)
        if affine:
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        else:
            self.register_buffer("weight", torch.ones(channels),
                                 persistent=False)
            self.register_buffer("bias", torch.zeros(channels),
                                 persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nchw(group_norm(_nhwc(x), self.weight, self.bias,
                                self.num_groups, GN_EPS, False))


class AdaGN(nn.Module):
    """GroupNorm without affine whose scale and shift come from the z
    embedding: h * (1 + scale) + shift, in the compute dtype."""

    def __init__(self, channels: int, z_emb_dim: int):
        super().__init__()
        self.gn = GN(channels, affine=False)
        self.film = nn.Linear(z_emb_dim, 2 * channels)

    def forward(self, h: torch.Tensor, zemb: torch.Tensor) -> torch.Tensor:
        scale, shift = _linear(self.film, zemb).chunk(2, dim=1)
        return (self.gn(h).to(zemb.dtype) * (1.0 + scale[:, :, None, None])
                + shift[:, :, None, None])


class ResBlockBigGAN(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, z_emb_dim: int, up: bool = False,
                 down: bool = False, dropout: float = 0.0,
                 skip_rescale: bool = True, quant=False,
                 dtype: torch.dtype = torch.float32,
                 masks: DropoutMasks = None):
        super().__init__()
        self.up, self.down, self.skip_rescale = up, down, skip_rescale
        self.dtype = dtype
        self.norm1 = AdaGN(in_channels, z_emb_dim)
        self.conv1 = _conv_layer(quant, in_channels, out_channels, 3, dtype)
        self.temb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = AdaGN(out_channels, z_emb_dim)
        self.dropout = Dropout(dropout, masks or DropoutMasks())
        self.conv2 = _conv_layer(quant, out_channels, out_channels, 3, dtype)
        if in_channels != out_channels or up or down:
            self.shortcut = _conv_layer(quant, in_channels, out_channels, 1,
                                        dtype, padding=0)

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                zemb: torch.Tensor) -> torch.Tensor:
        h = swish(self.norm1(x, zemb))
        if self.up:
            h, x = fir_upsample(h), fir_upsample(x)
        elif self.down:
            h, x = fir_downsample(h), fir_downsample(x)
        h = _conv(self.conv1, h)
        h = h + _linear(self.temb_proj, swish(temb))[:, :, None, None]
        h = self.dropout(swish(self.norm2(h, zemb)))
        h = _conv(self.conv2, h)
        if hasattr(self, "shortcut"):
            x = _in_dtype(self.shortcut, x, self.dtype)
        out = x.to(h.dtype) + h
        return _rescale(out) if self.skip_rescale else out


class AttnBlockSkip(nn.Module):
    """Single-head self-attention over the flattened map: GN (K1), 1x1 q,
    k and v (``QConv``s under ``quant``), softmax(q k^T / sqrt(C)) v,
    ``proj_out``, the residual sum."""

    def __init__(self, channels: int, skip_rescale: bool = True, quant=False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.skip_rescale, self.dtype = skip_rescale, dtype
        self.norm = GN(channels)
        self.q, self.k, self.v, self.proj_out = (
            _conv_layer(quant, channels, channels, 1, dtype, padding=0)
            for _ in range(4))

    def _project(self, conv: nn.Conv2d, h: torch.Tensor,
                 shape) -> torch.Tensor:
        """A 1x1 conv of ``h`` (B, S, C): W8A8 through its ``QConv`` (on h
        as it is), else a product in the compute dtype plus the bias."""
        B, C, H, W = shape
        if isinstance(conv, QConv):
            y = conv(h.reshape(B, H, W, C).permute(0, 3, 1, 2))
            return _nhwc(y).reshape(B, H * W, -1)
        dt = self.dtype
        return h.to(dt) @ conv.weight[:, :, 0, 0].t().to(dt) \
            + conv.bias.to(dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = _nhwc(self.norm(x)).reshape(B, H * W, C)
        q, k, v = (self._project(c, h, x.shape)
                   for c in (self.q, self.k, self.v))
        logits = (q @ k.transpose(1, 2)) * torch.tensor(C ** -0.5,
                                                        dtype=q.dtype)
        a = self._project(self.proj_out, _softmax(logits) @ v, x.shape)
        out = x.to(a.dtype) + _nchw(a.reshape(B, H, W, C))
        return _rescale(out) if self.skip_rescale else out


class NCSNpp(NetControls, nn.Module):
    """DDGAN generator: ``forward(x, t, z)`` predicts x0 from the state,
    the time index and the latent.

    ``config`` is an ``NCSNppArgs``; ``quant_int8`` False | True (dynamic
    ranges) | 'static' (calibrated ranges); ``quant_skip_attn`` keeps the
    attention 1x1s out of int8; ``dtype`` is the torso's compute dtype
    (parameters stay fp32)."""

    def __init__(self, config: NCSNppArgs = None, quant_int8=False,
                 quant_skip_attn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config or NCSNppArgs()
        if quant_int8 not in QUANT_MODES:
            raise ValueError(f"quant_int8={quant_int8!r}, expected one of "
                             f"{QUANT_MODES}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype {dtype}: fp32 or bf16")
        self.config, self.dtype = cfg, dtype
        self.dropout_masks = DropoutMasks()
        nf, ch_mult = cfg.nf, tuple(cfg.ch_mult)
        temb_ch = nf * 4
        attn_quant = False if quant_skip_attn else quant_int8
        blk = dict(temb_channels=temb_ch, z_emb_dim=cfg.z_emb_dim,
                   dropout=cfg.dropout, skip_rescale=cfg.skip_rescale,
                   quant=quant_int8, dtype=dtype, masks=self.dropout_masks)
        attn = dict(skip_rescale=cfg.skip_rescale, quant=attn_quant,
                    dtype=dtype)

        for i in range(cfg.n_mlp):
            self.add_module(f"z_mlp_{i}", nn.Linear(
                cfg.nz if i == 0 else cfg.z_emb_dim, cfg.z_emb_dim))
        self.temb_dense0 = nn.Linear(nf, temb_ch)
        self.temb_dense1 = nn.Linear(temb_ch, temb_ch)
        self.conv_in = nn.Conv2d(cfg.num_channels, nf, 3, padding=1)

        skips, cur, res = [nf], nf, cfg.image_size
        for l, mult in enumerate(ch_mult):
            for b in range(cfg.num_res_blocks):
                self.add_module(f"down_{l}_block_{b}", ResBlockBigGAN(
                    cur, nf * mult, **blk))
                cur = nf * mult
                if res in cfg.attn_resolutions:
                    self.add_module(f"down_{l}_attn_{b}",
                                    AttnBlockSkip(cur, **attn))
                skips.append(cur)
            if l != len(ch_mult) - 1:
                self.add_module(f"down_{l}_downsample", ResBlockBigGAN(
                    cur, cur, down=True, **blk))
                self.add_module(f"pyramid_{l}", nn.Conv2d(
                    cfg.num_channels, cur, 1))
                skips.append(cur)
                res //= 2
        self.mid_block_1 = ResBlockBigGAN(cur, cur, **blk)
        self.mid_attn = AttnBlockSkip(cur, **attn)
        self.mid_block_2 = ResBlockBigGAN(cur, cur, **blk)
        for l in reversed(range(len(ch_mult))):
            for b in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{l}_block_{b}", ResBlockBigGAN(
                    cur + skips.pop(), nf * ch_mult[l], **blk))
                cur = nf * ch_mult[l]
                if res in cfg.attn_resolutions:
                    self.add_module(f"up_{l}_attn_{b}",
                                    AttnBlockSkip(cur, **attn))
            if l != 0:
                self.add_module(f"up_{l}_upsample", ResBlockBigGAN(
                    cur, cur, up=True, **blk))
                res *= 2
        self.norm_out = GN(cur)
        self.conv_out = nn.Conv2d(cur, cfg.num_channels, 3, padding=1)

    def _attn(self, name: str, h: torch.Tensor) -> torch.Tensor:
        return getattr(self, name)(h) if hasattr(self, name) else h

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.config, self.dtype
        if x.shape[2] != cfg.image_size or x.shape[3] != cfg.image_size:
            raise ValueError(f"input {tuple(x.shape)} does not match "
                             f"image_size {cfg.image_size}")
        zemb = z.to(dt)
        for i in range(cfg.n_mlp):
            zemb = swish(_linear(getattr(self, f"z_mlp_{i}"), zemb))
        temb = _linear(self.temb_dense0,
                       timestep_embedding(t.float(), cfg.nf).to(dt))
        temb = _linear(self.temb_dense1, swish(temb))

        pyramid = x.contiguous(memory_format=torch.channels_last)
        h = _conv(self.conv_in, pyramid.to(dt))
        hs = [h]
        n_levels = len(cfg.ch_mult)
        for l in range(n_levels):
            for b in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{l}_block_{b}")(h, temb, zemb)
                h = self._attn(f"down_{l}_attn_{b}", h)
                hs.append(h)
            if l != n_levels - 1:
                h = getattr(self, f"down_{l}_downsample")(h, temb, zemb)
                # progressive_input='residual': the input pyramid
                pyramid = fir_downsample(pyramid)
                pyr = _conv(getattr(self, f"pyramid_{l}"), pyramid.to(dt))
                h = _rescale(h + pyr) if cfg.skip_rescale else h + pyr
                hs.append(h)
        h = self.mid_block_1(h, temb, zemb)
        h = self.mid_attn(h)
        h = self.mid_block_2(h, temb, zemb)
        for l in reversed(range(n_levels)):
            for b in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up_{l}_block_{b}")(
                    torch.cat([h, hs.pop()], dim=1), temb, zemb)
                h = self._attn(f"up_{l}_attn_{b}", h)
            if l != 0:
                h = getattr(self, f"up_{l}_upsample")(h, temb, zemb)
        h = swish(self.norm_out(h)).float()
        h = F.conv2d(h, self.conv_out.weight, self.conv_out.bias, padding=1)
        return torch.tanh(h) if cfg.use_tanh else h

