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

``dtype=torch.bfloat16`` computes in bf16 as the JAX package does: each conv
and linear casts its fp32 weights to the compute dtype where it is used,
GroupNorm statistics follow ``gn_stats``, and each operation rounds its
result to bf16; ``softmax_f32`` keeps the attention logits and softmax in
fp32, ``softmax_nomax`` drops the softmax's max subtraction. The fused
layers run in bf16 too, as in the JAX module: K3 takes the bf16 activations
and returns bf16 (GroupNorm and SiLU in fp32, the sums rounded once), and
K2 takes the bf16 block at its single head of d = C (d = 256 at full width:
the wide attention core) with the weights cast to bf16 where they are used.
Both keep the TPU kernels' own statistics (fp32), whatever ``gn_stats``
says, as the Pallas kernels ignore ``DXMI_GN_STATS``.

int8 (``quant_int8``): ``'static'`` runs every ResnetBlock conv (conv1,
conv2, nin_shortcut), the Downsample's stride-2 conv, the Upsample's conv
and the attention blocks' 1x1s as ``QConv`` (K8) with calibrated
per-input-channel activation scales, ``True`` with per-call (dynamic)
scales; ``conv_in`` and ``conv_out`` stay in full precision, and under int8
no GN+conv pair fuses and no attention block goes through K2, where the JAX
package turns them off (``unet_small.py:271``, ``:360``).
``quant_skip_attn`` keeps the attention 1x1s and ``quant_skip_last_level``
the full-resolution decoder blocks out of int8. ``attn_impl='einsum_merged'``
runs q, k and v as one (C, 3C) product, under static int8 one K8 launch
with the block's own ``act_scale``; ``up_impl='phase'`` computes the
Upsample's conv3x3(nearest_up2(.)) by the phase decomposition, under static
int8 four K8 launches with the module's own ``act_scale``. Calibration
(``set_calibrating``) runs full-precision forwards that record the running
maxima of ``calib_channel_scale``; ``prepare_int8`` then quantises the
weights once.
"""
from __future__ import annotations

import collections
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dxmi_tpu_torch.models._layers import _conv, _linear
from dxmi_tpu_torch.ops.attn_block import attn_block, fused_attn_available
from dxmi_tpu_torch.ops.conv_fused import fused_conv_available, gn_silu_conv
from dxmi_tpu_torch.ops.groupnorm import group_norm, sigmoid
from dxmi_tpu_torch.ops.phase_up import (conv3x3_nearest_up2,
                                         prepare_phase_int8)
from dxmi_tpu_torch.ops.quant import (Int8Layer, QConv, int8_conv_apply,
                                      prepare_conv_static, record_act_scale)
from dxmi_tpu_torch.ops.trig import reduce_mod_2pi

GN_EPS = 1e-6
QUANT_MODES = (False, True, "static")
ATTN_IMPLS = ("fused", "einsum", "einsum_merged")
UP_IMPLS = ("resize", "phase")
# buffers of calibrated activation scales (a checkpoint may lack them)
QUANT_SCALE_NAMES = ("act_scale",)


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
    # in bf16 the sigmoid's three operations each round, as XLA's do
    return x * (torch.sigmoid(x) if x.dtype == torch.float32 else sigmoid(x))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC view of an NCHW tensor (copies unless channels_last)."""
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def _nchw(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 3, 1, 2)


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0)


def _conv_layer(quant, cin: int, cout: int, k: int, dtype: torch.dtype,
                stride: int = 1, padding: int = 1) -> nn.Conv2d:
    """An ``nn.Conv2d``, or under ``quant`` (True or 'static') a ``QConv``
    with outputs in ``dtype`` (the same parameters)."""
    if quant:
        return QConv(cin, cout, static_act=quant == "static", out_dtype=dtype,
                     kernel_size=k, stride=stride, padding=padding)
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32), eps 1e-6, fp32 affine parameters and an optional fused
    SiLU, through K1; statistics by ``gn_stats``; the output keeps the
    input's dtype."""

    def __init__(self, channels: int, gn_stats: str = "fp32"):
        super().__init__(32, channels, eps=GN_EPS)
        self.gn_stats = gn_stats

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        return _nchw(group_norm(_nhwc(x), self.weight, self.bias,
                                self.num_groups, self.eps, silu,
                                self.gn_stats))


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
                 masks: Optional[DropoutMasks] = None, quant=False,
                 dtype: torch.dtype = torch.float32, gn_stats: str = "fp32"):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels, gn_stats)
        self.conv1 = _conv_layer(quant, in_channels, out_channels, 3, dtype)
        self.temb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm32(out_channels, gn_stats)
        self.dropout = Dropout(dropout, masks or DropoutMasks())
        self.conv2 = _conv_layer(quant, out_channels, out_channels, 3, dtype)
        if in_channels != out_channels:
            self.nin_shortcut = _conv_layer(quant, in_channels, out_channels,
                                            1, dtype, padding=0)
        # the JAX block fuses only when it does not quantise (:271)
        self.fuse_gn_conv = fuse_gn_conv and not quant

    def _gn_conv(self, x, norm, conv, dropout: bool = False):
        # the GN+conv pair fuses only while dropout is inactive
        if (self.fuse_gn_conv
                and fused_conv_available(conv.in_channels, conv.out_channels,
                                         x.shape[-1])
                and not (dropout and self.training and self.dropout.p > 0)):
            return _nchw(gn_silu_conv(_nhwc(x), norm.weight, norm.bias,
                                      _hwio(conv), conv.bias, 32, GN_EPS))
        h = norm(x, silu=True)
        return _conv(conv, self.dropout(h) if dropout else h)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self._gn_conv(x, self.norm1, self.conv1)
        h = h + _linear(self.temb_proj, swish(temb))[:, :, None, None]
        h = self._gn_conv(h, self.norm2, self.conv2, dropout=True)
        if hasattr(self, "nin_shortcut"):
            x = _conv(self.nin_shortcut, x)
        return x + h


class AttnBlock(Int8Layer, nn.Module):
    """Single-head self-attention over the flattened map. ``attn_impl``
    'fused' runs the whole block through K2 where ``fused_attn_available``
    admits the shape and the block does not quantise (K7 when the batch
    block ``block_b``, or ``DXMI_FUSED_ATTN_BB`` when None, clamps above 1);
    elsewhere GN goes through K1 and the products through torch.matmul, as
    the JAX einsum paths do: 'einsum' (and 'fused' under int8) projects q,
    k and v one by one (``QConv``s under ``quant``), 'einsum_merged' as one
    (C, 3C) product, under ``quant='static'`` a W8A8 one (K8) with the
    block's own ``act_scale`` (``unet_small.py:400-429``)."""

    def __init__(self, channels: int, attn_impl: str = "fused",
                 block_b: Optional[int] = None, quant=False,
                 dtype: torch.dtype = torch.float32, softmax_f32: bool = True,
                 softmax_nomax: bool = False, gn_stats: str = "fp32"):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.norm = GroupNorm32(channels, gn_stats)
        self.merged = attn_impl == "einsum_merged" and quant in (False,
                                                                 "static")
        # the merged product is one W8A8 matmul; the 1x1s stay plain there
        split_quant = False if self.merged else quant
        self.q, self.k, self.v, self.proj_out = (
            _conv_layer(split_quant if name != "proj_out" else quant,
                        channels, channels, 1, dtype, padding=0)
            for name in ("q", "k", "v", "proj_out"))
        self.attn_impl = attn_impl
        self.block_b = block_b
        self.quant = quant
        self.softmax_f32 = softmax_f32
        self.softmax_nomax = softmax_nomax
        self.int8 = self.merged and quant == "static"
        if self.int8:
            self.register_buffer("act_scale", torch.zeros(channels))

    @staticmethod
    def _mat(conv: nn.Conv2d) -> torch.Tensor:
        """(Cin, Cout) matrix of a 1x1 conv."""
        return conv.weight[:, :, 0, 0].t()

    def _qkv_mats(self):
        w = torch.cat([self._mat(self.q), self._mat(self.k),
                       self._mat(self.v)], dim=1)
        return w, torch.cat([self.q.bias, self.k.bias, self.v.bias])

    def quantise_int8(self):
        if not self.int8:
            return None
        w, _ = self._qkv_mats()
        C = w.shape[0]
        return prepare_conv_static(w.float().reshape(1, 1, C, 3 * C),
                                   self.act_scale)

    def _project(self, conv: nn.Conv2d, h: torch.Tensor,
                 shape) -> torch.Tensor:
        """A 1x1 conv of ``h`` (B, S, C): W8A8 through its ``QConv``, else a
        product in ``h``'s dtype."""
        if isinstance(conv, QConv):
            B, C, H, W = shape
            y = conv(h.reshape(B, H, W, C).permute(0, 3, 1, 2))
            return _nhwc(y).reshape(B, H * W, -1)
        return h @ self._mat(conv).to(h.dtype) + conv.bias.to(h.dtype)

    def _softmax(self, logits: torch.Tensor, acc: torch.dtype,
                 dt: torch.dtype) -> torch.Tensor:
        logits = logits.to(acc)
        if self.softmax_nomax:
            e = torch.exp(logits)
            return (e / e.sum(dim=-1, keepdim=True,
                              dtype=torch.float32).to(acc)).to(dt)
        return torch.softmax(logits, dim=-1).to(dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        S, dt = H * W, x.dtype
        if (self.attn_impl == "fused" and not self.quant
                and fused_attn_available(S, C, 1)):
            # the weights in the compute dtype, as _pallas_forward casts them
            w_qkv, b_qkv = self._qkv_mats()
            y = attn_block(_nhwc(x).reshape(B, S, C), self.norm.weight,
                           self.norm.bias, w_qkv.to(dt), b_qkv.to(dt),
                           self._mat(self.proj_out).to(dt).contiguous(),
                           self.proj_out.bias.to(dt), num_heads=1,
                           eps=GN_EPS, block_b=self.block_b)
            return _nchw(y.reshape(B, H, W, C))
        h = _nhwc(self.norm(x)).reshape(B, S, C)
        if self.merged:
            w_qkv, b_qkv = self._qkv_mats()
            if self.int8 and not self.calibrating:
                qkv = int8_conv_apply(h.reshape(-1, 1, 1, C).contiguous(),
                                      self.int8_operands(), b_qkv.float(),
                                      ((0, 0), (0, 0)), dt).reshape(B, S,
                                                                    3 * C)
            else:
                if self.int8:
                    record_act_scale(self.act_scale,
                                     h.reshape(B, H, W, C).permute(0, 3, 1,
                                                                   2))
                qkv = h @ w_qkv.to(dt) + b_qkv.to(dt)
            q, k, v = qkv.split(C, dim=-1)
        else:
            q, k, v = (self._project(conv, h, x.shape)
                       for conv in (self.q, self.k, self.v))
        acc = torch.float32 if self.softmax_f32 else dt
        # the Python scale enters XLA's arithmetic in the logits' dtype
        logits = (q.to(acc) @ k.to(acc).transpose(1, 2)
                  * torch.tensor(C ** -0.5, dtype=acc))
        a = self._softmax(logits, acc, dt) @ v
        a = self._project(self.proj_out, a, x.shape)
        return x + _nchw(a.reshape(B, H, W, C))


class Downsample(nn.Module):
    def __init__(self, channels: int, with_conv: bool = True, quant=False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if with_conv:
            self.conv = _conv_layer(quant, channels, channels, 3, dtype,
                                    stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not hasattr(self, "conv"):
            return F.avg_pool2d(x, 2)
        # asymmetric (0, 1) pad, then a stride-2 VALID conv (under int8:
        # K8's stride-2 form, its scale calibrated on the padded map)
        x = F.pad(x, (0, 1, 0, 1)).contiguous(memory_format=torch.channels_last)
        return _conv(self.conv, x)


class Upsample(Int8Layer, nn.Module):
    """Nearest x2, then a 3x3 conv (``QConv`` under ``quant``); with
    ``up_impl='phase'`` the conv3x3(nearest_up2(.)) by the phase
    decomposition, under ``quant='static'`` as four K8 launches with the
    module's own ``act_scale`` (dynamic int8 leaves it in full precision, as
    the JAX module does, ``unet_small.py:500-517``)."""

    def __init__(self, channels: int, with_conv: bool = True, quant=False,
                 dtype: torch.dtype = torch.float32, up_impl: str = "resize"):
        super().__init__()
        if up_impl not in UP_IMPLS:
            raise ValueError(f"up_impl={up_impl!r}, expected one of "
                             f"{UP_IMPLS}")
        self.phase = with_conv and up_impl == "phase"
        if self.phase:
            self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        elif with_conv:
            self.conv = _conv_layer(quant, channels, channels, 3, dtype)
        self.int8 = self.phase and quant == "static"
        if self.int8:
            self.register_buffer("act_scale", torch.zeros(channels))

    def quantise_int8(self):
        return (prepare_phase_int8(self.conv.weight, self.act_scale)
                if self.int8 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.phase:
            w, b = self.conv.weight, self.conv.bias
            if self.int8 and not self.calibrating:
                return conv3x3_nearest_up2(x, w, b, x.dtype,
                                           prepared=self.int8_operands())
            if self.int8:
                record_act_scale(self.act_scale, x)
            return conv3x3_nearest_up2(x, w, b, x.dtype)
        x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return _conv(self.conv, x) if hasattr(self, "conv") else x


class NetControls:
    """The calibration and dropout controls of a net, mixed in before its
    ``nn.Module`` base; the net sets ``self.dropout_masks`` (a
    ``DropoutMasks`` its ``Dropout`` layers share)."""

    def _int8_layers(self):
        return [m for m in self.modules() if isinstance(m, Int8Layer)]

    def set_calibrating(self, on: bool) -> None:
        """Switch every static int8 layer into (or out of) calibration:
        full-precision forwards that record activation scales. Switching it
        on drops the weights that ``prepare_int8`` quantised."""
        for m in self._int8_layers():
            m.calibrating = on
            if on:
                m.clear_int8()

    def reset_quant_scales(self) -> None:
        """Zero every calibrated activation scale (an uncalibrated net)."""
        for name, buf in self.named_buffers():
            if name.endswith(QUANT_SCALE_NAMES):
                buf.zero_()

    def prepare_int8(self) -> None:
        """Quantise the int8 layers' weights with the current scales once,
        so that forwards reuse them; call again after changing either in
        place."""
        for m in self._int8_layers():
            m.prepare_int8()

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


class UNetSmall(NetControls, nn.Module):
    """DDPM CIFAR U-Net. ``forward(x_nchw, t) -> eps_nchw`` fp32
    (channels_last).

    Constructor arguments follow the reference (and ``dxmi_tpu``) config:
    ch, out_ch, ch_mult, num_res_blocks, attn_resolutions, dropout,
    resamp_with_conv, in_channels, resolution; then the JAX module's
    compute options (``dtype``, ``softmax_f32``, ``softmax_nomax``,
    ``quant_int8``, ``quant_skip_attn``, ``quant_skip_last_level``,
    ``fuse_gn_conv``, ``attn_impl``, ``up_impl``) with the port's defaults
    (fused), ``gn_stats`` (the JAX package's ``DXMI_GN_STATS``) and
    ``block_b``, the attention blocks' batch block (``AttnBlock``)."""

    def __init__(self, ch: int = 128, out_ch: int = 3,
                 ch_mult: Sequence[int] = (1, 2, 2, 2),
                 num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (16,),
                 dropout: float = 0.0, in_channels: int = 3,
                 resolution: int = 32, fuse_gn_conv: bool = True,
                 attn_impl: str = "fused", block_b: Optional[int] = None,
                 resamp_with_conv: bool = True,
                 dtype: torch.dtype = torch.float32, softmax_f32: bool = True,
                 softmax_nomax: bool = False, quant_int8=False,
                 quant_skip_attn: bool = False,
                 quant_skip_last_level: bool = False, up_impl: str = "resize",
                 gn_stats: str = "fp32"):
        super().__init__()
        if quant_int8 not in QUANT_MODES:
            raise ValueError(f"quant_int8={quant_int8!r}, expected one of "
                             f"{QUANT_MODES}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype {dtype}: fp32 or bf16")
        self.dropout_masks = DropoutMasks()
        self.ch = ch
        self.resolution = resolution
        self.num_resolutions = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.dtype = dtype
        temb_ch = ch * 4
        attn_quant = False if quant_skip_attn else quant_int8
        blk = dict(temb_channels=temb_ch, dropout=dropout,
                   fuse_gn_conv=fuse_gn_conv, masks=self.dropout_masks,
                   dtype=dtype, gn_stats=gn_stats)
        attn = dict(attn_impl=attn_impl, block_b=block_b, quant=attn_quant,
                    dtype=dtype, softmax_f32=softmax_f32,
                    softmax_nomax=softmax_nomax, gn_stats=gn_stats)

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
                level.block.append(ResnetBlock(cur, ch * mult,
                                               quant=quant_int8, **blk))
                cur = ch * mult
                if res in attn_resolutions:
                    level.attn.append(AttnBlock(cur, **attn))
                skips.append(cur)
            if i_level != self.num_resolutions - 1:
                level.downsample = Downsample(cur, resamp_with_conv,
                                              quant_int8, dtype)
                skips.append(cur)
                res //= 2
            self.down.append(level)

        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(cur, cur, quant=quant_int8, **blk)
        self.mid.attn_1 = AttnBlock(cur, **attn)
        self.mid.block_2 = ResnetBlock(cur, cur, quant=quant_int8, **blk)

        up_levels = []
        for i_level in reversed(range(self.num_resolutions)):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            blk_quant = (False if quant_skip_last_level and i_level == 0
                         else quant_int8)
            for _ in range(num_res_blocks + 1):
                level.block.append(ResnetBlock(cur + skips.pop(),
                                               ch * ch_mult[i_level],
                                               quant=blk_quant, **blk))
                cur = ch * ch_mult[i_level]
                if res in attn_resolutions:
                    level.attn.append(AttnBlock(cur, **attn))
            if i_level != 0:
                level.upsample = Upsample(cur, resamp_with_conv, quant_int8,
                                          dtype, up_impl)
                res *= 2
            up_levels.insert(0, level)
        self.up = nn.ModuleList(up_levels)

        self.norm_out = GroupNorm32(cur, gn_stats)
        self.conv_out = nn.Conv2d(cur, out_ch, 3, padding=1)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if x.shape[2] != self.resolution or x.shape[3] != self.resolution:
            raise ValueError(f"input {tuple(x.shape)} does not match "
                             f"resolution {self.resolution}")
        dt = self.dtype
        temb = timestep_embedding(t, self.ch).to(dt)
        temb = _linear(self.temb.dense[0], temb)
        temb = _linear(self.temb.dense[1], swish(temb))

        x = x.to(dt).contiguous(memory_format=torch.channels_last)
        hs = [_conv(self.conv_in, x)]
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
        return _conv(self.conv_out, h).float()


class UNetSmallEncoder(NetControls, nn.Module):
    """The encoder half of UNetSmall with a pooled scalar head, the
    time-dependent value of the anomaly entry (``unet_small.py:633-694``):
    ``forward(x_nchw, t[, y]) -> (B, out_ch)`` fp32 (``y`` is ignored).

    conv_in, the down levels (ResnetBlocks, attention at
    ``attn_resolutions``, a Downsample between levels), mid_block_1,
    mid_attn_1, mid_block_2, then the head: fp32 GroupNorm(32) with eps
    1e-5 (flax's ``nn.GroupNorm``, no Pallas kernel in the JAX package:
    ``F.group_norm``), SiLU, the spatial mean and a 1x1 conv. The names are
    UNetSmall's (``temb.dense.0``, ``down.0.block.0``, ``mid.attn_1``) plus
    ``out_norm`` and ``out_conv``. ``fuse_gn_conv`` and ``attn_impl`` switch
    K3 and K2 as in UNetSmall, with its defaults."""

    def __init__(self, ch: int = 128, out_ch: int = 1,
                 ch_mult: Sequence[int] = (1, 2, 2, 2),
                 num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (16,),
                 dropout: float = 0.0, in_channels: int = 3,
                 resolution: int = 32, fuse_gn_conv: bool = True,
                 attn_impl: str = "fused", block_b: Optional[int] = None,
                 resamp_with_conv: bool = True,
                 dtype: torch.dtype = torch.float32,
                 softmax_f32: bool = True):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype {dtype}: fp32 or bf16")
        self.dropout_masks = DropoutMasks()
        self.ch, self.resolution, self.dtype = ch, resolution, dtype
        self.num_resolutions = len(ch_mult)
        temb_ch = ch * 4
        blk = dict(temb_channels=temb_ch, dropout=dropout,
                   fuse_gn_conv=fuse_gn_conv, masks=self.dropout_masks,
                   dtype=dtype)
        attn = dict(attn_impl=attn_impl, block_b=block_b, dtype=dtype,
                    softmax_f32=softmax_f32)
        self.temb = nn.Module()
        self.temb.dense = nn.ModuleList([nn.Linear(ch, temb_ch),
                                         nn.Linear(temb_ch, temb_ch)])
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)
        cur, res = ch, resolution
        self.down = nn.ModuleList()
        for i_level, mult in enumerate(ch_mult):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlock(cur, ch * mult, **blk))
                cur = ch * mult
                if res in attn_resolutions:
                    level.attn.append(AttnBlock(cur, **attn))
            if i_level != self.num_resolutions - 1:
                level.downsample = Downsample(cur, resamp_with_conv,
                                              dtype=dtype)
                res //= 2
            self.down.append(level)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(cur, cur, **blk)
        self.mid.attn_1 = AttnBlock(cur, **attn)
        self.mid.block_2 = ResnetBlock(cur, cur, **blk)
        self.out_norm = nn.GroupNorm(32, cur, eps=1e-5)
        self.out_conv = nn.Conv2d(cur, out_ch, 1)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        del y
        if x.shape[2] != self.resolution or x.shape[3] != self.resolution:
            raise ValueError(f"input {tuple(x.shape)} does not match "
                             f"resolution {self.resolution}")
        dt = self.dtype
        t = torch.as_tensor(t, device=x.device).expand(x.shape[0])
        temb = timestep_embedding(t, self.ch).to(dt)
        temb = _linear(self.temb.dense[0], temb)
        temb = _linear(self.temb.dense[1], swish(temb))
        h = _conv(self.conv_in,
                  x.to(dt).contiguous(memory_format=torch.channels_last))
        for i_level, level in enumerate(self.down):
            for i_block, block in enumerate(level.block):
                h = block(h, temb)
                if len(level.attn):
                    h = level.attn[i_block](h)
            if i_level != self.num_resolutions - 1:
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h, temb)),
                             temb)
        h = F.silu(F.group_norm(h.float(), 32, self.out_norm.weight,
                                self.out_norm.bias, self.out_norm.eps))
        h = self.out_conv(h.mean(dim=(2, 3), keepdim=True))
        return h.flatten(1)
