"""The ADM U-Net (``dxmi_tpu.models.unet_adm.UNetADM``) in PyTorch.

FiLM (scale-shift) GroupNorm conditioning, resblock up/downsampling,
multi-head attention at selected downsample rates, class embedding. Parameter
names and the NCHW weight layout are the reference checkpoint's
(``input_blocks.1.0.in_layers.0.weight``, ``middle_block.1.qkv.weight``,
``output_blocks.2.2.conv.weight``, ``out.0.weight``, ...), so a reference
``sampler.pth`` loads with ``load_state_dict``; the qkv rows keep the
checkpoint's [3, nh, d] order. Activations run in ``torch.channels_last``.

``dtype=torch.bfloat16`` (``use_fp16`` in the configs) computes in bf16 as the
JAX package does: every conv, linear and embedding casts its weights to the
compute dtype where it is used, as flax casts its fp32 parameters on every
call, so training keeps fp32 master parameters; for sampling,
``cast_weights`` rounds them to bf16 once, which gives the same values. The
GroupNorm affine parameters stay fp32, and so do the phase-upsample convs,
whose tap sums run in fp32 before rounding. Each operation rounds its result
to bf16, as XLA does.

Kernels: every ``GroupNormADM`` goes through K1 (``gn_stats`` selects its
statistics mode); ``attn_impl='fused'`` sends each attention block whose
shape ``fused_attn_available`` admits through K2; ``'flash'`` (and ``'fused'``
where K2 does not admit the shape) sends maps that ``flash_available`` admits
through K4; everything else takes the einsum path, with a bf16 softmax when
``softmax_f32`` is False, as ``unet_adm.py:275-296``. ``'fused_train'``
(``unet_adm.py:217-224``) sends each block that ``fused_attn_bwd_available``
admits through ``fused_attn_block_train`` (K2 forward, K6 backward) and the
rest as ``'flash'`` does. Every layer is differentiable: K1 through
``GroupNormFn``, K4 through ``FlashAttention`` (K4-dkv and K4-dq backward). ``use_checkpoint`` recomputes each ResBlock in the backward
(``torch.utils.checkpoint``, the JAX package's ``nn.remat``, ``:370-371``);
dropout follows the module's ``train()`` mode. The routes are the JAX gates
alone: on the card a form the kernels do not take (K4 in fp32, K2 at some
head widths) raises instead of falling back.

int8 (``quant_int8``): ``'static'`` runs each ResBlock's two 3x3 convs as
``QConv`` with calibrated per-input-channel activation scales, the phase
up-block's conv with its own scale (four K8 launches), and, with
``quant_attn='static'`` and ``attn_impl='fused'``, every attention block that
``fused_attn_available(..., int8=True)`` admits through K5; ``True`` runs the
ResBlock convs with per-call (dynamic) activation scales. The layers that
quantise keep fp32 weights (``cast_weights`` leaves them), as the JAX package
quantises from its fp32 parameters. Calibration (``set_calibrating``) runs
the full-precision forward and records the running maxima of
``calib_channel_scale`` into the ``act_scale``, ``attn_act_scale`` and
``attn_proj_scale`` buffers; ``prepare_int8`` then quantises the weights once.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from dxmi_tpu_torch.models._layers import _conv, _linear
from dxmi_tpu_torch.ops.attention import flash_available, flash_mha
from dxmi_tpu_torch.ops.attn_block import (Int8AttnMats, attn_block,
                                           attn_block_int8,
                                           fused_attn_available,
                                           fused_attn_block_train,
                                           fused_attn_bwd_available,
                                           prep_int8_mats)
from dxmi_tpu_torch.ops.groupnorm import group_norm, sigmoid
from dxmi_tpu_torch.ops.phase_up import (conv3x3_nearest_up2,
                                         prepare_phase_int8)
from dxmi_tpu_torch.ops.quant import Int8Layer, QConv, record_act_scale
from dxmi_tpu_torch.ops.trig import reduce_mod_2pi

GN_EPS = 1e-5
ATTN_IMPLS = ("einsum", "flash", "fused", "fused_train")
UP_IMPLS = ("resize", "phase")
QUANT_MODES = (False, True, "static")
# buffers of calibrated activation scales (a checkpoint may lack them)
QUANT_SCALE_NAMES = ("act_scale", "attn_act_scale", "attn_proj_scale")


def adm_timestep_embedding(t: torch.Tensor, dim: int,
                           max_period: float = 10000.0) -> torch.Tensor:
    """ADM sinusoidal embedding, concat(cos, sin) with frequencies
    exp(-log(max_period) i / half), arguments reduced mod 2*pi first
    (rescaled EDM timesteps reach ~1100 rad)."""
    half = dim // 2
    exponents = (np.arange(half, dtype=np.float32)
                 * np.float32(-math.log(max_period) / half))
    freqs = torch.from_numpy(
        np.exp(exponents.astype(np.float64)).astype(np.float32)).to(t.device)
    r = reduce_mod_2pi(t.float()[:, None] * freqs[None, :])
    emb = torch.cat([torch.cos(r), torch.sin(r)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def silu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.silu: x * sigmoid(x), every operation rounded in bf16
    return x * sigmoid(x)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC view of an NCHW tensor (copies unless channels_last)."""
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def _nchw(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 3, 1, 2)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def _mat(conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """(Cin, Cout) matrix of a 1x1 conv, contiguous, in ``dtype``."""
    return conv.weight[:, :, 0, 0].t().to(dtype).contiguous()


class GroupNormADM(nn.GroupNorm):
    """GroupNorm(32), eps 1e-5, fp32 affine, optional fused SiLU, through
    K1; the output keeps the input's dtype."""

    def __init__(self, channels: int, gn_stats: str = "fp32"):
        super().__init__(32, channels, eps=GN_EPS)
        self.gn_stats = gn_stats

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        return _nchw(group_norm(_nhwc(x), self.weight, self.bias,
                                self.num_groups, self.eps, silu,
                                self.gn_stats))


class ResBlockADM(Int8Layer, nn.Module):
    """GN-SiLU-conv / emb FiLM / GN-SiLU-zero-conv residual block with
    optional in-block resampling; ``up_impl='phase'`` computes the up-block's
    conv3x3(nearest_up2(.)) by the phase decomposition and runs the skip 1x1
    conv on the small grid (it commutes with nearest upsampling). ``quant``
    (False, True or 'static') runs the two 3x3 convs in W8A8 int8 with
    outputs in ``dtype``: ``QConv``s, or for the phase up-block the four
    phase convs with the block's own ``act_scale`` ('static' only; dynamic
    leaves it in full precision, as the JAX block does)."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 use_scale_shift_norm: bool, up: bool = False,
                 down: bool = False, up_impl: str = "resize",
                 gn_stats: str = "fp32", dropout: float = 0.0,
                 quant: object = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        phase_up = up and up_impl == "phase"

        def conv3(cin: int, plain: bool = False) -> nn.Conv2d:
            if quant and not plain:
                return QConv(cin, out_channels, static_act=quant == "static",
                             out_dtype=dtype)
            return nn.Conv2d(cin, out_channels, 3, padding=1)

        self.in_layers = nn.ModuleList([
            GroupNormADM(channels, gn_stats), nn.SiLU(),
            conv3(channels, plain=phase_up)])
        self.emb_layers = nn.ModuleList([
            nn.SiLU(), nn.Linear(emb_channels, (2 if use_scale_shift_norm
                                                else 1) * out_channels)])
        self.out_layers = nn.ModuleList([
            GroupNormADM(out_channels, gn_stats), nn.SiLU(), nn.Dropout(dropout),
            conv3(out_channels)])
        if channels != out_channels:
            self.skip_connection = nn.Conv2d(channels, out_channels, 1)
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down, self.up_impl = up, down, up_impl
        self.phase_int8 = phase_up and quant == "static"
        if self.phase_int8:
            self.register_buffer("act_scale", torch.zeros(channels))

    def quantise_int8(self):
        if self.phase_int8:
            return prepare_phase_int8(self.in_layers[2].weight,
                                      self.act_scale)
        return None

    def _phase_up(self, h: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        conv_in = self.in_layers[2]
        if self.phase_int8 and not self.calibrating:
            return conv3x3_nearest_up2(h, conv_in.weight, conv_in.bias, dt,
                                       prepared=self.int8_operands())
        if self.phase_int8:
            record_act_scale(self.act_scale, h)
        return conv3x3_nearest_up2(h, conv_in.weight, conv_in.bias, dt)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        h = self.in_layers[0](x, silu=True)
        conv_in = self.in_layers[2]
        skip_done = False
        if self.up and self.up_impl == "phase":
            h = self._phase_up(h, dt)
            if hasattr(self, "skip_connection"):
                x = _conv(self.skip_connection, x)
                skip_done = True
            x = _upsample2x(x)
        else:
            if self.up:
                h, x = _upsample2x(h), _upsample2x(x)
            elif self.down:
                h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
            h = _conv(conv_in, h)
        emb_out = _linear(self.emb_layers[1], silu(emb))[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = self.out_layers[0](h)
            h = h * (1 + scale) + shift
        else:
            h = self.out_layers[0](h + emb_out)
        h = _conv(self.out_layers[3], self.out_layers[2](silu(h)))
        if hasattr(self, "skip_connection") and not skip_done:
            x = _conv(self.skip_connection, x)
        return x + h


class AttentionBlockADM(Int8Layer, nn.Module):
    """Multi-head self-attention over the flattened map with q and k each
    scaled by d^-1/4; the qkv 1x1 conv's output rows are [3, nh, d].
    ``quant='static'`` with ``attn_impl='fused'`` runs the maps that the
    int8 gate admits through K5 with the calibrated ``attn_act_scale``
    (post-GN) and ``attn_proj_scale`` (post-attention); while
    ``calibrating`` it runs the full-precision path (GN, qkv, flash or
    einsum, proj) and records both."""

    def __init__(self, channels: int, num_heads: int, attn_impl: str,
                 softmax_f32: bool, gn_stats: str = "fp32",
                 quant: object = False):
        super().__init__()
        self.norm = GroupNormADM(channels, gn_stats)
        self.qkv = nn.Conv2d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.softmax_f32 = softmax_f32
        self.int8 = quant == "static" and attn_impl == "fused"
        if self.int8:
            self.register_buffer("attn_act_scale", torch.zeros(channels))
            self.register_buffer("attn_proj_scale", torch.zeros(channels))

    def quantise_int8(self) -> Optional[Int8AttnMats]:
        if not self.int8:
            return None
        return prep_int8_mats(_mat(self.qkv, torch.float32),
                              _mat(self.proj_out, torch.float32),
                              self.attn_act_scale, self.attn_proj_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        S, nh, dt = H * W, self.num_heads, x.dtype
        d = C // nh
        calibrating = False
        if self.attn_impl == "fused_train" and fused_attn_bwd_available(S, C,
                                                                        nh):
            y = fused_attn_block_train(
                _nhwc(x).reshape(B, S, C), self.norm.weight, self.norm.bias,
                self.qkv.weight[:, :, 0, 0].t(), self.qkv.bias,
                self.proj_out.weight[:, :, 0, 0].t(), self.proj_out.bias, nh,
                GN_EPS)
            return _nchw(y.reshape(B, H, W, C))
        if self.int8 and fused_attn_available(S, C, nh, int8=True):
            calibrating = self.calibrating
            if not calibrating:
                y = attn_block_int8(_nhwc(x).reshape(B, S, C),
                                    self.norm.weight, self.norm.bias,
                                    self.int8_operands(),
                                    self.qkv.bias.float(),
                                    self.proj_out.bias.float(), nh, GN_EPS)
                return _nchw(y.reshape(B, H, W, C))
        elif self.attn_impl == "fused" and fused_attn_available(S, C, nh):
            y = attn_block(_nhwc(x).reshape(B, S, C), self.norm.weight,
                           self.norm.bias, _mat(self.qkv, dt),
                           self.qkv.bias.to(dt), _mat(self.proj_out, dt),
                           self.proj_out.bias.to(dt), nh, GN_EPS)
            return _nchw(y.reshape(B, H, W, C))
        h = self.norm(x)
        if calibrating:
            record_act_scale(self.attn_act_scale, h)
        qkv = _nhwc(_conv(self.qkv, h)).reshape(B, S, 3, nh, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        scale = 1.0 / math.sqrt(math.sqrt(d))
        if self.attn_impl != "einsum" and flash_available(S, d):
            a = flash_mha(q, k, v, scale * scale)
        else:
            # the Python scale enters XLA's arithmetic in the compute dtype
            sc = torch.tensor(scale, dtype=dt, device=x.device)
            acc = torch.float32 if self.softmax_f32 else dt
            logits = torch.einsum("bqhd,bkhd->bhqk", (q * sc).to(acc),
                                  (k * sc).to(acc))
            w = torch.softmax(logits, dim=-1).to(dt)
            a = torch.einsum("bhqk,bkhd->bqhd", w, v)
        a = _nchw(a.reshape(B, H, W, C))
        if calibrating:
            record_act_scale(self.attn_proj_scale, a)
        return x + _conv(self.proj_out,
                         a.contiguous(memory_format=torch.channels_last))


class Downsample(nn.Module):
    """Stride-2 3x3 conv (``conv_resample`` without ``resblock_updown``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv(self.op, x)


class Upsample(nn.Module):
    """Nearest 2x then a 3x3 conv (or its phase decomposition)."""

    def __init__(self, channels: int, up_impl: str):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.up_impl = up_impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.up_impl == "phase":
            return conv3x3_nearest_up2(x, self.conv.weight, self.conv.bias,
                                       x.dtype)
        return _conv(self.conv, _upsample2x(x))


class UNetADM(nn.Module):
    """The ADM U-Net. ``forward(x_nchw, t[, y]) -> (B, out_channels, H, W)``
    fp32. Constructor arguments follow ``dxmi_tpu``'s ``UNetADM``
    (``attention_resolutions`` are downsample rates); ``dtype`` is the
    compute dtype; ``quant_int8`` (False, True, 'static') and ``quant_attn``
    (False, 'static') select the int8 layers; ``use_checkpoint`` recomputes
    each ResBlock in the backward."""

    def __init__(self, image_size: int, in_channels: int = 3,
                 model_channels: int = 192, out_channels: int = 3,
                 num_res_blocks: int = 3,
                 attention_resolutions: Sequence[int] = (2, 4, 8),
                 dropout: float = 0.0, channel_mult: Sequence[int] = (),
                 conv_resample: bool = True,
                 num_classes: Optional[int] = None, num_heads: int = 1,
                 num_head_channels: int = -1, num_heads_upsample: int = -1,
                 use_scale_shift_norm: bool = False,
                 resblock_updown: bool = False,
                 dtype: torch.dtype = torch.float32, softmax_f32: bool = True,
                 attn_impl: str = "einsum", up_impl: str = "resize",
                 gn_stats: str = "fp32", quant_int8: object = False,
                 quant_attn: object = False, use_checkpoint: bool = False):
        super().__init__()
        if quant_int8 not in QUANT_MODES or quant_attn not in (False,
                                                               "static"):
            raise ValueError(f"quant_int8={quant_int8!r}, quant_attn="
                             f"{quant_attn!r}: expected one of {QUANT_MODES} "
                             "and False or 'static'")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl={attn_impl!r}, expected one of "
                             f"{ATTN_IMPLS}")
        if up_impl not in UP_IMPLS:
            raise ValueError(f"up_impl={up_impl!r}, expected one of {UP_IMPLS}")
        ch_mult = tuple(channel_mult) or {
            512: (1, 1, 2, 2, 4, 4), 256: (1, 1, 2, 2, 4, 4),
            128: (1, 1, 2, 3, 4), 64: (1, 2, 3, 4),
            32: (1, 2, 2, 2)}[image_size]
        self.image_size = image_size
        self.num_classes = num_classes
        self.dtype = dtype
        self.use_checkpoint = use_checkpoint
        mc = model_channels
        ted = mc * 4

        def heads(ch: int, upsample: bool) -> int:
            if num_head_channels != -1:
                return ch // num_head_channels
            if upsample and num_heads_upsample != -1:
                return num_heads_upsample
            return num_heads

        res = dict(emb_channels=ted, use_scale_shift_norm=use_scale_shift_norm,
                   up_impl=up_impl, gn_stats=gn_stats, dropout=dropout,
                   quant=quant_int8, dtype=dtype)
        attn = dict(attn_impl=attn_impl, softmax_f32=softmax_f32,
                    gn_stats=gn_stats, quant=quant_attn)

        self.time_embed = nn.ModuleList([nn.Linear(mc, ted), nn.SiLU(),
                                         nn.Linear(ted, ted)])
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, ted)

        ch = int(ch_mult[0] * mc)
        self.input_blocks = nn.ModuleList([nn.ModuleList([
            nn.Conv2d(in_channels, ch, 3, padding=1)])])
        skips = [ch]
        ds = 1
        for level, mult in enumerate(ch_mult):
            for _ in range(num_res_blocks):
                layers = nn.ModuleList([ResBlockADM(ch, out_channels=int(
                    mult * mc), **res)])
                ch = int(mult * mc)
                if ds in attention_resolutions:
                    layers.append(AttentionBlockADM(ch, heads(ch, False),
                                                    **attn))
                self.input_blocks.append(layers)
                skips.append(ch)
            if level != len(ch_mult) - 1:
                if resblock_updown:
                    down = ResBlockADM(ch, out_channels=ch, down=True, **res)
                elif conv_resample:
                    down = Downsample(ch)
                else:
                    raise NotImplementedError("conv_resample=False is not "
                                              "ported yet")
                self.input_blocks.append(nn.ModuleList([down]))
                skips.append(ch)
                ds *= 2

        self.middle_block = nn.ModuleList([
            ResBlockADM(ch, out_channels=ch, **res),
            AttentionBlockADM(ch, heads(ch, False), **attn),
            ResBlockADM(ch, out_channels=ch, **res)])

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(ch_mult))):
            for i in range(num_res_blocks + 1):
                layers = nn.ModuleList([ResBlockADM(
                    ch + skips.pop(), out_channels=int(mult * mc), **res)])
                ch = int(mult * mc)
                if ds in attention_resolutions:
                    layers.append(AttentionBlockADM(ch, heads(ch, True),
                                                    **attn))
                if level and i == num_res_blocks:
                    if resblock_updown:
                        layers.append(ResBlockADM(ch, out_channels=ch, up=True,
                                                  **res))
                    elif conv_resample:
                        layers.append(Upsample(ch, up_impl))
                    else:
                        raise NotImplementedError("conv_resample=False is "
                                                  "not ported yet")
                    ds //= 2
                self.output_blocks.append(layers)

        self.out = nn.ModuleList([GroupNormADM(ch, gn_stats), nn.SiLU(),
                                  nn.Conv2d(ch, out_channels, 3, padding=1)])

    def cast_weights(self) -> "UNetADM":
        """Round conv, linear and embedding weights to the compute dtype once
        (no-op in fp32). GroupNorm affine parameters, the phase-upsample
        convs (whose tap sums run in fp32) and the weights of the int8
        layers (quantised from fp32) stay fp32."""
        if self.dtype == torch.float32:
            return self
        keep = set()
        for m in self.modules():
            if isinstance(m, (GroupNormADM, QConv)):
                keep.update(id(p) for p in m.parameters())
            elif isinstance(m, ResBlockADM) and m.up and m.up_impl == "phase":
                keep.update(id(p) for p in m.in_layers[2].parameters())
            elif isinstance(m, Upsample) and m.up_impl == "phase":
                keep.update(id(p) for p in m.conv.parameters())
            elif isinstance(m, AttentionBlockADM) and m.int8:
                keep.update(id(p) for p in m.qkv.parameters())
                keep.update(id(p) for p in m.proj_out.parameters())
        for p in self.parameters():
            if id(p) not in keep:
                p.data = p.data.to(self.dtype)
        return self

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
        so that forwards reuse them (a forward quantises them itself when no
        cache is there); call again after changing either in place."""
        for m in self._int8_layers():
            m.prepare_int8()

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.shape[2] != self.image_size or x.shape[3] != self.image_size:
            raise ValueError(f"input {tuple(x.shape)} does not match "
                             f"image_size {self.image_size}")
        dt = self.dtype
        emb = adm_timestep_embedding(t, self.time_embed[0].in_features).to(dt)
        emb = _linear(self.time_embed[2], silu(_linear(self.time_embed[0],
                                                       emb)))
        if self.num_classes is not None:
            if y is None:
                raise ValueError("class-conditional model needs y")
            emb = emb + F.embedding(y, self.label_emb.weight.to(dt))

        h = x.to(dt).contiguous(memory_format=torch.channels_last)
        hs = []
        for layers in self.input_blocks:
            h = self._run(layers, h, emb)
            hs.append(h)
        h = self._run(self.middle_block, h, emb)
        for layers in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=1)
            h = self._run(layers, h, emb)
        h = self.out[0](h, silu=False)
        return _conv(self.out[2], silu(h)).float()

    def _run(self, layers: nn.ModuleList, h: torch.Tensor,
             emb: torch.Tensor) -> torch.Tensor:
        for layer in layers:
            if isinstance(layer, nn.Conv2d):
                h = _conv(layer, h)
            elif not isinstance(layer, ResBlockADM):
                h = layer(h)
            elif self.use_checkpoint and torch.is_grad_enabled():
                h = checkpoint(layer, h, emb, use_reentrant=False)
            else:
                h = layer(h, emb)
        return h


def create_unet_adm(image_size: int, num_channels: int, num_res_blocks: int,
                    channel_mult: str = "", class_cond: bool = False,
                    num_classes: int = 1000, use_checkpoint: bool = False,
                    attention_resolutions: str = "16", num_heads: int = 1,
                    num_head_channels: int = -1, num_heads_upsample: int = -1,
                    use_scale_shift_norm: bool = False, dropout: float = 0.0,
                    resblock_updown: bool = False, use_fp16: bool = False,
                    use_new_attention_order: bool = False,
                    learn_sigma: bool = False,
                    dtype: Optional[torch.dtype] = None,
                    softmax_f32: Optional[bool] = None,
                    quant_int8: object = False,
                    attn_impl: Optional[str] = None,
                    up_impl: Optional[str] = None,
                    quant_attn: object = None,
                    gn_stats: str = "fp32") -> UNetADM:
    """``dxmi_tpu.models.unet_adm.create_unet_adm``: the reference factory's
    arguments, with the "32,16,8" attention-resolution string turned into
    downsample rates. ``use_fp16`` selects bf16 compute with a bf16 einsum
    softmax. ``attn_impl`` defaults to ``'flash'`` in bf16 and ``'einsum'``
    in fp32, ``up_impl`` to ``'resize'``, and ``quant_attn`` to ``'static'``
    exactly when ``quant_int8 == 'static'`` and ``attn_impl == 'fused'`` (the
    JAX factory's defaults without its environment variables)."""
    cm: Tuple[int, ...] = (tuple(int(c) for c in str(channel_mult).split(","))
                           if channel_mult else ())
    attn_ds = tuple(image_size // int(r)
                    for r in str(attention_resolutions).split(","))
    if dtype is None:
        dtype = torch.bfloat16 if use_fp16 else torch.float32
    if softmax_f32 is None:
        softmax_f32 = not use_fp16
    if attn_impl is None:
        attn_impl = "flash" if use_fp16 else "einsum"
    if quant_attn is None:
        quant_attn = ("static" if quant_int8 == "static"
                      and attn_impl == "fused" else False)
    return UNetADM(
        image_size=image_size, in_channels=3, model_channels=num_channels,
        out_channels=6 if learn_sigma else 3, num_res_blocks=num_res_blocks,
        attention_resolutions=attn_ds, dropout=dropout, channel_mult=cm,
        num_classes=num_classes if class_cond else None, num_heads=num_heads,
        num_head_channels=num_head_channels,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm,
        resblock_updown=resblock_updown, dtype=dtype,
        softmax_f32=softmax_f32, attn_impl=attn_impl,
        up_impl=up_impl or "resize", gn_stats=gn_stats,
        quant_int8=quant_int8, quant_attn=quant_attn,
        use_checkpoint=use_checkpoint)


def seeded_normal_(module: nn.Module, seed: int) -> nn.Module:
    """Redraw every parameter from a seeded normal on its own device, so
    that no layer is zero (the module's own init zeroes ``out_layers.3``,
    ``proj_out`` and ``out.2``, which would make every attention block the
    identity and the net output 0). Matrices and kernels get N(0, 1/fan_in)
    with fan_in the product of all but the first axis (the embedding table
    N(0, 1)); GroupNorm scales 1 + 0.1 N(0, 1); biases 0.1 N(0, 1)."""
    devices = {p.device for p in module.parameters()}
    gens = {dev: torch.Generator(device=dev).manual_seed(seed)
            for dev in devices}
    with torch.no_grad():
        for name, p in module.named_parameters():
            z = torch.randn(p.shape, generator=gens[p.device], device=p.device,
                            dtype=torch.float32)
            if name.endswith("label_emb.weight"):
                val = z
            elif p.dim() >= 2:
                val = z * (p[0].numel() ** -0.5)
            elif _is_gn_scale(module, name):
                val = 1.0 + 0.1 * z
            else:
                val = 0.1 * z
            p.copy_(val)
    return module


def _is_gn_scale(module: nn.Module, name: str) -> bool:
    owner, _, leaf = name.rpartition(".")
    return leaf == "weight" and isinstance(module.get_submodule(owner),
                                           nn.GroupNorm)
