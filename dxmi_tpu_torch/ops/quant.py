"""Int8 (W8A8) convolution for quantised sampling (``dxmi_tpu.ops.quant``):
the quantisers, the calibration statistic, ``QConv``, and kernel K8 (the int8
implicit-GEMM convolution) with its plain version.

Weights are quantised per output channel, symmetric, from their fp32 values;
activations either per tensor from the batch's own max (``int8_conv``,
``quant_int8=True``) or with calibrated per-input-channel scales that fold
into the weight's input axis (``int8_conv_static``, ``quant_int8='static'``):
conv(x / s, w * s) = conv(x, w). Products accumulate in int32 and are
dequantised in an fp32 epilogue, ``acc * (out_scale * wscale) + bias``, then
cast to the output dtype. Every step keeps the JAX package's operation order
(``w / scale``; ``x * (1 / s)`` per channel but ``x / s`` per tensor; round
half to even, then clip to +-127), so the int8 values come out identical.

``int8_conv_apply`` is K8's wrapper: on a CPU tensor it runs the plain
version, on a CUDA tensor it launches ``csrc/int8_conv.cu`` (or raises), at
stride 1 or 2 (the U-Net Downsample's conv; a form of its own on the card).
The plain version is exact: the int8 products summed in float64 are
integers below 2^53, so any order gives the int32 sum the kernel computes.

Layouts follow the JAX functions at the public entries (NHWC activations,
HWIO kernels); prepared int8 weights are (Cout, kh, kw, Cin), one row of
Cin bytes per output channel and tap, the layout the tensor cores read.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dxmi_tpu_torch.ops import _lib

# Calibration range statistic: 1.0 = per-channel max; below 1.0 clips
# outliers (the JAX package's measured default).
CALIB_QUANTILE: float = 0.995

Padding = Tuple[Tuple[int, int], Tuple[int, int]]
SAME_3X3: Padding = ((1, 1), (1, 1))


class QuantWeights(NamedTuple):
    """An int8 conv's prepared operands: ``w_i8`` (Cout, kh, kw, Cin) int8;
    ``dq`` (Cout,) fp32 dequantisation scales (``out_scale * wscale``);
    ``xscale`` fp32, (Cin,) reciprocal activation scales that multiply, or a
    (1,) per-tensor scale that divides (``divide``)."""
    w_i8: torch.Tensor
    dq: torch.Tensor
    xscale: torch.Tensor
    divide: bool


def quantize_per_channel(w: torch.Tensor, axis: int = -1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel -> (int8 kernel, per-``axis``-channel scale, keepdims)."""
    ax = axis % w.dim()
    red = [i for i in range(w.dim()) if i != ax]
    wmax = w.abs().amax(dim=red, keepdim=True)
    scale = torch.clamp(wmax, min=1e-8) / 127.0
    w_i8 = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_i8, scale


def quantize_per_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 x, scalar scale max(|x|) / 127)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(), min=1e-8) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def calib_channel_scale(x2d: torch.Tensor) -> torch.Tensor:
    """Per-channel activation scale from calibration rows (N, C): the
    ``CALIB_QUANTILE`` quantile of |x| over the rows / 127, floored at 1e-8.
    The quantile interpolates linearly between order statistics in fp32, as
    ``jnp.quantile`` does."""
    xf = x2d.float().abs()
    if CALIB_QUANTILE >= 1.0:
        amax = xf.amax(dim=0)
    else:
        n = xf.shape[0]
        s = torch.sort(xf, dim=0).values
        pos = (torch.tensor(CALIB_QUANTILE, dtype=torch.float32)
               * torch.tensor(n - 1, dtype=torch.float32))
        low, high = torch.floor(pos), torch.ceil(pos)
        hw = pos - low
        lw = 1.0 - hw
        amax = (s[int(low)] * lw.to(s.device)
                + s[int(high)] * hw.to(s.device))
    return torch.clamp(amax / 127.0, min=1e-8)


def record_act_scale(scale: torch.Tensor, x_nchw: torch.Tensor) -> None:
    """Calibration: scale <- max(scale, calib_channel_scale of the pixels
    of an NCHW ``x``), in place."""
    C = x_nchw.shape[1]
    scale.copy_(torch.maximum(scale, calib_channel_scale(
        x_nchw.permute(0, 2, 3, 1).reshape(-1, C))))


def _check_padding(padding: Padding, kh: int, kw: int,
                   stride: int = 1) -> Padding:
    (pt, pb), (pl, pr) = padding
    if min(pt, pb, pl, pr) < 0:
        raise ValueError(f"padding {padding}: pads must be >= 0")
    if stride == 1 and (pt + pb != kh - 1 or pl + pr != kw - 1):
        raise ValueError(f"padding {padding} with a {kh}x{kw} kernel: only "
                         "stride-1 convs whose output keeps the input's size")
    return (int(pt), int(pb)), (int(pl), int(pr))


def _stride(strides: Sequence[int]) -> int:
    """The stride of both axes, 1 or 2 (the strides K8 takes)."""
    s = tuple(int(v) for v in strides)
    if s not in ((1, 1), (2, 2)):
        raise NotImplementedError(f"int8 conv strides {s}: K8 takes stride 1"
                                  " or 2, equal on both axes")
    return s[0]


def out_size(H: int, W: int, kh: int, kw: int, padding: Padding,
             stride: int) -> Tuple[int, int]:
    """(Ho, Wo) of a VALID conv over the padded map at ``stride``."""
    (pt, pb), (pl, pr) = padding
    return ((H + pt + pb - kh) // stride + 1,
            (W + pl + pr - kw) // stride + 1)


def prepare_conv_static(kernel: torch.Tensor,
                        act_scale: torch.Tensor) -> QuantWeights:
    """Fold calibrated activation scales into an HWIO ``kernel`` and
    quantise it (``int8_conv_static``'s preparation). ``act_scale`` is
    (Cin,) (per input channel; x is quantised as x * (1 / s)) or a scalar
    (per tensor; x / s, and the scale moves into the epilogue)."""
    act_scale = act_scale.float()
    kernel = kernel.float()
    if act_scale.dim() == 1:
        kernel = kernel * act_scale.reshape(1, 1, -1, 1)
        xscale, divide, out_scale = 1.0 / act_scale, False, None
    else:
        xscale, divide, out_scale = act_scale.reshape(1), True, act_scale
    w_i8, wscale = quantize_per_channel(kernel, axis=-1)
    wscale = wscale.reshape(-1)
    dq = wscale if out_scale is None else out_scale * wscale
    return QuantWeights(w_i8.permute(3, 0, 1, 2).contiguous(), dq.contiguous(),
                        xscale.contiguous(), divide)


def int8_conv_reference(x: torch.Tensor, q: QuantWeights,
                        bias: Optional[torch.Tensor], padding: Padding,
                        out_dtype: torch.dtype, stride: int = 1
                        ) -> torch.Tensor:
    """Plain K8: quantise NHWC ``x`` elementwise, sum the int8 products of
    each tap in float64 (exact), cast to int32, dequantise in fp32, add the
    fp32 bias, cast to ``out_dtype``. Returns (B, Ho, Wo, Cout): the input's
    size at stride 1, ``out_size`` at stride 2."""
    B, H, W, _ = x.shape
    O, kh, kw, I = q.w_i8.shape
    (pt, pb), (pl, pr) = _check_padding(padding, kh, kw, stride)
    Ho, Wo = out_size(H, W, kh, kw, padding, stride)
    xf = x.float()
    xq = xf / q.xscale if q.divide else xf * q.xscale
    xi = torch.clamp(torch.round(xq), -127, 127).double()
    xp = F.pad(xi, (0, 0, pl, pr, pt, pb))
    wd = q.w_i8.double()
    acc = torch.zeros(B * Ho * Wo, O, dtype=torch.float64, device=x.device)
    for ty in range(kh):
        for tx in range(kw):
            win = xp[:, ty:ty + stride * (Ho - 1) + 1:stride,
                     tx:tx + stride * (Wo - 1) + 1:stride]
            acc += win.reshape(-1, I) @ wd[:, ty, tx].t()
    out = acc.to(torch.int32).float() * q.dq
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype).reshape(B, Ho, Wo, O)


def int8_conv_apply(x: torch.Tensor, q: QuantWeights,
                    bias: Optional[torch.Tensor], padding: Padding = SAME_3X3,
                    out_dtype: torch.dtype = torch.bfloat16,
                    stride: int = 1) -> torch.Tensor:
    """The W8A8 conv of a channels-last ``x`` (B, H, W, Cin), fp32 or bf16,
    with prepared weights; returns (B, Ho, Wo, Cout) in ``out_dtype``. On
    the card: K8, which takes kernels up to 3x3 with pads of at most 1,
    Cin a multiple of 32 and Cout of 8; at stride 1 ("int8_conv") the output
    keeps the input's size and images are at most 512 wide, at stride 2
    ("int8_conv_s2", the parity-plane form) at most 128 (others raise)."""
    if x.device.type == "cpu":
        return int8_conv_reference(x, q, bias, padding, out_dtype, stride)
    B, H, W, C = x.shape
    O, kh, kw, I = q.w_i8.shape
    (pt, pb), (pl, pr) = _check_padding(padding, kh, kw, stride)
    Ho, Wo = out_size(H, W, kh, kw, padding, stride)
    w_max = 512 if stride == 1 else 128
    if (I != C or C % 32 or O % 8 or max(pt, pb, pl, pr) > 1 or W > w_max
            or min(Ho, Wo) < 1 or stride not in (1, 2)):
        raise ValueError(f"int8_conv kernel: Cin={C} (weights {I}), Cout={O},"
                         f" {kh}x{kw} padded {padding}, stride {stride}, "
                         f"W={W}: needs Cin % 32 == 0, Cout % 8 == 0, pads "
                         f"of at most 1 and W <= {w_max}")
    for dt in (x.dtype, out_dtype):
        if dt not in (torch.float32, torch.bfloat16):
            raise ValueError(f"int8_conv kernel: dtype {dt} (fp32 or bf16)")
    dev = x.device
    _lib.require(x, "x", (B, H, W, C), dtype=x.dtype)
    _lib.require(q.w_i8, "w_i8", (O, kh, kw, C), dtype=torch.int8, device=dev)
    _lib.require(q.dq, "dq", (O,), device=dev)
    _lib.require(q.xscale, "xscale", (1,) if q.divide else (C,), device=dev)
    if bias is not None:
        _lib.require(bias, "bias", (O,), device=dev)
    y = torch.empty((B, Ho, Wo, O), device=dev, dtype=out_dtype)
    args = (x.data_ptr(), int(x.dtype == torch.bfloat16), q.xscale.data_ptr(),
            int(q.divide), q.w_i8.data_ptr(), q.dq.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            int(out_dtype == torch.bfloat16), B, H, W, C, O, kh, kw, pt, pl)
    if stride == 1:
        name = "int8_conv"
        code = _lib.lib().dxmi_int8_conv(*args, _lib.stream())
    else:
        name = "int8_conv_s2"
        code = _lib.lib().dxmi_int8_conv_s2(*args, pb, pr, _lib.stream())
    _lib.check(code, f"dxmi_{name}")
    _lib.LAUNCHES[name] += 1
    return y


def int8_conv(x: torch.Tensor, kernel: torch.Tensor,
              bias: Optional[torch.Tensor], strides=(1, 1),
              padding: Padding = SAME_3X3,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """W8A8 conv with a dynamic per-tensor activation scale (max |x| / 127
    of this call's x); x NHWC, kernel HWIO fp; stride 1 or 2."""
    stride = _stride(strides)
    w_i8, wscale = quantize_per_channel(kernel.float(), axis=-1)
    ascale = torch.clamp(x.float().abs().amax(), min=1e-8) / 127.0
    q = QuantWeights(w_i8.permute(3, 0, 1, 2).contiguous(),
                     (ascale * wscale.reshape(-1)).contiguous(),
                     ascale.reshape(1), True)
    return int8_conv_apply(x, q, None if bias is None else bias.float(),
                           padding, out_dtype, stride)


def int8_conv_static(x: torch.Tensor, kernel: torch.Tensor,
                     bias: Optional[torch.Tensor], act_scale: torch.Tensor,
                     strides=(1, 1), padding: Padding = SAME_3X3,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """W8A8 conv with calibrated activation scales (a (Cin,) vector folded
    into the kernel's input axis, or a scalar); x NHWC, kernel HWIO fp;
    stride 1 or 2."""
    stride = _stride(strides)
    q = prepare_conv_static(kernel, torch.as_tensor(act_scale,
                                                    device=kernel.device))
    return int8_conv_apply(x, q, None if bias is None else bias.float(),
                           padding, out_dtype, stride)


def int8_matmul_static(x: torch.Tensor, w: torch.Tensor,
                       bias: Optional[torch.Tensor], act_scale: torch.Tensor,
                       out_dtype: torch.dtype = torch.bfloat16
                       ) -> torch.Tensor:
    """W8A8 ``x`` (..., Cin) @ ``w`` (Cin, Cout) with calibrated
    per-input-channel activation scales: ``int8_conv_static`` of a 1x1
    conv (K8 on the card)."""
    Cin, Cout = w.shape
    lead = x.shape[:-1]
    q = prepare_conv_static(w.reshape(1, 1, Cin, Cout), act_scale)
    y = int8_conv_apply(x.reshape(-1, 1, 1, Cin).contiguous(), q,
                        None if bias is None else bias.float(),
                        ((0, 0), (0, 0)), out_dtype)
    return y.reshape(*lead, Cout)


class Int8Layer:
    """The state of a layer with static int8 operands, mixed in before its
    ``nn.Module`` base. While ``calibrating`` is set the layer runs in full
    precision and records its activation scales. ``int8_operands()``
    quantises the fp32 weights with the current scales (``quantise_int8``,
    which each layer defines) on first use and caches them; a
    ``load_state_dict``, a device or dtype move and ``clear_int8()`` drop
    the cache, ``prepare_int8()`` rebuilds it. After changing a weight or a
    scale in place, call ``prepare_int8()``."""

    calibrating = False
    _int8_cache = None

    def quantise_int8(self):
        """The layer's int8 operands from its fp32 weights and scales (None
        where it has none)."""
        raise NotImplementedError

    def int8_operands(self):
        if self._int8_cache is None:
            self._int8_cache = self.quantise_int8()
        return self._int8_cache

    def prepare_int8(self) -> None:
        self._int8_cache = self.quantise_int8()

    def clear_int8(self) -> None:
        self._int8_cache = None

    def _load_from_state_dict(self, *args, **kwargs):
        self.clear_int8()
        super()._load_from_state_dict(*args, **kwargs)

    def _apply(self, *args, **kwargs):
        self.clear_int8()
        return super()._apply(*args, **kwargs)


class QConv(Int8Layer, nn.Conv2d):
    """An ``nn.Conv2d`` (same parameter names) that runs W8A8: 3x3 SAME by
    default, or any ``kernel_size`` up to 3 at ``stride`` 1 or 2 with
    ``padding`` (an int, or ((top, bottom), (left, right))).

    ``static_act=True``: uses the calibrated ``act_scale`` buffer (Cin,),
    zeros until calibrated. While ``calibrating`` is set, each call records
    max(act_scale, calib_channel_scale(x)) and runs the full-precision conv
    in ``out_dtype``; otherwise it runs K8 on the cached int8 operands
    (``Int8Layer``). ``static_act=False`` quantises each call's x per tensor
    (``int8_conv``).

    Inputs and outputs are NCHW tensors in ``torch.channels_last`` memory;
    the output has ``out_dtype``.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 static_act: bool = True,
                 out_dtype: torch.dtype = torch.bfloat16,
                 kernel_size: int = 3, stride: int = 1, padding=1):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride)
        if isinstance(padding, int):
            padding = ((padding, padding), (padding, padding))
        self.pads: Padding = tuple(tuple(int(v) for v in p) for p in padding)
        self.static_act = static_act
        self.out_dtype = out_dtype
        self.register_buffer("act_scale", torch.zeros(in_channels))

    def _hwio(self) -> torch.Tensor:
        return self.weight.float().permute(2, 3, 1, 0)

    def quantise_int8(self) -> Optional[QuantWeights]:
        return (prepare_conv_static(self._hwio(), self.act_scale)
                if self.static_act else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.calibrating and self.static_act:
            # full precision in the output dtype, the bias added to the
            # rounded product, as the JAX calibration pass runs it
            record_act_scale(self.act_scale, x)
            (pt, pb), (pl, pr) = self.pads
            if (pt, pl) != (pb, pr):
                x, pt, pl = F.pad(x, (pl, pr, pt, pb)), 0, 0
            dt = self.out_dtype
            y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                         (pt, pl))
            return y + self.bias.to(dt)[:, None, None]
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(
            0, 2, 3, 1)
        bias = self.bias.float()
        if self.static_act:
            # K8's stride-2 form is a launch of its own ("int8_conv_s2")
            kw = {} if self.stride[0] == 1 else {"stride": self.stride[0]}
            y = int8_conv_apply(nhwc, self.int8_operands(), bias, self.pads,
                                self.out_dtype, **kw)
        else:
            y = int8_conv(nhwc, self._hwio(), bias, self.stride, self.pads,
                          self.out_dtype)
        return y.permute(0, 3, 1, 2)
