"""Phase-decomposed ``conv3x3(nearest_up2(x))`` (``dxmi_tpu/ops/phase_up.py``),
full precision and W8A8 int8.

Since ``u[2i+a, 2j+b] = x[i, j]``, each output phase (a, b) of a SAME 3x3 conv
over the upsampled map u touches only a 2x2 neighbourhood of x, with
phase-specific tap sums (rows a=0: offsets {-1, 0} with taps [W0, W1+W2];
a=1: offsets {0, +1} with taps [W0+W1, W2]; the same along columns). So the
op is four 2x2 convs on the small grid and an interleave: 16 instead of 36
MACs per output, and the (2H, 2W) intermediate is never stored. The JAX
package computes it with XLA convolutions outside Pallas; here it is four
``F.conv2d`` calls, or in int8 four K8 launches (``int8_conv_apply``) with
each phase's own pads: a per-channel activation scale calibrated on x is
exactly the scale of the upsampled map, since nearest upsampling repeats
values.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from dxmi_tpu_torch.ops.quant import (QuantWeights, int8_conv_apply,
                                      prepare_conv_static)

# (top, bottom) padding of x for output row phase a (and columns for b)
_PADS = {0: (1, 0), 1: (0, 1)}
_PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))


def phase_kernels(w: torch.Tensor) -> List[torch.Tensor]:
    """(Cout, Cin, 3, 3) kernel -> four (Cout, Cin, 2, 2) phase kernels in
    (a, b) = (0,0), (0,1), (1,0), (1,1) order, summed in the input's dtype."""
    rows = (torch.stack([w[:, :, 0], w[:, :, 1] + w[:, :, 2]], dim=2),
            torch.stack([w[:, :, 0] + w[:, :, 1], w[:, :, 2]], dim=2))
    out = []
    for kr in rows:
        out.append(torch.stack([kr[..., 0], kr[..., 1] + kr[..., 2]], dim=-1))
        out.append(torch.stack([kr[..., 0] + kr[..., 1], kr[..., 2]], dim=-1))
    return out


def prepare_phase_int8(weight: torch.Tensor,
                       act_scale: torch.Tensor) -> List[QuantWeights]:
    """The four phase kernels of an OIHW ``weight``, summed in fp32 from the
    fp32 weight, each with ``act_scale`` folded in and quantised
    (``int8_conv_static``'s preparation), in ``_PHASES`` order."""
    return [prepare_conv_static(k.permute(2, 3, 1, 0), act_scale)
            for k in phase_kernels(weight.float())]


def _interleave(ys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Four NHWC phase outputs -> NCHW (channels_last) out[2i+a, 2j+b] =
    ys[2a+b][i, j]."""
    B, H, W, C = ys[0].shape
    t = torch.stack(ys, dim=3).reshape(B, H, W, 2, 2, C)
    out = t.permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * H, 2 * W, C)
    return out.permute(0, 3, 1, 2)


def conv3x3_nearest_up2(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor],
                        dtype: torch.dtype,
                        act_scale: Optional[torch.Tensor] = None,
                        prepared: Optional[List[QuantWeights]] = None
                        ) -> torch.Tensor:
    """``conv3x3_same(nearest_up2(x), weight) + bias`` on NCHW ``x`` with an
    OIHW ``weight``. The tap sums run in fp32 and are rounded to ``dtype``
    once, as the JAX op does; the bias is added in ``dtype`` after the
    interleave. ``act_scale`` (Cin,) switches the four phase convs to W8A8
    int8 (K8, no bias, output in ``dtype``); ``prepared`` gives their
    operands from ``prepare_phase_int8`` instead of preparing them here."""
    B, _, H, W = x.shape
    if act_scale is not None or prepared is not None:
        qs = prepared or prepare_phase_int8(weight, act_scale)
        xn = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        out = _interleave([int8_conv_apply(xn, q, None, (_PADS[a], _PADS[b]),
                                           dtype)
                           for q, (a, b) in zip(qs, _PHASES)])
    else:
        ks = phase_kernels(weight.float())
        ys = []
        for i, (a, b) in enumerate(_PHASES):
            xp = F.pad(x, (*_PADS[b], *_PADS[a]))
            ys.append(F.conv2d(xp, ks[i].to(dtype)))
        # out[2i+a, 2j+b] = ys[2a+b][i, j]
        t = torch.stack(ys, dim=-1).reshape(B, -1, H, W, 2, 2)
        out = t.permute(0, 1, 2, 4, 3, 5).reshape(B, -1, 2 * H, 2 * W)
        out = out.contiguous(memory_format=torch.channels_last)
    if bias is not None:
        out = out + bias.to(dtype)[:, None, None]
    return out
