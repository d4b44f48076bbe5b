"""Phase-decomposed ``conv3x3(nearest_up2(x))`` (``dxmi_tpu/ops/phase_up.py``,
full-precision mode).

Since ``u[2i+a, 2j+b] = x[i, j]``, each output phase (a, b) of a SAME 3x3 conv
over the upsampled map u touches only a 2x2 neighbourhood of x, with
phase-specific tap sums (rows a=0: offsets {-1, 0} with taps [W0, W1+W2];
a=1: offsets {0, +1} with taps [W0+W1, W2]; the same along columns). So the
op is four 2x2 convs on the small grid and an interleave: 16 instead of 36
MACs per output, and the (2H, 2W) intermediate is never stored. The JAX
package computes it with XLA convolutions outside Pallas; here it is four
``F.conv2d`` calls.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

# (top, bottom) padding of x for output row phase a (and columns for b)
_PADS = {0: (1, 0), 1: (0, 1)}


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


def conv3x3_nearest_up2(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor],
                        dtype: torch.dtype) -> torch.Tensor:
    """``conv3x3_same(nearest_up2(x), weight) + bias`` on NCHW ``x`` with an
    OIHW ``weight``. The tap sums run in fp32 and are rounded to ``dtype``
    once, as the JAX op does; the bias is added after the interleave."""
    B, _, H, W = x.shape
    ks = phase_kernels(weight.float())
    ys = []
    for i, (a, b) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        xp = F.pad(x, (*_PADS[b], *_PADS[a]))
        ys.append(F.conv2d(xp, ks[i].to(dtype)))
    # out[2i+a, 2j+b] = ys[2a+b][i, j]
    t = torch.stack(ys, dim=-1).reshape(B, -1, H, W, 2, 2)
    out = t.permute(0, 1, 2, 4, 3, 5).reshape(B, -1, 2 * H, 2 * W)
    out = out.contiguous(memory_format=torch.channels_last)
    if bias is not None:
        out = out + bias.to(dtype)[:, None, None]
    return out
