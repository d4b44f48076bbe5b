"""The convs and linears of the port's nets in the compute dtype, as flax's
``nn.Conv`` and ``nn.Dense`` run them: the fp32 parameters are cast to the
input's dtype where they are used, and in bf16 the bias is added to the
rounded product and the sum rounded again."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dxmi_tpu_torch.ops.quant import QConv


def _conv(conv: nn.Conv2d, x: torch.Tensor,
          weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv`` in ``x``'s dtype, with ``weight`` in place of its own when
    given (a spectrally normalised one); an int8 ``QConv`` runs its own
    forward."""
    if isinstance(conv, QConv):
        return conv(x)
    w = (conv.weight if weight is None else weight).to(x.dtype)
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    if x.dtype == torch.float32 or bias is None:
        return F.conv2d(x, w, bias, conv.stride, conv.padding)
    y = F.conv2d(x, w, None, conv.stride, conv.padding)
    return y + bias[:, None, None]


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``lin`` in ``x``'s dtype."""
    if x.dtype == torch.float32:
        return F.linear(x, lin.weight, lin.bias)
    return F.linear(x, lin.weight.to(x.dtype)) + lin.bias.to(x.dtype)
