"""GroupNorm(+SiLU) on channels-last tensors: kernel K1 and its plain version.

``group_norm`` mirrors ``dxmi_tpu.ops.groupnorm.fused_group_norm``: on a CPU
tensor it runs the plain version, on a CUDA tensor it launches the
hand-written kernel in ``csrc/groupnorm.cu`` (or raises).
"""
from __future__ import annotations

import torch

from dxmi_tpu_torch.ops import _lib


def group_norm_silu_reference(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor, num_groups: int, eps: float,
                              silu: bool) -> torch.Tensor:
    """Plain GroupNorm(+SiLU) over the last axis of ``x`` (B, ..., C), with
    two-pass fp32 statistics: the JAX package's default
    ``group_norm_silu_reference``."""
    B, C = x.shape[0], x.shape[-1]
    xf = x.float().reshape(B, -1, num_groups, C // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.reshape(B, -1, C) * scale.float() + bias.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape).to(x.dtype)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-6,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU) of a channels-last fp32 tensor ``x`` (B, ..., C).

    On the card: K1, which needs ``C % num_groups == 0``, ``C % 4 == 0``
    and at most 32 channels per group.
    """
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, scale, bias, num_groups, eps, silu)
    B, C = x.shape[0], x.shape[-1]
    HW = x.numel() // (B * C)
    if C % num_groups or C % 4 or C > 32 * num_groups:
        raise ValueError(f"group_norm kernel: C={C} must be a multiple of "
                         f"num_groups={num_groups} and of 4, with at most 32 "
                         "channels per group")
    _lib.require(x, "x", x.shape)
    _lib.require(scale, "scale", (C,), device=x.device)
    _lib.require(bias, "bias", (C,), device=x.device)
    y = torch.empty_like(x)
    stats = torch.empty((2, B * C), device=x.device, dtype=torch.float32)
    code = _lib.lib().dxmi_gn_forward(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        stats[0].data_ptr(), stats[1].data_ptr(), B, HW, C, num_groups,
        float(eps), int(silu), _lib.stream())
    _lib.check(code, "dxmi_gn_forward")
    _lib.LAUNCHES["gn_silu"] += 1
    return y
