"""GroupNorm(+SiLU) on channels-last tensors: kernel K1 and its plain version.

``group_norm`` mirrors ``dxmi_tpu.ops.groupnorm.fused_group_norm``: on a CPU
tensor it runs the plain version, on a CUDA tensor it launches the
hand-written kernel in ``csrc/groupnorm.cu`` (or raises). It takes fp32 or
bf16 tensors (fp32 affine parameters) and the two statistics modes of the
JAX package's ``DXMI_GN_STATS`` that the generation entries use, passed here
as the ``stats`` argument:

- ``'fp32'``: two-pass fp32 statistics; normalise, affine and SiLU in fp32,
  rounded to the input dtype once at the end;
- ``'bf16_onepass'``: s1 = sum x and s2 = sum x*x (x*x rounded to the input
  dtype) accumulated in fp32, mean and var rounded to the input dtype, then
  normalise, affine and SiLU step by step in the input dtype, rounding after
  each operation as XLA does (``groupnorm.py:66-90``). For fp32 input this
  is one-pass fp32 statistics.

``group_norm`` is differentiable (``GroupNormFn``): the forward is K1, the
backward differentiates the plain version recomputed from the saved x, scale
and bias, as the JAX package's ``_bwd`` does (``groupnorm.py:252-264``).

XLA evaluates a bf16 sigmoid as 1 / (1 + exp(-x)) with each of the three
operations rounded to bf16; ``sigmoid`` does the same (torch's own bf16
sigmoid rounds once, and differs in about 3% of bf16 inputs).
"""
from __future__ import annotations

import torch

from dxmi_tpu_torch.ops import _lib

STATS_MODES = ("fp32", "bf16_onepass")
# channels per group the kernel's statistics pass takes (two warps of lanes)
MAX_GROUP_WIDTH = 64


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), each operation rounded to ``x``'s dtype."""
    return torch.reciprocal(1 + torch.exp(-x))


def group_norm_silu_reference(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor, num_groups: int, eps: float,
                              silu: bool, stats: str = "fp32") -> torch.Tensor:
    """Plain GroupNorm(+SiLU) over the last axis of ``x`` (B, ..., C): the JAX
    package's ``group_norm_silu_reference`` under ``DXMI_GN_STATS=stats``."""
    if stats not in STATS_MODES:
        raise ValueError(f"stats={stats!r}, expected one of {STATS_MODES}")
    B, C = x.shape[0], x.shape[-1]
    if stats == "fp32":
        xf = x.float().reshape(B, -1, num_groups, C // num_groups)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + eps)
        y = y.reshape(B, -1, C) * scale.float() + bias.float()
        if silu:
            y = y * torch.sigmoid(y)
        return y.reshape(x.shape).to(x.dtype)
    sdt = x.dtype
    xs = x.reshape(B, -1, num_groups, C // num_groups)
    n = xs.shape[1] * xs.shape[3]
    s1 = xs.float().sum(dim=(1, 3), keepdim=True)
    s2 = (xs * xs).float().sum(dim=(1, 3), keepdim=True)
    mean = (s1 / n).to(sdt)
    var = torch.clamp(s2 / n - (s1 / n).square(), min=0.0).to(sdt)
    # the Python scalar enters XLA's bf16 arithmetic rounded to bf16
    y = (xs - mean) * torch.rsqrt(var + torch.tensor(eps, dtype=sdt))
    y = y.reshape(B, -1, C) * scale.to(sdt) + bias.to(sdt)
    if silu:
        y = y * sigmoid(y)
    return y.reshape(x.shape)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-6, silu: bool = False,
               stats: str = "fp32") -> torch.Tensor:
    """GroupNorm(+SiLU) of a channels-last fp32 or bf16 tensor ``x``
    (B, ..., C) with fp32 ``scale`` and ``bias``; differentiable
    (``GroupNormFn``) when a gradient is wanted.

    On the card: K1, which needs ``C % num_groups == 0``, at most 64
    channels per group, and ``C`` a multiple of 4 (fp32) or 8 (bf16) for its
    16-byte loads. It counts as ``gn_silu`` (fp32) or ``gn_silu_bf16``.
    """
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return GroupNormFn.apply(x, scale, bias, num_groups, eps, silu, stats)
    return _group_norm_forward(x, scale, bias, num_groups, eps, silu, stats)


class GroupNormFn(torch.autograd.Function):
    """K1 with the gradient of its plain version, recomputed from the saved
    x, scale and bias."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, silu, stats):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (num_groups, eps, silu, stats)
        return _group_norm_forward(x, scale, bias, num_groups, eps, silu,
                                   stats)

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias = ctx.saved_tensors
        with torch.enable_grad():
            xs, ss, bs = (t.detach().requires_grad_(True)
                          for t in (x, scale, bias))
            y = group_norm_silu_reference(xs, ss, bs, *ctx.args)
            dx, dscale, dbias = torch.autograd.grad(y, (xs, ss, bs), dy)
        return dx, dscale, dbias, None, None, None, None


def _group_norm_forward(x, scale, bias, num_groups, eps, silu, stats):
    if stats not in STATS_MODES:
        raise ValueError(f"stats={stats!r}, expected one of {STATS_MODES}")
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, scale, bias, num_groups, eps, silu,
                                         stats)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"group_norm kernel: dtype {x.dtype} not supported")
    bf16 = x.dtype == torch.bfloat16
    B, C = x.shape[0], x.shape[-1]
    HW = x.numel() // (B * C)
    vec = 8 if bf16 else 4
    if C % num_groups or C % vec or C > MAX_GROUP_WIDTH * num_groups:
        raise ValueError(f"group_norm kernel: C={C} must be a multiple of "
                         f"num_groups={num_groups} and of {vec}, with at most "
                         f"{MAX_GROUP_WIDTH} channels per group")
    _lib.require(x, "x", x.shape, dtype=x.dtype)
    _lib.require(scale, "scale", (C,), device=x.device)
    _lib.require(bias, "bias", (C,), device=x.device)
    y = torch.empty_like(x)
    st = torch.empty((2, B * C), device=x.device, dtype=torch.float32)
    code = _lib.lib().dxmi_gn_forward(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        st[0].data_ptr(), st[1].data_ptr(), B, HW, C, num_groups, float(eps),
        int(silu), int(bf16), STATS_MODES.index(stats), _lib.stream())
    _lib.check(code, "dxmi_gn_forward")
    _lib.LAUNCHES["gn_silu_bf16" if bf16 else "gn_silu"] += 1
    return y

