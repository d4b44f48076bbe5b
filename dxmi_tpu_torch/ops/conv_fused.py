"""GroupNorm + SiLU + 3x3 SAME conv on channels-last tensors: kernel K3 and
its plain version.

``gn_silu_conv`` mirrors ``dxmi_tpu.ops.conv_fused.fused_gn_silu_conv``: on a
CPU tensor it runs the plain version, on a CUDA tensor it launches the
hand-written kernel in ``csrc/conv_fused.cu`` (or raises). Both round the
conv operands to bf16 and accumulate in fp32, as the TPU kernel does. On the
card the conv is a wgmma implicit GEMM whose reduction ``plan`` may split
into slices (small maps); the wrapper allocates their fp32 partials.

It is differentiable (``GnSiluConvFn``): as ``_fgsc_bwd``
(``conv_fused.py:102-113``), the backward is the vjp of
``gn_silu_conv_reference`` at fp32 operands, recomputed from the saved
inputs. So the forward rounds to bf16 and the backward does not.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from dxmi_tpu_torch.ops import _lib
from dxmi_tpu_torch.ops.groupnorm import group_norm_silu_reference


def fused_conv_available(c_in: int, c_out: int, width: int,
                         num_groups: int = 32) -> bool:
    """Shapes K3 takes: whole groups of at most 32 channels, 32-channel
    input chunks, output channels in 8-wide (16-byte) weight rows, and
    images at most 512 wide (the normalised input window lives in shared
    memory)."""
    return (c_in % num_groups == 0 and c_in <= 32 * num_groups
            and c_in % 32 == 0 and c_out % 8 == 0 and width <= 512)


class ConvPlan(NamedTuple):
    chunk: int   # input channels a step of the conv's reduction
    rows: int    # padded positions a tile (BM)
    slices: int  # slices of the reduction (a second launch sums them)


@functools.lru_cache(maxsize=None)
def plan(B: int, H: int, W: int, c_in: int, c_out: int) -> ConvPlan:
    """K3's plan on the card for a (B, H, W, c_in) -> c_out call, as
    ``conv_plan`` in ``csrc/conv_fused.cu`` chooses it; raises ValueError
    for a shape it does not take. Needs the kernel library (the card)."""
    out = (ctypes.c_int * 3)()
    if _lib.lib().dxmi_conv_plan(B, H, W, c_in, c_out, out):
        raise ValueError(f"gn_silu_conv kernel: no plan for {(B, H, W)}, "
                         f"Cin={c_in}, Cout={c_out}")
    return ConvPlan(*out)


def gn_silu_conv_reference(x: torch.Tensor, gn_scale: torch.Tensor,
                           gn_bias: torch.Tensor, kernel: torch.Tensor,
                           bias: torch.Tensor, num_groups: int = 32,
                           eps: float = 1e-6,
                           operand_dtype: torch.dtype = torch.bfloat16
                           ) -> torch.Tensor:
    """Plain GN (fp32 statistics) -> SiLU -> 3x3 SAME conv -> + bias.

    x: (B, H, W, Cin) fp32; kernel: (3, 3, Cin, Cout) HWIO. The conv
    operands are rounded to ``operand_dtype`` (bf16, as the kernel does;
    float32 gives the JAX package's ``gn_silu_conv_reference``) and the
    products are summed in fp32. Returns (B, H, W, Cout) fp32.
    """
    h = group_norm_silu_reference(x, gn_scale, gn_bias, num_groups, eps,
                                  silu=True)
    h = h.to(operand_dtype).float().permute(0, 3, 1, 2)
    w = kernel.to(operand_dtype).float().permute(3, 2, 0, 1)
    out = F.conv2d(h, w, bias.float(), padding=1)
    return out.permute(0, 2, 3, 1).contiguous()


class GnSiluConvFn(torch.autograd.Function):
    """K3 (or its plain version on the CPU) forward; the vjp of the fp32
    ``gn_silu_conv_reference`` backward."""

    @staticmethod
    def forward(ctx, x, gn_scale, gn_bias, kernel, bias, num_groups, eps):
        ctx.save_for_backward(x, gn_scale, gn_bias, kernel, bias)
        ctx.num_groups, ctx.eps = num_groups, eps
        return _gn_silu_conv_forward(x, gn_scale, gn_bias, kernel, bias,
                                     num_groups, eps)

    @staticmethod
    def backward(ctx, ct):
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            y = gn_silu_conv_reference(*ins, ctx.num_groups, ctx.eps,
                                       operand_dtype=torch.float32)
            grads = iter(torch.autograd.grad(
                y, [t for t in ins if t.requires_grad], ct.float()))
        return (*(next(grads) if n else None for n in need), None, None)


def gn_silu_conv(x: torch.Tensor, gn_scale: torch.Tensor,
                 gn_bias: torch.Tensor, kernel: torch.Tensor,
                 bias: torch.Tensor, num_groups: int = 32,
                 eps: float = 1e-6) -> torch.Tensor:
    """Fused GN+SiLU+conv3x3 of a channels-last fp32 ``x`` (B, H, W, Cin)
    with an HWIO ``kernel`` (3, 3, Cin, Cout); returns (B, H, W, Cout) fp32.
    On the card: K3, for shapes that ``fused_conv_available`` admits.
    Differentiable (``GnSiluConvFn``) when an input requires a gradient."""
    args = (x, gn_scale, gn_bias, kernel, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return GnSiluConvFn.apply(*args, num_groups, eps)
    return _gn_silu_conv_forward(*args, num_groups, eps)


def _gn_silu_conv_forward(x, gn_scale, gn_bias, kernel, bias, num_groups,
                          eps):
    if x.device.type == "cpu":
        return gn_silu_conv_reference(x, gn_scale, gn_bias, kernel, bias,
                                      num_groups, eps)
    B, H, W, C = x.shape
    C_out = kernel.shape[-1]
    if not fused_conv_available(C, C_out, W, num_groups):
        raise ValueError(f"gn_silu_conv kernel: Cin={C}, Cout={C_out}, W={W} "
                         "not supported (fused_conv_available)")
    _lib.require(x, "x", (B, H, W, C))
    _lib.require(gn_scale, "gn_scale", (C,), device=x.device)
    _lib.require(gn_bias, "gn_bias", (C,), device=x.device)
    _lib.require(bias, "bias", (C_out,), device=x.device)
    if tuple(kernel.shape) != (3, 3, C, C_out) or kernel.device != x.device:
        raise ValueError(f"kernel: {tuple(kernel.shape)} on {kernel.device}, "
                         f"expected {(3, 3, C, C_out)} on {x.device}")
    # the kernel reads bf16 weights, (tap, Cin, Cout) contiguous
    w = torch.empty((3, 3, C, C_out), device=x.device, dtype=torch.bfloat16)
    w.copy_(kernel)
    y = torch.empty((B, H, W, C_out), device=x.device, dtype=torch.float32)
    stats = torch.empty((2, B * C), device=x.device, dtype=torch.float32)
    slices = plan(B, H, W, C, C_out).slices
    part = (torch.empty((slices, B, H, W, C_out), device=x.device,
                        dtype=torch.float32) if slices > 1 else None)
    code = _lib.lib().dxmi_gn_silu_conv3x3(
        x.data_ptr(), gn_scale.data_ptr(), gn_bias.data_ptr(), w.data_ptr(),
        bias.data_ptr(), y.data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), None if part is None else part.data_ptr(), B, H,
        W, C, C_out, num_groups, float(eps), slices, _lib.stream())
    _lib.check(code, "dxmi_gn_silu_conv3x3")
    _lib.LAUNCHES["gn_silu_conv3x3"] += 1
    return y
