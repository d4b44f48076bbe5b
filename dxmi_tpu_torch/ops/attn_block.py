"""The attention block GN + q/k/v 1x1 + attention + proj 1x1 + residual:
kernel K2 and its plain version.

``attn_block`` mirrors ``dxmi_tpu.ops.attn_block.fused_attn_block`` (the
forward at one batch element per program): on a CPU tensor it runs the plain
version, on a CUDA tensor it launches the hand-written kernels in
``csrc/attn_block.cu`` (or raises). It takes fp32 (CIFAR's single-head
blocks) or bf16 (the ADM nets' multi-head blocks) activations.

The bf16 form follows the arithmetic of the TPU kernel's body
(``attn_block.py:225-258``): GN statistics in fp32, h rounded to bf16; q, k, v
rounded to bf16 from fp32 accumulation, then the bf16 bias added in bf16;
q and k scaled by a bf16 d^-1/4 in bf16; fp32 logits and softmax; the
weights cast to bf16, AV accumulated in fp32 and rounded to bf16; proj as
for q/k/v, then the residual added in bf16. The JAX generation entry sets
``DXMI_FUSED_NOMAX=1``, which drops the softmax's max subtraction (exact
math); the port keeps one max-subtracting softmax.
"""
from __future__ import annotations

import math

import torch

from dxmi_tpu_torch.ops import _lib

GROUPS = 32


def fused_attn_available(seq_len: int, channels: int, num_heads: int) -> bool:
    """The JAX gate (``attn_block.py:59``, without its backend test): whole
    64-row q tiles (S >= 64, S % 64 == 0), d = C / nh <= 256, C <= 768 and
    S * C <= 1024 * 512, over whole groups of 32 channels (GroupNorm(32))."""
    if channels % GROUPS or channels % num_heads:
        return False
    d = channels // num_heads
    return (seq_len >= 64 and seq_len % 64 == 0 and d <= 256
            and channels <= 768 and seq_len * channels <= 1024 * 512)


def kernel_takes(channels: int, num_heads: int, dtype: torch.dtype) -> bool:
    """The forms K2 is written for, inside the gate: fp32 at d % 16 == 0 (its
    16-column lanes), bf16 at d % 8 == 0 and d <= 128 (its attention core is
    the flash kernel's)."""
    d = channels // num_heads
    if dtype == torch.bfloat16:
        return d % 8 == 0 and d <= 128
    return dtype == torch.float32 and d % 16 == 0


def attn_block_reference(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj,
                         num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain attention block. x: (B, S, C); w_qkv: (C, 3C) with [3, nh, d]
    output columns; w_proj: (C, C). q and k are each scaled by d^-1/4
    (``dxmi_tpu.ops.attn_block.attn_block_reference`` for fp32 ``x``; the
    TPU kernel's bf16 arithmetic for bf16 ``x``)."""
    if x.dtype == torch.bfloat16:
        return _attn_block_reference_bf16(x, gn_scale, gn_bias, w_qkv, b_qkv,
                                          w_proj, b_proj, num_heads, eps)
    B, S, C = x.shape
    nh = num_heads
    d = C // nh
    g = x.float().reshape(B, S, GROUPS, C // GROUPS)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
    h = ((g - mean) * torch.rsqrt(var + eps)).reshape(B, S, C)
    h = (h * gn_scale + gn_bias).to(x.dtype)
    qkv = (h @ w_qkv.to(x.dtype) + b_qkv.to(x.dtype)).reshape(B, S, 3, nh, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scale = 1.0 / math.sqrt(math.sqrt(d))
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k * scale)
    w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    a = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, S, C)
    y = a @ w_proj.to(x.dtype) + b_proj.to(x.dtype)
    return x + y


def _attn_block_reference_bf16(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj,
                               b_proj, num_heads, eps):
    """The bf16 arithmetic of ``attn_block.py:_kernel``. Its GN statistics
    are two-pass fp32 here (the TPU body takes one-pass fp32 sums: the two
    differ at fp32 rounding)."""
    dt = x.dtype
    B, S, C = x.shape
    nh = num_heads
    d = C // nh
    xf = x.float()
    g = xf.reshape(B, S, GROUPS, C // GROUPS)
    mean = g.mean(dim=(1, 3))
    rstd = torch.rsqrt((g - mean[:, None, :, None]).square().mean(dim=(1, 3))
                       + eps)
    s_c = gn_scale.float() * rstd.repeat_interleave(C // GROUPS, dim=1)
    t_c = gn_bias.float() - mean.repeat_interleave(C // GROUPS, dim=1) * s_c
    h = (xf * s_c[:, None] + t_c[:, None]).to(dt)
    # bf16 products are exact in fp32: fp32 products accumulate as a bf16
    # GEMM with fp32 accumulators does
    qkv = (h.float() @ w_qkv.float()).to(dt) + b_qkv.to(dt)
    qkv = qkv.reshape(B, S, 3, nh, d)
    scale = torch.tensor(1.0 / math.sqrt(math.sqrt(d)), dtype=dt)
    q, k, v = qkv[:, :, 0] * scale, qkv[:, :, 1] * scale, qkv[:, :, 2]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    w = torch.softmax(logits, dim=-1).to(dt)
    a = torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(dt)
    y = (a.reshape(B, S, C).float() @ w_proj.float()).to(dt) + b_proj.to(dt)
    return x + y


def attn_block(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj,
               num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """The attention block on fp32 or bf16 ``x`` (B, S, C), fp32 GN
    parameters, weights and biases in ``x``'s dtype. On the card: K2, for
    shapes that ``fused_attn_available`` admits, in the forms that
    ``kernel_takes`` names (others raise); it counts as ``attn_block``
    (fp32) or ``attn_block_bf16``."""
    if x.device.type == "cpu":
        return attn_block_reference(x, gn_scale, gn_bias, w_qkv, b_qkv,
                                    w_proj, b_proj, num_heads, eps)
    B, S, C = x.shape
    dt = x.dtype
    if not fused_attn_available(S, C, num_heads):
        raise ValueError(f"attn_block kernel: S={S}, C={C}, nh={num_heads} "
                         "outside fused_attn_available")
    if not kernel_takes(C, num_heads, dt):
        raise NotImplementedError(
            f"attn_block kernel: d={C // num_heads} in {dt} not ported yet "
            "(fp32 at d % 16 == 0, bf16 at d % 8 == 0 and d <= 128)")
    dev = x.device
    _lib.require(x, "x", (B, S, C), dtype=dt)
    _lib.require(gn_scale, "gn_scale", (C,), device=dev)
    _lib.require(gn_bias, "gn_bias", (C,), device=dev)
    _lib.require(w_qkv, "w_qkv", (C, 3 * C), dtype=dt, device=dev)
    _lib.require(b_qkv, "b_qkv", (3 * C,), dtype=dt, device=dev)
    _lib.require(w_proj, "w_proj", (C, C), dtype=dt, device=dev)
    _lib.require(b_proj, "b_proj", (C,), dtype=dt, device=dev)
    y = torch.empty_like(x)
    stats = torch.empty((2, B * C), device=dev, dtype=torch.float32)
    qkv = torch.empty((B, S, 3 * C), device=dev, dtype=dt)
    attn = torch.empty((B, S, C), device=dev, dtype=dt)
    form = "attn_block_bf16" if dt == torch.bfloat16 else "attn_block"
    code = getattr(_lib.lib(), f"dxmi_{form}")(
        x.data_ptr(), gn_scale.data_ptr(), gn_bias.data_ptr(),
        w_qkv.data_ptr(), b_qkv.data_ptr(), w_proj.data_ptr(),
        b_proj.data_ptr(), y.data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), qkv.data_ptr(), attn.data_ptr(), B, S, C,
        num_heads, GROUPS, float(eps), _lib.stream())
    _lib.check(code, f"dxmi_{form}")
    _lib.LAUNCHES[form] += 1
    return y
