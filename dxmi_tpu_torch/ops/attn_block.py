"""The attention block GN + q/k/v 1x1 + attention + proj 1x1 + residual:
kernel K2 and its plain version.

``attn_block`` mirrors ``dxmi_tpu.ops.attn_block.fused_attn_block`` (the fp32
forward at one batch element per program): on a CPU tensor it runs the plain
version, on a CUDA tensor it launches the hand-written kernels in
``csrc/attn_block.cu`` (or raises).
"""
from __future__ import annotations

import math

import torch

from dxmi_tpu_torch.ops import _lib

GROUPS = 32


def fused_attn_available(seq_len: int, channels: int, num_heads: int) -> bool:
    """Shapes K2 takes: whole 64-row q tiles (the JAX gate's S >= 64 rule,
    so UNetSmall's 4x4 mid block takes the einsum path as in JAX), whole
    groups of at most 32 channels, and head widths the kernel's 16-column
    lanes divide, up to 256."""
    if channels % GROUPS or channels > 32 * GROUPS or channels % num_heads:
        return False
    d = channels // num_heads
    return seq_len >= 64 and seq_len % 64 == 0 and d % 16 == 0 and d <= 256


def attn_block_reference(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj,
                         num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain fp32 attention block. x: (B, S, C); w_qkv: (C, 3C) with
    [3, nh, d] output columns; w_proj: (C, C). q and k are each scaled by
    d^-1/4 (``dxmi_tpu.ops.attn_block.attn_block_reference``)."""
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


def attn_block(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj,
               num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """The attention block on fp32 ``x`` (B, S, C). On the card: K2, for
    shapes that ``fused_attn_available`` admits."""
    if x.device.type == "cpu":
        return attn_block_reference(x, gn_scale, gn_bias, w_qkv, b_qkv,
                                    w_proj, b_proj, num_heads, eps)
    B, S, C = x.shape
    if not fused_attn_available(S, C, num_heads):
        raise ValueError(f"attn_block kernel: S={S}, C={C}, nh={num_heads} "
                         "not supported (fused_attn_available)")
    dev = x.device
    _lib.require(x, "x", (B, S, C))
    _lib.require(gn_scale, "gn_scale", (C,), device=dev)
    _lib.require(gn_bias, "gn_bias", (C,), device=dev)
    _lib.require(w_qkv, "w_qkv", (C, 3 * C), device=dev)
    _lib.require(b_qkv, "b_qkv", (3 * C,), device=dev)
    _lib.require(w_proj, "w_proj", (C, C), device=dev)
    _lib.require(b_proj, "b_proj", (C,), device=dev)
    y = torch.empty_like(x)
    stats = torch.empty((2, B * C), device=dev, dtype=torch.float32)
    qkv = torch.empty((B, S, 3 * C), device=dev, dtype=torch.float32)
    attn = torch.empty((B, S, C), device=dev, dtype=torch.float32)
    code = _lib.lib().dxmi_attn_block(
        x.data_ptr(), gn_scale.data_ptr(), gn_bias.data_ptr(),
        w_qkv.data_ptr(), b_qkv.data_ptr(), w_proj.data_ptr(),
        b_proj.data_ptr(), y.data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), qkv.data_ptr(), attn.data_ptr(), B, S, C,
        num_heads, GROUPS, float(eps), _lib.stream())
    _lib.check(code, "dxmi_attn_block")
    _lib.LAUNCHES["attn_block"] += 1
    return y
