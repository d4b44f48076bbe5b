"""The attention block GN + q/k/v 1x1 + attention + proj 1x1 + residual:
kernel K2 and its plain version, its batch-blocked form, kernel K7, with
its plain version, and its int8 (W8A8) form, kernel K5, with its plain
version and the JAX package's oracle; and the wide attention core of K2
and K7 in bf16 at d > 128 (``attn_core_wide``), with its plain version.

``attn_block`` mirrors ``dxmi_tpu.ops.attn_block.fused_attn_block``: the
batch block (``block_b`` or ``DXMI_FUSED_ATTN_BB``, clamped as JAX clamps
it) selects K2 (one element per program) or K7 (blocks of bb elements); on
a CPU tensor it runs their plain versions, on a CUDA tensor it launches the
hand-written kernels (or raises). It takes fp32 (CIFAR's single-head
blocks; K2 and K7 on 3xTF32 tensor-core launches, ``csrc/attn_block_bb.cu``)
or bf16 (the ADM nets' multi-head blocks and CIFAR's d = 256 blocks; K2
and K7 on the same wgmma launches, ``csrc/attn_block.cu``, their attention
core K4's at d <= 128 and the wide core, ``csrc/attn_core_wide.cu``, above)
activations, and is differentiable (``AttnBlockFn``): the backward is the
vjp of the reference, as ``_make_op.bwd`` is.

The bf16 form follows the arithmetic of the TPU kernel's body
(``attn_block.py:225-258``): GN statistics in fp32, h rounded to bf16; q, k, v
rounded to bf16 from fp32 accumulation, then the bf16 bias added in bf16;
q and k scaled by a bf16 d^-1/4 in bf16; fp32 logits and softmax; the
weights cast to bf16, AV accumulated in fp32 and rounded to bf16; proj as
for q/k/v, then the residual added in bf16. The JAX generation entry sets
``DXMI_FUSED_NOMAX=1``, which drops the softmax's max subtraction (exact
math); the port keeps one max-subtracting softmax.

``fused_attn_block_train`` mirrors ``fused_attn_block_train``
(``attn_block.py:652``): the forward is K2 (``_pallas_forward``,
``:630-631``) and the backward is K6 (``_kernel_bwd``, ``:406``, in
``csrc/attn_block_bwd.cu``), which recomputes every intermediate from x and
the parameters, as ``_make_op_train`` saves only those (``:633-646``); in
bf16 its products run on the tensor cores (its dq pass is K4-dq's kernel),
in fp32 all are SIMT: at S = 64 and C <= 64 in one launch of one block (or
a cluster of two) a sample (``csrc/attn_block_bwd_small.cu``), elsewhere in
the multi-launch route. Its
plain version ``attn_block_bwd_reference`` repeats the TPU body's arithmetic
and roundings step by step (``:406-556``). The parameter cotangents come back
in fp32.

``attn_block_int8`` mirrors ``fused_attn_block_int8``: the same block with the
qkv and proj products in int8 (``_kernel_i8``, ``attn_block.py:353``). Its
plain version follows that kernel's body, not the JAX oracle: h is quantised
straight from the fp32 GN epilogue, and each dequantisation adds the fp32
bias before rounding to the compute dtype.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import torch

from dxmi_tpu_torch.ops import _lib
from dxmi_tpu_torch.ops.quant import int8_matmul_static, quantize_per_channel

GROUPS = 32


def fused_attn_available(seq_len: int, channels: int, num_heads: int,
                         int8: bool = False) -> bool:
    """The JAX gate (``attn_block.py:59``, without its backend test): whole
    64-row q tiles (S >= 64, S % 64 == 0), d = C / nh <= 256, C <= 768 (C <=
    1024 for the int8 block, whose weights are half the size) and
    S * C <= 1024 * 512, over whole groups of 32 channels (GroupNorm(32))."""
    if channels % GROUPS or channels % num_heads:
        return False
    d = channels // num_heads
    return (seq_len >= 64 and seq_len % 64 == 0 and d <= 256
            and channels <= (1024 if int8 else 768)
            and seq_len * channels <= 1024 * 512)


def fused_attn_bwd_available(seq_len: int, channels: int,
                             num_heads: int) -> bool:
    """The training gate (``attn_block.py:612``): the forward gate plus
    S * C <= 1024 * 384."""
    return (fused_attn_available(seq_len, channels, num_heads)
            and seq_len * channels <= 1024 * 384)


def kernel_takes(channels: int, num_heads: int, dtype: torch.dtype,
                 int8: bool = False) -> bool:
    """The forms K2, K7 and (``int8``) K5 are written for, inside the gate:
    fp32 at d % 16 == 0 (the 16-column lanes of K5's fp32 SIMT core), bf16
    at d % 8 == 0 and d <= 128 (the flash kernel's core), and K2 and K7 in
    bf16 also at 128 < d <= 256, any head count (the wide core, CIFAR-10's
    d = 256 blocks)."""
    d = channels // num_heads
    if dtype == torch.bfloat16:
        return d % 8 == 0 and d <= (128 if int8 else 256)
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


def _attn_block_k2(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj,
                   num_heads: int, eps: float) -> torch.Tensor:
    """K2's forward (bb = 1): the plain version on a CPU tensor, the kernel
    on a CUDA tensor."""
    if x.device.type == "cpu":
        return attn_block_reference(x, gn_scale, gn_bias, w_qkv, b_qkv,
                                    w_proj, b_proj, num_heads, eps)
    B, S, C = x.shape
    dt = x.dtype
    _check_kernel_form("attn_block", S, C, num_heads, dt)
    dev = x.device
    _require_block_args(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj)
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
    # bf16 at d > 128 runs the wide attention core, not K4's
    wide = dt == torch.bfloat16 and C // num_heads > 128
    _lib.LAUNCHES["attn_block_bf16_d256" if wide else form] += 1
    return y


def _check_kernel_form(name, S, C, num_heads, dt) -> None:
    if not fused_attn_available(S, C, num_heads):
        raise ValueError(f"{name} kernel: S={S}, C={C}, nh={num_heads} "
                         "outside fused_attn_available")
    if not kernel_takes(C, num_heads, dt):
        raise NotImplementedError(
            f"{name} kernel: d={C // num_heads}, nh={num_heads} in {dt} not "
            "ported yet (fp32 at d % 16 == 0, bf16 at d % 8 == 0 and d <= "
            "256)")


def _require_block_args(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj):
    B, S, C = x.shape
    dt, dev = x.dtype, x.device
    _lib.require(x, "x", (B, S, C), dtype=dt)
    _lib.require(gn_scale, "gn_scale", (C,), device=dev)
    _lib.require(gn_bias, "gn_bias", (C,), device=dev)
    _lib.require(w_qkv, "w_qkv", (C, 3 * C), dtype=dt, device=dev)
    _lib.require(b_qkv, "b_qkv", (3 * C,), dtype=dt, device=dev)
    _lib.require(w_proj, "w_proj", (C, C), dtype=dt, device=dev)
    _lib.require(b_proj, "b_proj", (C,), dtype=dt, device=dev)


# ---- the wide attention core (bf16, 128 < d <= 256) ----------------------


def attn_core_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain attention core of the bf16 block: qkv (B, S, 3C) with [3, nh,
    d] columns, q and k already scaled; per (sample, head) the fp32 softmax
    of the fp32 logits rounded to qkv's dtype, AV summed in fp32 and
    rounded: (B, S, C)."""
    B, S, C3 = qkv.shape
    C = C3 // 3
    d = C // num_heads
    q, k, v = qkv.reshape(B, S, 3, num_heads, d).unbind(2)
    lg = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    w = torch.softmax(lg, dim=-1).to(qkv.dtype)
    a = torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float())
    return a.to(qkv.dtype).reshape(B, S, C)


def attn_core_wide(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The attention core that K2 and K7 launch in bf16 at 128 < d <= 256
    (``csrc/attn_core_wide.cu``), on its own: the plain version on a CPU
    tensor; on a CUDA tensor the kernel, for bf16 qkv (B, S, 3C) with
    S % 64 == 0 and d = C / nh, d % 8 == 0, 128 < d <= 256 (others raise);
    it counts as ``attn_core_wide``."""
    if qkv.device.type == "cpu":
        return attn_core_reference(qkv, num_heads)
    B, S, C3 = qkv.shape
    C = C3 // 3
    d = C // num_heads if C % num_heads == 0 else 0
    if (qkv.dtype != torch.bfloat16 or C3 % 3 or S % 64 or d % 8 or d <= 128
            or d > 256):
        raise NotImplementedError(
            f"attn_core_wide kernel: S={S}, C={C}, nh={num_heads} in "
            f"{qkv.dtype} (bf16, S % 64 == 0, 128 < d <= 256, d % 8 == 0)")
    _lib.require(qkv, "qkv", (B, S, C3), dtype=torch.bfloat16)
    out = torch.empty((B, S, C), device=qkv.device, dtype=torch.bfloat16)
    code = _lib.lib().dxmi_attn_core_wide(qkv.data_ptr(), out.data_ptr(), B,
                                           S, C, num_heads, _lib.stream())
    _lib.check(code, "dxmi_attn_core_wide")
    _lib.LAUNCHES["attn_core_wide"] += 1
    return out


# ---- the batch-blocked forward: K7 ----------------------------------------

# the activation bound of the batch-blocked kernel: bb S C <= 1024 * 384
# (``attn_block.py:898-904``)
BB_SC_CAP = 1024 * 384


def resolve_block_b(B: int, S: int, C: int,
                    block_b: Optional[int] = None) -> int:
    """The batch block that ``fused_attn_block`` runs (``attn_block.py:
    873-906``): ``block_b``, or ``DXMI_FUSED_ATTN_BB`` (default 1) when
    None; above 1 clamped to ``max(1, BB_SC_CAP // (S C))`` and to B, then
    lowered until it divides B."""
    if block_b is None:
        block_b = int(os.environ.get("DXMI_FUSED_ATTN_BB", "1"))
    bb = int(block_b)
    if bb > 1:
        bb = min(bb, max(1, BB_SC_CAP // (S * C)), B)
        while bb > 1 and B % bb:
            bb -= 1
    return max(bb, 1)


def attn_block_bb_reference(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj,
                            b_proj, num_heads: int, eps: float = 1e-5,
                            bb: int = 2) -> torch.Tensor:
    """Plain K7, the arithmetic of ``_kernel_bb`` (``attn_block.py:261-
    317``), block by block of ``bb`` elements: per-element GroupNorm
    statistics from one-pass fp32 sums over the block's flattened rows
    (var = E[x^2] - mean^2); h = dt(x s + t) with s = gn_scale rstd and t =
    gn_bias - mean s; qkv = dt(h W_qkv) + dt(b_qkv) over the block's bb S
    rows, q and k times dt(d^-1/4) in dt; per element and head the fp32
    softmax of the fp32 logits rounded to dt, AV summed in fp32 and rounded;
    proj as qkv, then the residual in dt. ``dt`` is x's dtype (fp32 or
    bf16)."""
    B, S, C = x.shape
    if B % bb:
        raise ValueError(f"B={B} is not a multiple of bb={bb}")
    nh = num_heads
    d = C // nh
    cg = C // GROUPS
    dt = x.dtype
    scale = torch.tensor(1.0 / math.sqrt(math.sqrt(d)), dtype=dt)
    outs = []
    for b0 in range(0, B, bb):
        xb = x[b0:b0 + bb]
        xf = xb.float()
        g = xf.reshape(bb, S, GROUPS, cg)
        mean = g.mean(dim=(1, 3))
        var = (g * g).mean(dim=(1, 3)) - mean * mean
        rstd = torch.rsqrt(var + eps)
        s_c = gn_scale.float() * rstd.repeat_interleave(cg, dim=1)
        t_c = gn_bias.float() - mean.repeat_interleave(cg, dim=1) * s_c
        h = (xf * s_c[:, None] + t_c[:, None]).to(dt)
        qkv = ((h.reshape(bb * S, C).float() @ w_qkv.float()).to(dt)
               + b_qkv.to(dt)).reshape(bb, S, 3, nh, d)
        q, k, v = qkv[:, :, 0] * scale, qkv[:, :, 1] * scale, qkv[:, :, 2]
        lg = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        w = torch.softmax(lg, dim=-1).to(dt)
        a = torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(dt)
        y = ((a.reshape(bb * S, C).float() @ w_proj.float()).to(dt)
             + b_proj.to(dt))
        outs.append(xb + y.reshape(bb, S, C))
    return torch.cat(outs)


def attn_block_bb(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj,
                  num_heads: int, eps: float = 1e-5,
                  bb: int = 2) -> torch.Tensor:
    """The attention block over blocks of ``bb`` batch elements on fp32 or
    bf16 ``x`` (B, S, C), B a multiple of bb: the plain version on a CPU
    tensor; on a CUDA tensor K7 (fp32: ``csrc/attn_block_bb.cu``; bf16: its
    one-pass fp32 statistics, then K2 bf16's launches, ``csrc/
    attn_block.cu``), for shapes that ``fused_attn_available`` admits, in
    the forms that ``kernel_takes`` names (others raise); it counts as
    ``attn_block_bb`` (fp32) or ``attn_block_bb_bf16``."""
    if x.device.type == "cpu":
        return attn_block_bb_reference(x, gn_scale, gn_bias, w_qkv, b_qkv,
                                       w_proj, b_proj, num_heads, eps, bb)
    B, S, C = x.shape
    dt = x.dtype
    if bb < 2 or B % bb:
        raise ValueError(f"attn_block_bb kernel: bb={bb} must be >= 2 and "
                         f"divide B={B}")
    _check_kernel_form("attn_block_bb", S, C, num_heads, dt)
    _require_block_args(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj)
    dev = x.device
    y = torch.empty_like(x)
    stats = torch.empty((B, 2, C), device=dev, dtype=torch.float32)
    qkv = torch.empty((B, S, 3 * C), device=dev, dtype=dt)
    attn = torch.empty((B, S, C), device=dev, dtype=dt)
    form = "attn_block_bb_bf16" if dt == torch.bfloat16 else "attn_block_bb"
    code = getattr(_lib.lib(), f"dxmi_{form}")(
        x.data_ptr(), gn_scale.data_ptr(), gn_bias.data_ptr(),
        w_qkv.data_ptr(), b_qkv.data_ptr(), w_proj.data_ptr(),
        b_proj.data_ptr(), y.data_ptr(), stats.data_ptr(), qkv.data_ptr(),
        attn.data_ptr(), B, S, C, num_heads, GROUPS, bb, float(eps),
        _lib.stream())
    _lib.check(code, f"dxmi_{form}")
    _lib.LAUNCHES[form] += 1
    return y


def _attn_block_forward(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj,
                        num_heads, eps, bb):
    if bb > 1:
        return attn_block_bb(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj,
                             b_proj, num_heads, eps, bb)
    return _attn_block_k2(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj,
                          num_heads, eps)


class AttnBlockFn(torch.autograd.Function):
    """The block with the K2 / K7 forward and, as ``_make_op.bwd``
    (``attn_block.py:862-865``), the vjp of ``attn_block_reference`` on the
    saved inputs: fp32 for fp32 ``x``, whatever the forward's batch
    block."""

    @staticmethod
    def forward(ctx, x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj,
                num_heads, eps, bb):
        ctx.save_for_backward(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj,
                              b_proj)
        ctx.num_heads, ctx.eps = num_heads, eps
        return _attn_block_forward(x, gn_scale, gn_bias, w_qkv, b_qkv,
                                   w_proj, b_proj, num_heads, eps, bb)

    @staticmethod
    def backward(ctx, ct):
        need = ctx.needs_input_grad[:7]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            y = attn_block_reference(*ins, ctx.num_heads, ctx.eps)
            grads = iter(torch.autograd.grad(
                y, [t for t in ins if t.requires_grad], ct))
        return (*(next(grads) if n else None for n in need), None, None,
                None)


def attn_block(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj,
               num_heads: int, eps: float = 1e-5,
               block_b: Optional[int] = None) -> torch.Tensor:
    """The attention block on fp32 or bf16 ``x`` (B, S, C), fp32 GN
    parameters, weights and biases in ``x``'s dtype, as
    ``fused_attn_block``: ``block_b`` (or ``DXMI_FUSED_ATTN_BB``) is clamped
    by ``resolve_block_b``; a batch block of 1 runs K2, a larger one K7
    (``attn_block_bb``). On the card the kernels take the shapes that
    ``fused_attn_available`` admits, in the forms that ``kernel_takes``
    names (others raise); K2 counts as ``attn_block`` (fp32),
    ``attn_block_bf16`` or, at d > 128, ``attn_block_bf16_d256``.
    Differentiable (``AttnBlockFn``) when an input
    requires a gradient."""
    B, S, C = x.shape
    bb = resolve_block_b(B, S, C, block_b)
    args = (x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return AttnBlockFn.apply(*args, num_heads, eps, bb)
    return _attn_block_forward(*args, num_heads, eps, bb)


# ---- the backward: K6 ----------------------------------------------------


def attn_block_bwd_reference(x, ct, gn_scale, gn_bias, w_qkv, b_qkv, w_proj,
                             num_heads: int, eps: float = 1e-5):
    """Plain K6, the arithmetic of ``_kernel_bwd`` (``attn_block.py:406``):
    one-pass fp32 GroupNorm statistics; hp = (x - mean) rstd and h = dt(hp
    gs + gb); qkv = dt(h W_qkv) + dt(b_qkv) in dt, q and k times dt(d^-1/4);
    da = dt(ct W_proj^T); per head the fp32 softmax w of the fp32 logits,
    a = dt(dt(w) v), dv = dt(w)^T da, dlg = w (da v^T - rowsum(da v^T w)),
    dq = dt(dlg) k d^-1/4, dk = dt(dlg)^T q d^-1/4; dh = dt(dqkv) W_qkv^T;
    the parameter sums and the GroupNorm backward in fp32. Returns (dx in
    x's dtype, dgs, dgb, dw_qkv, db_qkv, dw_proj, db_proj in fp32)."""
    dt = x.dtype
    B, S, C = x.shape
    nh = num_heads
    d = C // nh
    cg = C // GROUPS
    xf, ctf = x.float(), ct.float()
    g = xf.reshape(B, S, GROUPS, cg)
    mean = g.mean(dim=(1, 3))
    var = (g * g).mean(dim=(1, 3)) - mean * mean
    inv = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(cg, dim=1)[:, None]
    inv_c = inv.repeat_interleave(cg, dim=1)[:, None]
    hp = (xf - mean_c) * inv_c
    h = (hp * gn_scale.float() + gn_bias.float()).to(dt)
    qkv = (h.float() @ w_qkv.float()).to(dt) + b_qkv.to(dt)
    da = (ctf @ w_proj.float().t()).to(dt)
    scale = torch.tensor(1.0 / math.sqrt(math.sqrt(d)), dtype=dt)
    sf = float(torch.tensor(1.0 / math.sqrt(math.sqrt(d)),
                            dtype=torch.float32))
    qkv = qkv.reshape(B, S, 3, nh, d)
    qs, ks, vh = qkv[:, :, 0] * scale, qkv[:, :, 1] * scale, qkv[:, :, 2]
    dah = da.reshape(B, S, nh, d).float()
    lg = torch.einsum("bqhd,bkhd->bhqk", qs.float(), ks.float())
    w = torch.softmax(lg, dim=-1)
    wb = w.to(dt).float()
    a = torch.einsum("bhqk,bkhd->bqhd", wb, vh.float()).to(dt)
    dv = torch.einsum("bhqk,bqhd->bkhd", wb, dah)
    dwt = torch.einsum("bqhd,bkhd->bhqk", dah, vh.float())
    dlg = (w * (dwt - (dwt * w).sum(-1, keepdim=True))).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", dlg, ks.float()) * sf
    dk = torch.einsum("bhqk,bqhd->bkhd", dlg, qs.float()) * sf
    gq = torch.stack([dq, dk, dv], dim=2).reshape(B, S, 3 * C)
    gqb = gq.to(dt).float()
    dh = gqb @ w_qkv.float().t()
    dw_qkv = torch.einsum("bsc,bsj->cj", h.float(), gqb)
    db_qkv = gq.sum(dim=(0, 1))
    dw_proj = torch.einsum("bsc,bsj->cj", a.reshape(B, S, C).float(), ctf)
    db_proj = ctf.sum(dim=(0, 1))
    dgs = (dh * hp).sum(dim=(0, 1))
    dgb = dh.sum(dim=(0, 1))
    dhp = dh * gn_scale.float()
    g1 = dhp.reshape(B, S, GROUPS, cg).mean(dim=(1, 3))
    g2 = (dhp * hp).reshape(B, S, GROUPS, cg).mean(dim=(1, 3))
    g1c = g1.repeat_interleave(cg, dim=1)[:, None]
    g2c = g2.repeat_interleave(cg, dim=1)[:, None]
    dx = (ctf + inv_c * (dhp - g1c - hp * g2c)).to(dt)
    return dx, dgs, dgb, dw_qkv, db_qkv, dw_proj, db_proj


# K6 fp32 in one launch a sample (``csrc/attn_block_bwd_small.cu``): a
# block, or a cluster of two splitting the heads, holds one sample's working
# set in shared memory at S = 64 and C = 32 or 64 (217 KB at C = 64; C = 96
# or S = 128 would need 326 or 410 KB), with head dims of 16, 32 or 64;
# other shapes take the multi-launch route
BWD_SMALL_S, BWD_SMALL_WIDTHS, BWD_SMALL_HEAD_DIMS = 64, (32, 64), (16, 32, 64)


def bwd_small_takes(S: int, C: int, num_heads: int,
                    dtype: torch.dtype) -> bool:
    """Whether K6 runs its one-launch-a-sample route at this shape."""
    return (dtype == torch.float32 and S == BWD_SMALL_S
            and C in BWD_SMALL_WIDTHS and C % num_heads == 0
            and C // num_heads in BWD_SMALL_HEAD_DIMS)


def _attn_block_bwd_small(x, ct, gn_scale, gn_bias, w_qkv, b_qkv, w_proj,
                          nh, eps):
    """K6 fp32 at a shape ``bwd_small_takes``: one block (two, when the
    heads split evenly) a sample writes dx and the sample's parameter
    cotangents, a second launch sums those in sample order; it counts as
    ``attn_block_bwd_small``."""
    B, S, C = x.shape
    n = 4 * C * C + 6 * C
    f32 = dict(device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    out = torch.empty(n, **f32)
    part = torch.empty(B * n, **f32)
    ptrs = [t.data_ptr() for t in (x, ct, gn_scale, gn_bias, w_qkv, b_qkv,
                                   w_proj, dx, out, part)]
    code = _lib.lib().dxmi_attn_block_bwd_small(
        *ptrs, B, S, C, nh, GROUPS, float(eps), _lib.stream())
    _lib.check(code, "dxmi_attn_block_bwd_small")
    _lib.LAUNCHES["attn_block_bwd_small"] += 1
    dw_qkv, dw_proj, db_qkv, db_proj, dgs, dgb = out.split(
        [3 * C * C, C * C, 3 * C, C, C, C])
    return (dx, dgs, dgb, dw_qkv.view(C, 3 * C), db_qkv, dw_proj.view(C, C),
            db_proj)


# fp32 partials of the weight GEMMs: one slice per this many rows of B * S
# (at most 32 slices); bias sums: one chunk per 1024 rows
BWD_ROWS_PER_SLICE, BWD_MAX_SLICES, BWD_ROWS_PER_CHUNK = 4096, 32, 1024


def attn_block_bwd(x, ct, gn_scale, gn_bias, w_qkv, b_qkv, w_proj,
                   num_heads: int, eps: float = 1e-5):
    """The block's backward: (dx, dgs, dgb, dw_qkv, db_qkv, dw_proj,
    db_proj) as ``attn_block_bwd_reference``. On the card: K6, for shapes
    that ``fused_attn_bwd_available`` admits, fp32 or bf16 ``x`` with
    d % 4 == 0 and d <= 64 (others raise); weights and biases in x's dtype,
    GN parameters fp32. fp32 at a shape ``bwd_small_takes`` runs one launch
    a sample and counts as ``attn_block_bwd_small``; other fp32 shapes
    count as ``attn_block_bwd``, bf16 as ``attn_block_bwd_bf16``."""
    if x.device.type == "cpu":
        return attn_block_bwd_reference(x, ct, gn_scale, gn_bias, w_qkv,
                                        b_qkv, w_proj, num_heads, eps)
    B, S, C = x.shape
    nh, dt, dev = num_heads, x.dtype, x.device
    d = C // nh
    if not fused_attn_bwd_available(S, C, nh):
        raise ValueError(f"attn_block_bwd kernel: S={S}, C={C}, nh={nh} "
                         "outside fused_attn_bwd_available")
    if dt not in (torch.float32, torch.bfloat16) or d % 4 or d > 64:
        raise NotImplementedError(f"attn_block_bwd kernel: d={d} in {dt} not "
                                  "ported yet (d % 4 == 0, d <= 64)")
    _lib.require(x, "x", (B, S, C), dtype=dt)
    _lib.require(ct, "ct", (B, S, C), dtype=dt, device=dev)
    for name, t, shape, dtype in (
            ("gn_scale", gn_scale, (C,), torch.float32),
            ("gn_bias", gn_bias, (C,), torch.float32),
            ("w_qkv", w_qkv, (C, 3 * C), dt), ("b_qkv", b_qkv, (3 * C,), dt),
            ("w_proj", w_proj, (C, C), dt)):
        _lib.require(t, name, shape, dtype=dtype, device=dev)
    if bwd_small_takes(S, C, nh, dt):
        return _attn_block_bwd_small(x, ct, gn_scale, gn_bias, w_qkv, b_qkv,
                                     w_proj, nh, eps)
    M = B * S
    splits = max(1, min(BWD_MAX_SLICES, M // BWD_ROWS_PER_SLICE))
    chunks = -(-M // BWD_ROWS_PER_CHUNK)
    f32 = dict(device=dev, dtype=torch.float32)
    dx = torch.empty_like(x)
    grads = [torch.empty(n, **f32) for n in
             (C, C, C * 3 * C, 3 * C, C * C, C)]
    scratch_f = [torch.empty(n, **f32) for n in (
        B * C, B * C, B * nh * S, B * nh * S, M * 3 * C, M * C,
        max(splits * 3 * C * C, chunks * 3 * C, 2 * B * C))]
    mean_c, rstd_c, lse, di, dqkv_f, dh, part = scratch_f
    h, da, a = (torch.empty((M, C), device=dev, dtype=dt) for _ in range(3))
    qkv, dqkv_t = (torch.empty((M, 3 * C), device=dev, dtype=dt)
                   for _ in range(2))
    form = "attn_block_bwd_bf16" if dt == torch.bfloat16 else "attn_block_bwd"
    ptrs = [t.data_ptr() for t in (x, ct, gn_scale, gn_bias, w_qkv, b_qkv,
                                   w_proj, dx, *grads, mean_c, rstd_c, h, qkv,
                                   da, a, lse, di, dqkv_f, dqkv_t, dh, part)]
    code = getattr(_lib.lib(), f"dxmi_{form}")(
        *ptrs, B, S, C, nh, GROUPS, float(eps), splits, chunks, _lib.stream())
    _lib.check(code, f"dxmi_{form}")
    _lib.LAUNCHES[form] += 1
    dgs, dgb, dw_qkv, db_qkv, dw_proj, db_proj = grads
    return (dx, dgs, dgb, dw_qkv.reshape(C, 3 * C), db_qkv,
            dw_proj.reshape(C, C), db_proj)


class FusedAttnBlockTrain(torch.autograd.Function):
    """The attention block with K2 forward and K6 backward; saves only x and
    the parameters. Weights and biases arrive in any float dtype (the fp32
    master parameters of training) and are cast to x's dtype for the
    kernels; their cotangents return in the parameters' dtypes."""

    @staticmethod
    def forward(ctx, x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj,
                num_heads, eps):
        dt = x.dtype
        y = _attn_block_k2(x, gn_scale, gn_bias, w_qkv.to(dt).contiguous(),
                           b_qkv.to(dt), w_proj.to(dt).contiguous(),
                           b_proj.to(dt), num_heads, eps)
        ctx.save_for_backward(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj,
                              b_proj)
        ctx.num_heads, ctx.eps = num_heads, eps
        return y

    @staticmethod
    def backward(ctx, ct):
        x, gs, gb, wq, bq, wp, bp = ctx.saved_tensors
        dt = x.dtype
        dx, dgs, dgb, dwq, dbq, dwp, dbp = attn_block_bwd(
            x, ct.to(dt).contiguous(), gs, gb, wq.to(dt).contiguous(),
            bq.to(dt), wp.to(dt).contiguous(), ctx.num_heads, ctx.eps)
        return (dx, dgs.to(gs.dtype), dgb.to(gb.dtype), dwq.to(wq.dtype),
                dbq.to(bq.dtype), dwp.to(wp.dtype), dbp.to(bp.dtype), None,
                None)


def fused_attn_block_train(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj,
                           b_proj, num_heads: int,
                           eps: float = 1e-5) -> torch.Tensor:
    """The attention block for training: K2 forward, K6 backward
    (``FusedAttnBlockTrain``). x: (B, S, C); w_qkv (C, 3C); w_proj (C, C)."""
    return FusedAttnBlockTrain.apply(x, gn_scale, gn_bias, w_qkv, b_qkv,
                                     w_proj, b_proj, num_heads, eps)


# ---- the int8 block: K5 -------------------------------------------------


class Int8AttnMats(NamedTuple):
    """The int8 block's prepared operands (``_prep_int8_mats``), weights in
    the kernel's output-major layout: ``wq`` (3C, C) and ``wp`` (C, C) int8,
    one row per output channel with the activation scales folded into it;
    ``swq`` (3C,) and ``swp`` (C,) fp32 dequantisation scales; ``isa_q`` and
    ``isa_p`` (C,) fp32 reciprocal activation scales."""
    wq: torch.Tensor
    swq: torch.Tensor
    isa_q: torch.Tensor
    wp: torch.Tensor
    swp: torch.Tensor
    isa_p: torch.Tensor


def prep_int8_mats(w_qkv: torch.Tensor, w_proj: torch.Tensor,
                   sa_qkv: torch.Tensor, sa_proj: torch.Tensor
                   ) -> Int8AttnMats:
    """``_prep_int8_mats`` (``attn_block.py:672``): fold the activation
    scales (floored at 1e-8, so that uncalibrated zeros stay finite) into
    the fp32 weights' input axes and quantise per output channel. ``w_qkv``
    is (C, 3C) and ``w_proj`` (C, C), as ``attn_block`` takes them."""
    C = w_qkv.shape[0]
    sa_q = torch.clamp(sa_qkv.float().reshape(C), min=1e-8)
    sa_p = torch.clamp(sa_proj.float().reshape(C), min=1e-8)
    wq, swq = quantize_per_channel(w_qkv.float() * sa_q[:, None], axis=-1)
    wp, swp = quantize_per_channel(w_proj.float() * sa_p[:, None], axis=-1)
    return Int8AttnMats(wq.t().contiguous(), swq.reshape(-1).contiguous(),
                        (1.0 / sa_q).contiguous(), wp.t().contiguous(),
                        swp.reshape(-1).contiguous(),
                        (1.0 / sa_p).contiguous())


def attn_block_int8_reference(x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj,
                              b_proj, sa_qkv, sa_proj, num_heads: int,
                              eps: float = 1e-5) -> torch.Tensor:
    """The JAX package's oracle of the int8 block
    (``attn_block_int8_reference``, ``attn_block.py:322``): GN in fp32, h
    rounded to the compute dtype, ``int8_matmul_static`` qkv, the attention
    in the compute dtype with an fp32 softmax, ``int8_matmul_static`` proj,
    residual."""
    B, S, C = x.shape
    nh = num_heads
    d = C // nh
    dt = x.dtype
    g = x.float().reshape(B, S, GROUPS, C // GROUPS)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
    h = ((g - mean) * torch.rsqrt(var + eps)).reshape(B, S, C)
    h = (h * gn_scale + gn_bias).to(dt)
    qkv = int8_matmul_static(h, w_qkv, b_qkv, sa_qkv, out_dtype=dt)
    qkv = qkv.reshape(B, S, 3, nh, d)
    scale = torch.tensor(1.0 / math.sqrt(math.sqrt(d)), dtype=dt)
    q, k, v = qkv[:, :, 0] * scale, qkv[:, :, 1] * scale, qkv[:, :, 2]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    w = torch.softmax(logits, dim=-1).to(dt)
    a = torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(dt)
    y = int8_matmul_static(a.reshape(B, S, C), w_proj, b_proj, sa_proj,
                           out_dtype=dt)
    return x + y


def _quant_rows(a: torch.Tensor, isa: torch.Tensor) -> torch.Tensor:
    """round(a * isa), clipped to +-127, as float64 int8 values."""
    return torch.clamp(torch.round(a * isa), -127, 127).double()


def attn_block_int8_plain(x, gn_scale, gn_bias, mats: Int8AttnMats, b_qkv,
                          b_proj, num_heads: int,
                          eps: float = 1e-5) -> torch.Tensor:
    """Plain K5, the arithmetic of the TPU body ``_kernel_i8``: fp32 GN
    statistics (two-pass here, one-pass there: they differ at fp32
    rounding), h quantised straight from the fp32 epilogue x * s_c + t_c;
    exact int8 products (float64 sums of integers); qkv = dt(acc * swq +
    b_qkv); q and k scaled by dt(d^-1/4) in dt; the attention core in dt
    with an fp32 softmax; the output quantised, proj = dt(acc * swp +
    b_proj); y = x + proj in dt."""
    B, S, C = x.shape
    nh = num_heads
    d = C // nh
    dt = x.dtype
    xf = x.float()
    g = xf.reshape(B, S, GROUPS, C // GROUPS)
    mean = g.mean(dim=(1, 3))
    rstd = torch.rsqrt((g - mean[:, None, :, None]).square().mean(dim=(1, 3))
                       + eps)
    s_c = gn_scale.float() * rstd.repeat_interleave(C // GROUPS, dim=1)
    t_c = gn_bias.float() - mean.repeat_interleave(C // GROUPS, dim=1) * s_c
    h_i8 = _quant_rows(xf * s_c[:, None] + t_c[:, None], mats.isa_q)
    acc = (h_i8 @ mats.wq.double().t()).to(torch.int32)
    qkv = (acc.float() * mats.swq + b_qkv.float()).to(dt).reshape(B, S, 3, nh,
                                                                  d)
    scale = torch.tensor(1.0 / math.sqrt(math.sqrt(d)), dtype=dt)
    q, k, v = qkv[:, :, 0] * scale, qkv[:, :, 1] * scale, qkv[:, :, 2]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    w = torch.softmax(logits, dim=-1).to(dt)
    a = torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(dt)
    a_i8 = _quant_rows(a.reshape(B, S, C).float(), mats.isa_p)
    acc = (a_i8 @ mats.wp.double().t()).to(torch.int32)
    y = (acc.float() * mats.swp + b_proj.float()).to(dt)
    return x + y


def attn_block_int8(x, gn_scale, gn_bias, mats: Int8AttnMats, b_qkv, b_proj,
                    num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """The int8 attention block on fp32 or bf16 ``x`` (B, S, C) with fp32
    GN parameters and biases and prepared int8 weights. On the card: K5,
    for shapes that ``fused_attn_available(..., int8=True)`` admits, in the
    forms that ``kernel_takes`` names (others raise); it counts as
    ``attn_block_i8``."""
    if x.device.type == "cpu":
        return attn_block_int8_plain(x, gn_scale, gn_bias, mats, b_qkv,
                                     b_proj, num_heads, eps)
    B, S, C = x.shape
    dt = x.dtype
    if not fused_attn_available(S, C, num_heads, int8=True):
        raise ValueError(f"attn_block_int8 kernel: S={S}, C={C}, "
                         f"nh={num_heads} outside fused_attn_available")
    if not kernel_takes(C, num_heads, dt, int8=True):
        raise NotImplementedError(
            f"attn_block_int8 kernel: d={C // num_heads} in {dt} not ported "
            "yet (fp32 at d % 16 == 0, bf16 at d % 8 == 0 and d <= 128)")
    dev = x.device
    _lib.require(x, "x", (B, S, C), dtype=dt)
    for name, t, shape, dtype in (
            ("gn_scale", gn_scale, (C,), torch.float32),
            ("gn_bias", gn_bias, (C,), torch.float32),
            ("wq", mats.wq, (3 * C, C), torch.int8),
            ("swq", mats.swq, (3 * C,), torch.float32),
            ("isa_q", mats.isa_q, (C,), torch.float32),
            ("b_qkv", b_qkv, (3 * C,), torch.float32),
            ("wp", mats.wp, (C, C), torch.int8),
            ("swp", mats.swp, (C,), torch.float32),
            ("isa_p", mats.isa_p, (C,), torch.float32),
            ("b_proj", b_proj, (C,), torch.float32)):
        _lib.require(t, name, shape, dtype=dtype, device=dev)
    y = torch.empty_like(x)
    stats = torch.empty((2, B * C), device=dev, dtype=torch.float32)
    qkv = torch.empty((B, S, 3 * C), device=dev, dtype=dt)
    attn = torch.empty((B, S, C), device=dev, dtype=dt)
    code = _lib.lib().dxmi_attn_block_i8(
        x.data_ptr(), int(dt == torch.bfloat16), gn_scale.data_ptr(),
        gn_bias.data_ptr(), mats.wq.data_ptr(), mats.swq.data_ptr(),
        mats.isa_q.data_ptr(), b_qkv.data_ptr(), mats.wp.data_ptr(),
        mats.swp.data_ptr(), mats.isa_p.data_ptr(), b_proj.data_ptr(),
        y.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
        qkv.data_ptr(), attn.data_ptr(), B, S, C, num_heads, GROUPS,
        float(eps), _lib.stream())
    _lib.check(code, "dxmi_attn_block_i8")
    _lib.LAUNCHES["attn_block_i8"] += 1
    return y
