"""Flash attention for the ADM nets' large self-attention maps: kernel K4
(forward), its backward kernels K4-dkv and K4-dq, and their plain versions.

``flash_mha`` mirrors ``dxmi_tpu.ops.attention.flash_mha``: q, k, v in the
ADM nets' (B, S, nh, d) layout, softmax(q k^T * sm_scale) v per head. On a
CPU tensor it runs the plain version, on a CUDA tensor it launches the
hand-written kernel in ``csrc/flash_attn.cu`` (or raises): wgmma products,
K/V tiles streamed by TMA through a producer warpgroup. The kernel takes
bf16, the dtype of the ADM nets' flash path; q, k and v may be strided views
of one (B, S, 3, nh, d) qkv tensor, which saves three copies. The tensor
maps need 16-byte aligned bases and row strides that are multiples of 8
elements (``_check_operand`` raises otherwise; nothing is copied).

The TPU kernel it replaces (JAX's bundled Pallas flash attention with one kv
block, ``dxmi_tpu/ops/attention.py:53`` ``_flash_bnsd``) forms fp32 logits,
scales them by ``sm_scale``, takes an fp32 softmax normalised before p is cast
to the input dtype, and accumulates p v in fp32. The CUDA kernel streams K/V
in tiles with an online softmax, so it casts p before normalising and divides
by the row sum at the end; the plain version follows the TPU body.

Training (``flash_attention_qkv`` with gradients on) runs the forward with
each row's logsumexp as residual (the ``l`` and ``m`` of
``_flash_attention_fwd``, ``flash_attention.py:234-251``) and the backward
of ``jax.grad`` through ``_flash_bnsd``: di = rowsum(o do) in fp32
(``:273-275``); from p = exp(s sm_scale - lse) in fp32, dv = bf16(p)^T do and
dk = bf16(ds)^T q with ds = (do v^T - di) p sm_scale (``_flash_attention_dkv
_kernel``, ``:796``), then dq = bf16(ds) k (``_flash_attention_dq_kernel``,
``:1146``); sums in fp32, each gradient cast to bf16. On the card these are
the hand-written kernels in ``csrc/flash_attn_bwd.cu``: K4-dkv and K4-dq,
both on the tensor cores (mma.sync, fp32 sums). q, k and v arrive as
views of one (B, S, 3, nh, d) qkv tensor, and their gradients leave in one
buffer of that shape.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from dxmi_tpu_torch.ops import _lib


def flash_available(seq_len: int, head_dim: int) -> bool:
    """The JAX gate without its backend test: S >= 512, S % 128 == 0 and
    d <= 128."""
    return seq_len >= 512 and seq_len % 128 == 0 and head_dim <= 128


def flash_mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float) -> torch.Tensor:
    """Plain attention on (B, S, nh, d): fp32 logits times ``sm_scale``,
    fp32 softmax, p cast to the input dtype, p v accumulated in fp32 and
    cast to the input dtype."""
    return flash_mha_reference_fwd(q, k, v, sm_scale)[0]


def flash_mha_reference_fwd(q, k, v, sm_scale: float):
    """The plain forward with its residual: (o, lse), lse = logsumexp of the
    fp32 scaled logits, (B, nh, S) fp32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)
    return o, torch.logsumexp(logits, dim=-1)


def _plain_bwd_parts(qkv, o, lse, do, sm_scale):
    """fp32 q, k, v, do, p and the rounded ds of the plain backward."""
    dt = qkv.dtype
    q, k, v = (t.float() for t in qkv.unbind(2))
    di = (o.float() * do.float()).sum(-1).permute(0, 2, 1)  # (B, nh, S)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * sm_scale
    p = torch.exp(logits - lse[..., None])
    dof = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v)
    ds = ((dp - di[..., None]) * p * sm_scale).to(dt).float()
    return q, k, dof, p, ds


def flash_reference_dkv(qkv, o, lse, do, sm_scale):
    """Plain K4-dkv: (dk, dv) in qkv's dtype."""
    dt = qkv.dtype
    q, _, dof, p, ds = _plain_bwd_parts(qkv, o, lse, do, sm_scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return dk.to(dt), dv.to(dt)


def flash_reference_dq(qkv, o, lse, do, sm_scale):
    """Plain K4-dq: dq in qkv's dtype."""
    _, k, _, _, ds = _plain_bwd_parts(qkv, o, lse, do, sm_scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k).to(qkv.dtype)


def flash_mha_reference_bwd(qkv: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            sm_scale: float) -> torch.Tensor:
    """Plain backward of the flash attention with the TPU kernels' roundings:
    di = rowsum(o do) in fp32, then dk and dv, then dq, each recomputing p in
    fp32 from ``lse``. qkv: (B, S, 3, nh, d); o, do: (B, S, nh, d); lse:
    (B, nh, S). Returns dqkv (B, S, 3, nh, d) in qkv's dtype."""
    dk, dv = flash_reference_dkv(qkv, o, lse, do, sm_scale)
    dq = flash_reference_dq(qkv, o, lse, do, sm_scale)
    return torch.stack([dq, dk, dv], dim=2)


def _check_operand(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device or t.dtype != torch.bfloat16:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected bf16 on "
                         f"{device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.stride(3) != 1 or t.stride(2) != shape[3] or t.stride(1) % 8 \
            or t.stride(0) != shape[1] * t.stride(1) or t.data_ptr() % 16:
        raise ValueError(f"{name}: needs unit stride in d, heads d apart, a "
                         "row stride that is a multiple of 8, and 16-byte "
                         "alignment")


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sm_scale: float) -> torch.Tensor:
    """softmax(q k^T * sm_scale) v for q, k, v of shape (B, S, nh, d);
    returns (B, S, nh, d) contiguous. On the card: K4, for shapes that
    ``flash_available`` admits, in bf16 (other dtypes raise); it counts as
    ``flash_attn``. Differentiable (``FlashAttention``) when a gradient is
    wanted."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, sm_scale)
    if q.device.type == "cpu":
        return flash_mha_reference(q, k, v, sm_scale)
    B, S, nh, d = q.shape
    if not flash_available(S, d):
        raise ValueError(f"flash_mha kernel: S={S}, d={d} outside "
                         "flash_available")
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(f"flash_mha kernel: {q.dtype} not ported "
                                  "yet (bf16 only)")
    if d % 8:
        # 16-byte loads: pad the head dimension with zeros, which change
        # neither the logits nor the kept output columns
        pad = 8 - d % 8
        out = flash_mha(*(F.pad(t, (0, pad)) for t in (q, k, v)), sm_scale)
        return out[..., :d].contiguous()
    return flash_fwd_kernel(q, k, v, sm_scale)


def flash_fwd_kernel(q, k, v, sm_scale, lse=None):
    """K4 on bf16 CUDA views q, k, v (B, S, nh, d) with one row stride, at
    any S % 64 == 0 and d % 8 == 0, d <= 128 (``_check_operand``'s layout);
    writes each row's logsumexp into ``lse`` (B, nh, S) fp32 when given.
    Returns o (B, S, nh, d) contiguous; counts as ``flash_attn``."""
    B, S, nh, d = q.shape
    if S % 64 or d % 8 or d > 128:
        raise ValueError(f"flash_attn kernel: S={S}, d={d} (needs S % 64 == "
                         "0, d % 8 == 0, d <= 128)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(t, name, (B, S, nh, d), q.device)
    if not q.stride(1) == k.stride(1) == v.stride(1):
        raise ValueError("flash_attn kernel: q, k and v need one row stride")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn kernel: on {q.device}, needs CUDA")
    if lse is not None:
        _lib.require(lse, "lse", (B, nh, S), device=q.device)
    out = torch.empty((B, S, nh, d), device=q.device, dtype=torch.bfloat16)
    code = _lib.lib().dxmi_flash_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, S, nh, d, q.stride(1),
        nh * d, float(sm_scale), _lib.stream())
    _lib.check(code, "dxmi_flash_attn")
    _lib.LAUNCHES["flash_attn"] += 1
    return out


def _check_train_shape(qkv: torch.Tensor) -> None:
    B, S, three, nh, d = qkv.shape
    if three != 3 or not flash_available(S, d):
        raise ValueError(f"flash attention training: qkv {tuple(qkv.shape)} "
                         "outside flash_available")
    if qkv.dtype != torch.bfloat16:
        raise NotImplementedError(f"flash attention training: {qkv.dtype} "
                                  "not ported yet (bf16 only)")
    if d % 8 or d > 64:
        raise NotImplementedError(f"flash attention backward: d={d} not "
                                  "ported yet (d % 8 == 0, d <= 64)")


def flash_mha_fwd(qkv: torch.Tensor, sm_scale: float):
    """(o, lse) for qkv (B, S, 3, nh, d): the forward with its residual. On
    the card: K4 with its logsumexp output (counts as ``flash_attn``)."""
    q, k, v = qkv.unbind(2)
    if qkv.device.type == "cpu":
        return flash_mha_reference_fwd(q, k, v, sm_scale)
    _check_train_shape(qkv)
    B, S, _, nh, _ = qkv.shape
    lse = torch.empty((B, nh, S), device=qkv.device, dtype=torch.float32)
    return flash_fwd_kernel(q, k, v, sm_scale, lse), lse


def flash_mha_bwd(qkv: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                  do: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """dqkv (B, S, 3, nh, d) from the forward's qkv, o and lse and the
    cotangent ``do`` of o. On the card: K4-dkv (which also forms di) and
    K4-dq."""
    if qkv.device.type == "cpu":
        return flash_mha_reference_bwd(qkv, o, lse, do, sm_scale)
    qkv = qkv.contiguous()
    do = do.to(torch.bfloat16).contiguous()
    di, dqkv = flash_bwd_dkv(qkv, o, lse, do, sm_scale)
    flash_bwd_dq(qkv, do, lse, di, dqkv, sm_scale)
    return dqkv


def flash_bwd_dkv(qkv, o, lse, do, sm_scale, dqkv=None):
    """K4-dkv on contiguous bf16 qkv (B, S, 3, nh, d), o, do (B, S, nh, d)
    and lse (B, nh, S): returns (di, dqkv) with dk and dv written into dqkv
    (a new buffer unless given). Counts as ``flash_attn_bwd_dkv``."""
    _check_train_shape(qkv)
    B, S, _, nh, d = qkv.shape
    dev = qkv.device
    _lib.require(qkv, "qkv", (B, S, 3, nh, d), dtype=torch.bfloat16)
    _lib.require(o, "o", (B, S, nh, d), dtype=torch.bfloat16, device=dev)
    _lib.require(do, "do", (B, S, nh, d), dtype=torch.bfloat16, device=dev)
    _lib.require(lse, "lse", (B, nh, S), device=dev)
    di = torch.empty((B, nh, S), device=dev, dtype=torch.float32)
    if dqkv is None:
        dqkv = torch.empty_like(qkv)
    code = _lib.lib().dxmi_flash_attn_bwd_dkv(
        qkv.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dqkv.data_ptr(), B, S, nh, d, float(sm_scale),
        _lib.stream())
    _lib.check(code, "dxmi_flash_attn_bwd_dkv")
    _lib.LAUNCHES["flash_attn_bwd_dkv"] += 1
    return di, dqkv


def flash_bwd_dq(qkv, do, lse, di, dqkv, sm_scale):
    """K4-dq: writes dq into ``dqkv`` from K4-dkv's ``di``. Counts as
    ``flash_attn_bwd_dq``."""
    _check_train_shape(qkv)
    B, S, _, nh, d = qkv.shape
    _lib.require(dqkv, "dqkv", (B, S, 3, nh, d), dtype=torch.bfloat16,
                 device=qkv.device)
    _lib.require(di, "di", (B, nh, S), device=qkv.device)
    code = _lib.lib().dxmi_flash_attn_bwd_dq(
        qkv.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
        dqkv.data_ptr(), B, S, nh, d, float(sm_scale), _lib.stream())
    _lib.check(code, "dxmi_flash_attn_bwd_dq")
    _lib.LAUNCHES["flash_attn_bwd_dq"] += 1
    return dqkv


def qkv_of(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The (B, S, 3, nh, d) tensor whose views q, k and v are (a view of the
    same storage when they are the model's views of one qkv tensor, else a
    stacked copy)."""
    B, S, nh, d = q.shape
    st = q.stride()
    el = q.element_size()
    if (k.stride() == st and v.stride() == st and st[3] == 1 and st[2] == d
            and st[1] == 3 * nh * d and st[0] == S * st[1]
            and k.data_ptr() == q.data_ptr() + nh * d * el
            and v.data_ptr() == q.data_ptr() + 2 * nh * d * el):
        return torch.as_strided(q, (B, S, 3, nh, d),
                                (st[0], st[1], nh * d, d, 1))
    return torch.stack((q, k, v), dim=2)


class FlashAttention(torch.autograd.Function):
    """softmax(q k^T sm_scale) v with the flash backward; saves q, k, v (as
    their qkv tensor), o and lse, and returns dq, dk and dv as views of one
    (B, S, 3, nh, d) gradient buffer."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        qkv = qkv_of(q, k, v)
        o, lse = flash_mha_fwd(qkv, sm_scale)
        ctx.save_for_backward(qkv, o, lse)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_mha_bwd(qkv, o, lse, do, ctx.sm_scale).unbind(2)
        return dq, dk, dv, None
