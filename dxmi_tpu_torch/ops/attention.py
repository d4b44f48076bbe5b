"""Flash attention for the ADM nets' large self-attention maps: kernel K4
(forward) and its plain version.

``flash_mha`` mirrors ``dxmi_tpu.ops.attention.flash_mha``: q, k, v in the
ADM nets' (B, S, nh, d) layout, softmax(q k^T * sm_scale) v per head. On a
CPU tensor it runs the plain version, on a CUDA tensor it launches the
hand-written kernel in ``csrc/flash_attn.cu`` (or raises). The kernel takes
bf16, the dtype of the ADM nets' flash path; q, k and v may be strided views
of one (B, S, 3, nh, d) qkv tensor, which saves three copies.

The TPU kernel it replaces (JAX's bundled Pallas flash attention with one kv
block, ``dxmi_tpu/ops/attention.py:53`` ``_flash_bnsd``) forms fp32 logits,
scales them by ``sm_scale``, takes an fp32 softmax normalised before p is cast
to the input dtype, and accumulates p v in fp32. The CUDA kernel streams K/V
in tiles with an online softmax, so it casts p before normalising and divides
by the row sum at the end; the plain version follows the TPU body.
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
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


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
    ``flash_attn``."""
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(t, name, (B, S, nh, d), q.device)
    if not q.stride(1) == k.stride(1) == v.stride(1):
        raise ValueError("flash_mha kernel: q, k and v need one row stride")
    out = torch.empty((B, S, nh, d), device=q.device, dtype=torch.bfloat16)
    code = _lib.lib().dxmi_flash_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, nh, d,
        q.stride(1), nh * d, float(sm_scale), _lib.stream())
    _lib.check(code, "dxmi_flash_attn")
    _lib.LAUNCHES["flash_attn"] += 1
    return out
