"""The card checks of the bf16 attention kernels (chip_smoke.attn_bf16_check
for K2, chip_smoke.flash_check for K4), held on the CPU against replicas of
the kernels' arithmetic: each check passes a replica that sums in another
order (K2: float64 sums; K4: the kernel's online softmax over 64-key tiles,
p rounded before it is normalised) and fails the same replica with a fault
planted (a dropped 64-key tile, a q/k scale a few percent off, uniform
attention weights)."""
import math

import numpy as np
import pytest
import torch

from chip_smoke import attn_bf16_check, flash_check
from dxmi_tpu_torch.ops.attention import flash_mha_reference
from dxmi_tpu_torch.ops.attn_block import GROUPS, attn_block_reference

BF16 = torch.bfloat16


def _attn_inputs(S, C, seed):
    """chip_smoke.attn_bf16_case's distributions, one sample."""
    g = torch.Generator().manual_seed(seed)

    def n(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=g) * scale + shift

    return (n(1, S, C, scale=2.0, shift=0.5).to(BF16), n(C, scale=0.1,
                                                         shift=1.0),
            n(C, scale=0.1), n(C, 3 * C, scale=C ** -0.5).to(BF16),
            n(3 * C, scale=0.1).to(BF16), n(C, C, scale=C ** -0.5).to(BF16),
            n(C, scale=0.1).to(BF16))


def _attn_replica(x, gs, gb, wq, bq, wp, bp, nh, fault=None, eps=1e-5):
    """The bf16 block with its sums in float64 (another order than the
    plain version's fp32), rounding where the kernel rounds."""
    B, S, C = x.shape
    d = C // nh
    xf = x.double()
    g = xf.reshape(B, S, GROUPS, C // GROUPS)
    mean = g.mean(dim=(1, 3))
    rstd = torch.rsqrt((g - mean[:, None, :, None]).square().mean(dim=(1, 3))
                       + eps)
    s_c = gs.double() * rstd.repeat_interleave(C // GROUPS, 1)
    t_c = gb.double() - mean.repeat_interleave(C // GROUPS, 1) * s_c
    h = (xf * s_c[:, None] + t_c[:, None]).to(BF16)
    qkv = ((h.double() @ wq.double()).to(BF16) + bq).reshape(B, S, 3, nh, d)
    sc = 1.0 / math.sqrt(math.sqrt(d)) * (0.97 if fault == "scale" else 1.0)
    sc = torch.tensor(sc, dtype=BF16)
    q, k, v = qkv[:, :, 0] * sc, qkv[:, :, 1] * sc, qkv[:, :, 2]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double())
    if fault == "drop":
        logits[..., 64:128] = -math.inf
    if fault == "uniform":
        logits = torch.zeros_like(logits)
    w = torch.softmax(logits, dim=-1).to(BF16)
    a = torch.einsum("bhqk,bkhd->bqhd", w.double(), v.double()).to(BF16)
    return x + ((a.reshape(B, S, C).double() @ wp.double()).to(BF16) + bp)


ATTN_SHAPES = [(1024, 384, 6), (256, 576, 9), (64, 768, 12)]


@pytest.mark.parametrize("S,C,nh", ATTN_SHAPES)
def test_attn_bf16_check_passes_another_order(S, C, nh):
    a = _attn_inputs(S, C, seed=S)
    rel, _, share = attn_bf16_check(_attn_replica(*a, nh),
                                    attn_block_reference(*a, num_heads=nh),
                                    a[0], "replica")
    assert rel < 1e-3 and share < 0.5, (rel, share)


# (a map of 64 keys is one tile: it has none to drop)
@pytest.mark.parametrize("S,C,nh,fault", [
    (S, C, nh, fault) for S, C, nh in ATTN_SHAPES
    for fault in ("drop", "scale", "uniform") if S > 64 or fault != "drop"])
def test_attn_bf16_check_fails_planted_fault(S, C, nh, fault):
    a = _attn_inputs(S, C, seed=S)
    with pytest.raises(AssertionError, match="over the limit"):
        attn_bf16_check(_attn_replica(*a, nh, fault),
                        attn_block_reference(*a, num_heads=nh), a[0],
                        "replica")


def _flash_replica(q, k, v, sm_scale, fault=None):
    """K4's arithmetic: fp32 logits, an online softmax over 64-key tiles,
    unnormalised p rounded to bf16 before p v, one division by the row sum
    and one bf16 rounding at the end."""
    B, S, nh, d = q.shape
    sm = sm_scale * (0.99 if fault == "scale" else 1.0)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm
    if fault == "drop":
        s[..., 64:128] = -math.inf
    vt = v.float().permute(0, 2, 1, 3)
    m = torch.full(s.shape[:-1], -math.inf)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(B, nh, S, d)
    for t in range(0, S, 64):
        st = s[..., t:t + 64]
        m_new = torch.maximum(m, st.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(BF16).float() @ vt[:, :, t:t + 64]
        m = m_new
    return (acc / l[..., None]).to(BF16).permute(0, 2, 1, 3)


@pytest.mark.parametrize("fault", [None, "drop", "scale"])
def test_flash_check(fault):
    rs = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(rs.randn(1, 1024, 6, 64).astype(np.float32))
               .to(BF16) for _ in range(3))
    out = _flash_replica(q, k, v, 0.125, fault)
    ref = flash_mha_reference(q, k, v, 0.125)
    if fault is None:
        _, share = flash_check(out, ref, q, k, v, 0.125, "replica")
        assert share < 0.5, share
    else:
        with pytest.raises(AssertionError, match="over the limit"):
            flash_check(out, ref, q, k, v, 0.125, "replica")
