"""The card checks of the attention kernels (chip_smoke.attn_bf16_check for
K2's bf16 form, chip_smoke.flash_check for K4, chip_smoke.attn_i8_check for
K5), held on the CPU against replicas of the kernels' arithmetic: each check
passes a replica that sums in another order (K2: float64 sums; K4: the
kernel's online softmax over 64-key tiles, p rounded before it is
normalised; K5: float64 GN statistics and K4's core or a float64 one) and
fails the same replica with a fault planted (a dropped 64-key tile, a q/k
scale a few percent off, uniform attention weights; for K5 the neighbouring
column's dequantisation scale and a missing clip)."""
import math

import numpy as np
import pytest
import torch

from chip_smoke import (ATTN_I8_FLIP_SHARE, attn_bf16_check, attn_i8_check,
                        calibrated_attn_scales, flash_check)
from dxmi_tpu_torch.ops.attention import flash_mha_reference
from dxmi_tpu_torch.ops.attn_block import (GROUPS, attn_block_int8_plain,
                                           attn_block_reference,
                                           prep_int8_mats)

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


# ---- K5, the int8 block: chip_smoke.attn_i8_check --------------------------

def _i8_inputs(S, C, nh, dtype, seed):
    """chip_smoke's K5 case: attn_case's distributions, with the activation
    scales that calibration records for this input."""
    x, gs, gb, wq, bq, wp, bp = (t.float() for t in _attn_inputs(S, C, seed))
    sa_q, sa_p = calibrated_attn_scales(x, gs, gb, wq, bq, nh)
    return (x.to(dtype), gs, gb, prep_int8_mats(wq, wp, sa_q, sa_p), bq, bp)


def _i8_replica(x, gs, gb, mats, bq, bp, nh, fault=None, eps=1e-5):
    """K5's arithmetic in another order: GN statistics summed in float64;
    the attention core in float64 (fp32) or as K4 computes it (bf16: an
    online softmax over 64-key tiles, p rounded before it is normalised).
    Faults: the proj dequantised with its neighbouring column's scale, no
    clip before the int8 cast (an int8 cast wraps around), a dropped 64-key
    tile."""
    B, S, C = x.shape
    d = C // nh
    dt = x.dtype
    xd = x.double()
    g = xd.reshape(B, S, GROUPS, C // GROUPS)
    mean = g.mean(dim=(1, 3))
    rstd = torch.rsqrt((g - mean[:, None, :, None]).square().mean(dim=(1, 3))
                       + eps)
    s_c = gs * rstd.repeat_interleave(C // GROUPS, 1).float()
    t_c = gb - mean.repeat_interleave(C // GROUPS, 1).float() * s_c

    def quant(v, isa):
        r = torch.round(v * isa)
        if fault == "clip":  # the int8 cast of an unclipped value wraps
            return (r.to(torch.int32).to(torch.int8)).double()
        return torch.clamp(r, -127, 127).double()

    h = quant(x.float() * s_c[:, None] + t_c[:, None], mats.isa_q)
    acc = (h @ mats.wq.double().t()).to(torch.int32).float()
    qkv = (acc * mats.swq + bq).to(dt).reshape(B, S, 3, nh, d)
    sc = torch.tensor(1.0 / math.sqrt(math.sqrt(d)), dtype=dt)
    q, k, v = qkv[:, :, 0] * sc, qkv[:, :, 1] * sc, qkv[:, :, 2]
    if dt == BF16:
        a = _flash_replica(q, k, v, 1.0, "drop" if fault == "drop" else None)
    else:
        lg = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double())
        if fault == "drop":
            lg[..., 64:128] = -math.inf
        a = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(lg, dim=-1),
                         v.double()).float()
    swp = mats.swp.roll(1) if fault == "scale" else mats.swp
    acc = (quant(a.reshape(B, S, C).float(), mats.isa_p)
           @ mats.wp.double().t()).to(torch.int32).float()
    return x + (acc * swp + bp).to(dt)


I8_CASES = [(64, 64, 2, torch.float32), (256, 128, 2, torch.float32),
            (1024, 384, 6, BF16), (256, 576, 9, BF16), (64, 768, 12, BF16),
            (256, 1024, 16, BF16)]


@pytest.mark.parametrize("S,C,nh,dtype", I8_CASES)
def test_attn_i8_check_passes_another_order(S, C, nh, dtype):
    a = _i8_inputs(S, C, nh, dtype, seed=S + C)
    out = _i8_replica(*a, nh)
    ref = attn_block_int8_plain(*a, num_heads=nh)
    err, share, worst = attn_i8_check(out, ref, a[0], a[3], "replica")
    assert share <= 0.5 * ATTN_I8_FLIP_SHARE and worst <= 1, (share, worst)


@pytest.mark.parametrize("S,C,nh,dtype,fault", [
    (S, C, nh, dt, fault) for S, C, nh, dt in I8_CASES
    for fault in ("scale", "clip", "drop") if S > 64 or fault != "drop"])
def test_attn_i8_check_fails_planted_fault(S, C, nh, dtype, fault):
    a = _i8_inputs(S, C, nh, dtype, seed=S + C)
    with pytest.raises(AssertionError, match="over the limit"):
        attn_i8_check(_i8_replica(*a, nh, fault),
                      attn_block_int8_plain(*a, num_heads=nh), a[0], a[3],
                      "replica")
