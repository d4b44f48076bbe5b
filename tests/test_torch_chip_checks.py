"""The card checks of the attention kernels (chip_smoke.attn_bf16_check for
K2's bf16 form, chip_smoke.flash_check for K4, chip_smoke.attn_i8_check for
K5, chip_smoke.flash_bwd_check for K4-dkv and K4-dq,
chip_smoke.attn_bwd_check for K6), held on the CPU against replicas of the
kernels' arithmetic: each check passes a replica that sums in another order
(K2: float64 sums; K4: the
kernel's online softmax over 64-key tiles, p rounded before it is
normalised; K5: float64 GN statistics and K4's core or a float64 one; K2
also the wgmma GEMMs' sums over 64-wide k-blocks) and fails the same
replica with a fault planted (a dropped 64-key tile, a q/k scale a few
percent off, uniform attention weights; for the wgmma GEMMs of K2 bf16 and
K5 a 64-wide k-block of the qkv or proj product dropped, two 16-byte chunks
of every A row swapped, the q/k scale missing on one head; for K4's wgmma
kernel
also a dropped 128-key tile, one consumer warpgroup's 64 rows left out and
p normalised by the running sum; for K5 the neighbouring
column's dequantisation scale and a missing clip; for the backward kernels
dk and dv swapped, di left out, dgs and dgb swapped, a missing GroupNorm
backward term; for the tensor-core kernels one warp's 16 keys of dk and dv
left out, a 16-wide k-step of the head dim dropped, p or w not normalised;
for the query-stationary dq kernel one warp's 16 query rows of dq left
out, a 16-key k-step of dq dropped, and, in K4's gate, ds from the
bf16-rounded p; di from the bf16-rounded w, and in K6's gate ds from the
bf16-rounded w, stay inside the gates, measured blind spots). K4's logsumexp gate fails a logsumexp off by log 2, in
log2 units or shifted by a row, and the chained backward gate (kernel
forward and backward against the plain ones) fails the first of these, which
the backward's own gate lets pass. The E3 wiring gate
(chip_smoke.wiring_check) fails cotangents of the autograd Functions wired
to the wrong input or dropped. K4's kernel entry refuses operands its TMA
tensor maps cannot describe, and the fp32 gate of K7 and of K2 (on K7's
launches, after K1's two-pass statistics) passes an emulation of their
3xTF32 products and fails one-pass TF32. K1's gates pass an emulation of
its order of sums (per-thread rows, row lanes, channels, the cluster's
CTAs) and fail it with a CTA's partial sums dropped, a slab's statistics
taken one group over, one-pass sums where two-pass are due, or the squares
of the bf16 one-pass sums left unrounded. K3's gate (chip_smoke.conv_check)
passes a replica of its wgmma implicit GEMM (the window rounded once to
bf16, fp32 sums per k-step, tap and chunk, slices added in order) at the
four map sizes and fails it with one tap's 64-channel k-block dropped,
border outputs reading the neighbouring row's pixel, the window's border
not zeroed, the bias left out, one consumer warpgroup's rows left out, a
slice dropped or added twice, or the neighbouring group's statistics."""
import math

import numpy as np
import pytest
import torch

from chip_smoke import (ATTN_I8_FLIP_SHARE, TOL, attn_bf16_check,
                        attn_i8_check, calibrated_attn_scales, flash_check,
                        max_err)
from dxmi_tpu_torch.ops.attention import flash_fwd_kernel, flash_mha_reference
from dxmi_tpu_torch.ops.groupnorm import group_norm_silu_reference
from dxmi_tpu_torch.ops.attn_block import (GROUPS, attn_block_bb_reference,
                                           attn_block_int8_plain,
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


# Faults of a wgmma GEMM fed by TMA (K2 bf16's and K5's), on the
# A operand of the qkv product (h) or of the proj product (the attention
# output a), or on the q/k scale: one 64-wide k-block dropped, the first two
# 16-byte chunks of every A row swapped (a wrong swizzle), the scale missing
# on the q and k columns of head 0
GEMM_FAULTS = ("kdrop_qkv", "kdrop_proj", "swizzle", "headscale")


def _gemm_a(t, fault, product, chunk):
    """The A operand ``t`` (..., K) of ``product`` ("qkv" or "proj") as a
    faulty GEMM reads it: k in [64, 128) zeroed (kdrop_<product>), or the
    first two chunks of ``chunk`` elements (16 bytes) of each row swapped
    (swizzle, the qkv product)."""
    if fault == f"kdrop_{product}":
        t = t.clone()
        t[..., 64:128] = 0
    if fault == "swizzle" and product == "qkv":
        t = torch.cat([t[..., chunk:2 * chunk], t[..., :chunk],
                       t[..., 2 * chunk:]], dim=-1)
    return t


def _kblock_mm(a, b):
    """a @ b as the wgmma GEMMs sum it: each 64-wide block of k in float64,
    rounded to fp32 and added in fp32 in order (another order than the plain
    version's)."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 64):
        acc = acc + (a[..., k0:k0 + 64].double()
                     @ b[k0:k0 + 64].double()).float()
    return acc


def _attn_replica(x, gs, gb, wq, bq, wp, bp, nh, fault=None, eps=1e-5,
                  order="float64"):
    """The bf16 block with its sums in float64 (another order than the
    plain version's fp32; or, order="kblocks", the GEMMs' sums over 64-wide
    k-blocks), rounding where the kernel rounds."""
    B, S, C = x.shape
    d = C // nh
    mm = ((lambda a, b: a.double() @ b.double()) if order == "float64"
          else _kblock_mm)
    xf = x.double()
    g = xf.reshape(B, S, GROUPS, C // GROUPS)
    mean = g.mean(dim=(1, 3))
    rstd = torch.rsqrt((g - mean[:, None, :, None]).square().mean(dim=(1, 3))
                       + eps)
    s_c = gs.double() * rstd.repeat_interleave(C // GROUPS, 1)
    t_c = gb.double() - mean.repeat_interleave(C // GROUPS, 1) * s_c
    h = _gemm_a((xf * s_c[:, None] + t_c[:, None]).to(BF16), fault, "qkv", 8)
    qkv = (mm(h, wq).to(BF16) + bq).reshape(B, S, 3, nh, d)
    sc = 1.0 / math.sqrt(math.sqrt(d)) * (0.97 if fault == "scale" else 1.0)
    sc = torch.full((nh, 1), sc, dtype=BF16)
    if fault == "headscale":
        sc[0] = 1.0
    q, k, v = qkv[:, :, 0] * sc, qkv[:, :, 1] * sc, qkv[:, :, 2]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double())
    if fault == "drop":
        logits[..., 64:128] = -math.inf
    if fault == "uniform":
        logits = torch.zeros_like(logits)
    w = torch.softmax(logits, dim=-1).to(BF16)
    a = torch.einsum("bhqk,bkhd->bqhd", w.double(), v.double()).to(BF16)
    a = _gemm_a(a.reshape(B, S, C), fault, "proj", 8)
    return x + (mm(a, wp).to(BF16) + bp)


ATTN_SHAPES = [(1024, 384, 6), (256, 576, 9), (64, 768, 12)]


@pytest.mark.parametrize("S,C,nh", ATTN_SHAPES)
def test_attn_bf16_check_passes_another_order(S, C, nh):
    a = _attn_inputs(S, C, seed=S)
    rel, _, share = attn_bf16_check(_attn_replica(*a, nh),
                                    attn_block_reference(*a, num_heads=nh),
                                    a[0], "replica")
    assert rel < 1e-3 and share < 0.5, (rel, share)


@pytest.mark.parametrize("S,C,nh", ATTN_SHAPES)
def test_attn_bf16_check_passes_kblock_order(S, C, nh):
    """The wgmma GEMMs' order of sums (64-wide k-blocks in fp32) passes."""
    a = _attn_inputs(S, C, seed=S)
    rel, _, share = attn_bf16_check(_attn_replica(*a, nh, order="kblocks"),
                                    attn_block_reference(*a, num_heads=nh),
                                    a[0], "replica")
    assert rel < 1e-3 and share < 0.5, (rel, share)


# (a map of 64 keys is one tile: it has none to drop)
@pytest.mark.parametrize("S,C,nh,fault", [
    (S, C, nh, fault) for S, C, nh in ATTN_SHAPES
    for fault in ("drop", "scale", "uniform") + GEMM_FAULTS
    if S > 64 or fault != "drop"])
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
    return _flash_replica_fwd(q, k, v, sm_scale, fault)[0]


def _flash_replica_fwd(q, k, v, sm_scale, fault=None, tile=128):
    """``_flash_replica`` with its logsumexp m + log(l), (B, nh, S), over
    key tiles of ``tile`` (the wgmma kernel's 128 at S % 128 == 0). Faults:
    64 keys or one whole tile dropped, sm_scale 1% off, one consumer
    warpgroup's 64 query rows left out (rows 64-127), p normalised by the
    running sum before p v instead of once at the end."""
    B, S, nh, d = q.shape
    sm = sm_scale * (0.99 if fault == "scale" else 1.0)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm
    if fault == "drop":
        s[..., 64:128] = -math.inf
    if fault == "drop_tile":
        s[..., tile:2 * tile] = -math.inf
    vt = v.float().permute(0, 2, 1, 3)
    m = torch.full(s.shape[:-1], -math.inf)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(B, nh, S, d)
    for t in range(0, S, tile):
        st = s[..., t:t + tile]
        m_new = torch.maximum(m, st.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        l = l * alpha + p.sum(-1)
        if fault == "norm_early":
            p = p / l[..., None]
        pv = p.to(BF16).float() @ vt[:, :, t:t + tile]
        acc = acc * alpha[..., None] + pv
        m = m_new
    o = acc if fault == "norm_early" else acc / l[..., None]
    if fault == "wg_rows":
        o[:, :, 64:128] = 0
    return o.to(BF16).permute(0, 2, 1, 3), m + torch.log(l)


@pytest.mark.parametrize("fault", [None, "drop", "scale", "drop_tile",
                                   "wg_rows", "norm_early"])
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
    tile, and GEMM_FAULTS on the int8 operands (16-byte chunks of 16
    values)."""
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

    h = _gemm_a(quant(x.float() * s_c[:, None] + t_c[:, None], mats.isa_q),
                fault, "qkv", 16)
    acc = (h @ mats.wq.double().t()).to(torch.int32).float()
    qkv = (acc * mats.swq + bq).to(dt).reshape(B, S, 3, nh, d)
    sc = torch.full((nh, 1), 1.0 / math.sqrt(math.sqrt(d)), dtype=dt)
    if fault == "headscale":
        sc[0] = 1.0
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
    acc = (_gemm_a(quant(a.reshape(B, S, C).float(), mats.isa_p), fault,
                   "proj", 16)
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


@pytest.mark.parametrize("S,C,nh,fault", [
    (S, C, nh, fault) for S, C, nh in ATTN_SHAPES for fault in GEMM_FAULTS])
def test_attn_i8_check_fails_gemm_fault(S, C, nh, fault):
    """K5's gate (bf16, the ImageNet64 maps) refuses the faults of a wgmma
    GEMM fed by TMA; its int8 sums are exact in any order of k."""
    a = _i8_inputs(S, C, nh, BF16, seed=S + C)
    with pytest.raises(AssertionError, match="over the limit"):
        attn_i8_check(_i8_replica(*a, nh, fault),
                      attn_block_int8_plain(*a, num_heads=nh), a[0], a[3],
                      "replica")


# ---- the backward kernels: chip_smoke.flash_bwd_check (K4-dkv, K4-dq) and
# chip_smoke.attn_bwd_check (K6) -------------------------------------------


def _kstep_dropped(t):
    """t (..., d) with the head dim's second 16-wide k-step (columns 16-31)
    zeroed: a tensor-core product that skipped one m16n8k16 step."""
    t = t.clone()
    t[..., 16:32] = 0
    return t


def _key_step_dropped(ds, fault):
    """ds (..., keys) as the dq product takes it: with fault "dq_kstep" the
    second 16-key k-step of dq += ds k (keys 16-31) zeroed, a query-
    stationary kernel that skipped one m16n8k16 step."""
    if fault != "dq_kstep":
        return ds
    ds = ds.clone()
    ds[..., 16:32] = 0
    return ds


def _flash_bwd_replica(qkv, o, lse, do, sm, fault=None):
    """K4's backward with float64 sums (another order than the plain
    version's fp32), rounding p and ds to bf16 where the kernels do.
    Faults: dk and dv swapped, a dropped 64-key tile, di left out; and those
    a fragment-level kernel can make: one warp's 16 keys of dk and dv left
    out, one 16-wide k-step of the head dim dropped from s and dp, p not
    normalised by lse (exp(s - rowmax)), di taken from the bf16-rounded p
    (rowsum(bf16(p) dp)); and those of the query-stationary dq kernel: one
    warp's 16 query rows of dq left out, one 16-key k-step of dq += ds k
    dropped, ds taken from the bf16-rounded p."""
    q, k, v = (t.double() for t in qkv.unbind(2))
    dof = do.double()
    di = (o.double() * dof).sum(-1).permute(0, 2, 1)
    if fault == "no_di":
        di = torch.zeros_like(di)
    qs, dos = (_kstep_dropped(q), _kstep_dropped(dof)) if fault == "kstep" \
        else (q, dof)
    logits = torch.einsum("bqhd,bkhd->bhqk", qs, k) * sm
    if fault == "unnormalised":
        p = torch.exp(logits - logits.amax(-1, keepdim=True))
    else:
        p = torch.exp(logits - lse.double()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dos, v)
    if fault == "di_rounded":
        di = (p.to(BF16).double() * dp).sum(-1)
    pb = p.to(BF16).double()
    ds = ((dp - di[..., None]) * (pb if fault == "ds_rounded_p" else p)
          * sm).to(BF16).double()
    if fault == "drop":
        pb[..., 64:128] = 0
        ds[..., 64:128] = 0
    dv = torch.einsum("bhqk,bqhd->bkhd", pb, dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    dq = torch.einsum("bhqk,bkhd->bqhd", _key_step_dropped(ds, fault), k)
    if fault == "swap":
        dk, dv = dv, dk
    if fault == "warp_rows":  # the second warp of the first key block
        dk[:, 16:32] = 0
        dv[:, 16:32] = 0
    if fault == "dq_warp_rows":  # the second warp of the first query block
        dq[:, 16:32] = 0
    return torch.stack([dq, dk, dv], dim=2).to(BF16)


def _flash_bwd_case(seed, S=512, nh=2, d=64):
    from dxmi_tpu_torch.ops.attention import flash_mha_fwd

    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(1, S, 3, nh, d, generator=g).to(BF16)
    o, lse = flash_mha_fwd(qkv, d ** -0.5)
    return qkv, o, lse, torch.randn(1, S, nh, d, generator=g).to(BF16), \
        d ** -0.5


@pytest.mark.parametrize("fault", [None, "swap", "drop", "no_di",
                                   "warp_rows", "kstep", "unnormalised",
                                   "dq_warp_rows", "dq_kstep",
                                   "ds_rounded_p"])
def test_flash_bwd_check(fault):
    """The float64-order replica passes every gradient's gate; with dk and
    dv swapped, a dropped 64-key tile, di left out, one warp's 16 keys of dk
    and dv left out, a 16-wide k-step of the head dim dropped or p not
    normalised by lse, some gradient fails."""
    from chip_smoke import flash_bwd_check
    from dxmi_tpu_torch.ops.attention import flash_mha_reference_bwd

    qkv, o, lse, do, sm = _flash_bwd_case(11)
    ref = flash_mha_reference_bwd(qkv, o, lse, do, sm)
    got = _flash_bwd_replica(qkv, o, lse, do, sm, fault)

    def check():
        for i in range(3):
            flash_bwd_check(got[:, :, i], ref[:, :, i], f"grad {i}")

    if fault is None:
        check()
    else:
        with pytest.raises(AssertionError):
            check()


@pytest.mark.parametrize("fault", [None, "log2", "ln_log2", "row"])
def test_flash_lse_check(fault):
    """K4's logsumexp as the kernel forms it passes its gate; off by log 2,
    in log2 units, or another row's (the kernel's second row of eight
    written to the wrong place) it fails."""
    from chip_smoke import flash_lse_check
    from dxmi_tpu_torch.ops.attention import flash_mha_reference_fwd

    qkv, _, _, _, sm = _flash_bwd_case(11)
    _, lse = _flash_replica_fwd(*qkv.unbind(2), sm)
    ref = flash_mha_reference_fwd(*qkv.unbind(2), sm)[1]
    if fault == "log2":
        lse = lse + math.log(2)
    elif fault == "ln_log2":
        lse = lse / math.log(2)
    elif fault == "row":
        lse = lse.roll(8, dims=-1)
    if fault is None:
        assert flash_lse_check(lse, ref, "replica") < 1e-5
    else:
        with pytest.raises(AssertionError, match="logsumexp"):
            flash_lse_check(lse, ref, "replica")


@pytest.mark.parametrize("fault", [None, "log2"])
def test_flash_bwd_chain_check(fault):
    """The chain, K4's forward and backward (replicas) against the plain
    forward and backward, passes the chain's gate; with the logsumexp off
    by log 2 it fails, though the backward's own gate, fed the same wrong
    logsumexp on both sides, passes."""
    from chip_smoke import FLASH_CHAIN_MEAN_REL, flash_bwd_check
    from dxmi_tpu_torch.ops.attention import (flash_mha_reference_bwd,
                                              flash_mha_reference_fwd)

    g = torch.Generator().manual_seed(3)
    qkv = torch.randn(2, 1024, 3, 6, 64, generator=g).to(BF16)
    do = torch.randn(2, 1024, 6, 64, generator=g).to(BF16)
    sm = 64 ** -0.5
    o, lse = _flash_replica_fwd(*qkv.unbind(2), sm)
    if fault == "log2":
        lse = lse + math.log(2)
    got = _flash_bwd_replica(qkv, o, lse, do, sm)
    chain = flash_mha_reference_bwd(qkv, *flash_mha_reference_fwd(
        *qkv.unbind(2), sm), do, sm)
    same = flash_mha_reference_bwd(qkv, o, lse, do, sm)
    for i in range(3):
        flash_bwd_check(got[:, :, i], same[:, :, i], f"grad {i}")
    rels = []
    for i in range(3):
        try:
            rels.append(flash_bwd_check(
                got[:, :, i], chain[:, :, i], f"grad {i} chained",
                mean_rel=FLASH_CHAIN_MEAN_REL, elementwise=False)[0])
        except AssertionError:
            assert fault is not None
            return
    print(rels)
    assert fault is None


def _attn_bwd_replica(x, ct, gs, gb, wq, bq, wp, nh, fault=None, eps=1e-5):
    """K6 as the kernel computes it: two-pass GroupNorm statistics (the
    plain version's are one-pass), float64 sums, rounding to the element
    type where the kernel rounds."""
    dt = x.dtype
    B, S, C = x.shape
    d, cg = C // nh, C // GROUPS
    xf, ctf = x.double(), ct.double()
    g = xf.reshape(B, S, GROUPS, cg)
    mean = g.mean(dim=(1, 3))
    inv = torch.rsqrt((g - mean[:, None, :, None]).square().mean(dim=(1, 3))
                      + eps)
    mean_c = mean.repeat_interleave(cg, 1)[:, None]
    inv_c = inv.repeat_interleave(cg, 1)[:, None]
    hp = (xf - mean_c) * inv_c
    h = (hp * gs.double() + gb.double()).to(dt)
    qkv = (h.double() @ wq.double()).to(dt) + bq.to(dt)
    da = (ctf @ wp.double().t()).to(dt).double()
    scale = torch.tensor(1.0 / math.sqrt(math.sqrt(d)), dtype=dt)
    sf = float(torch.tensor(1.0 / math.sqrt(math.sqrt(d))))
    qkv = qkv.reshape(B, S, 3, nh, d)
    qs, ks, vh = ((qkv[:, :, 0] * scale).double(),
                  (qkv[:, :, 1] * scale).double(), qkv[:, :, 2].double())
    dah = da.reshape(B, S, nh, d)
    qk, dak = (_kstep_dropped(qs), _kstep_dropped(dah)) if fault == "kstep" \
        else (qs, dah)
    lg = torch.einsum("bqhd,bkhd->bhqk", qk, ks)
    if fault == "unnormalised":
        w = torch.exp(lg - lg.amax(-1, keepdim=True))
    else:
        w = torch.softmax(lg, dim=-1)
    if fault == "drop":
        w[..., 64:128] = 0
    wb = w.to(dt).double()
    a = torch.einsum("bhqk,bkhd->bqhd", wb, vh).to(dt).double()
    dv = torch.einsum("bhqk,bqhd->bkhd", wb, dah)
    dwt = torch.einsum("bqhd,bkhd->bhqk", dak, vh)
    di = ((wb if fault == "di_rounded" else w) * dwt).sum(-1, keepdim=True)
    dlg = ((wb if fault == "ds_rounded_p" else w) * (dwt - di)).to(dt).double()
    dq = torch.einsum("bhqk,bkhd->bqhd", _key_step_dropped(dlg, fault),
                      ks) * sf
    dk = torch.einsum("bhqk,bqhd->bkhd", dlg, qs) * sf
    if fault == "warp_rows":  # the second warp of the first key block
        dk[:, 16:32] = 0
        dv[:, 16:32] = 0
    if fault == "dq_warp_rows":  # the second warp of the first query block
        dq[:, 16:32] = 0
    gq = torch.stack([dq, dk, dv], dim=2).reshape(B, S, 3 * C)
    gqb = gq.to(dt).double()
    dh = gqb @ wq.double().t()
    dhp = dh * gs.double()
    g1 = dhp.reshape(B, S, GROUPS, cg).mean(dim=(1, 3))
    g2 = (dhp * hp).reshape(B, S, GROUPS, cg).mean(dim=(1, 3))
    g1c = g1.repeat_interleave(cg, 1)[:, None]
    g2c = g2.repeat_interleave(cg, 1)[:, None]
    if fault == "no_gn_term":
        g2c = torch.zeros_like(g2c)
    if fault == "no_gn_mean":
        g1c = torch.zeros_like(g1c)
    dx = ctf + inv_c * (dhp - g1c - hp * g2c)
    dgs, dgb = (dh * hp).sum((0, 1)), dh.sum((0, 1))
    if fault == "swap_gs_gb":
        dgs, dgb = dgb, dgs
    out = (dx.to(dt), dgs, dgb,
           torch.einsum("bsc,bsj->cj", h.double(), gqb), gq.sum((0, 1)),
           torch.einsum("bsc,bsj->cj", a.reshape(B, S, C), ctf),
           ctf.sum((0, 1)))
    return (out[0],) + tuple(t.float() for t in out[1:])


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("fault", [None, "swap_gs_gb", "no_gn_term",
                                   "no_gn_mean", "drop", "warp_rows",
                                   "kstep", "unnormalised", "dq_warp_rows",
                                   "dq_kstep"])
def test_attn_bwd_check(dtype, fault):
    """The kernel-order replica passes K6's gate in bf16 and fp32; with dgs
    and dgb swapped, either term of the GroupNorm backward missing (hp
    mean(dhp hp), mean(dhp)), a dropped 64-key tile, one warp's 16 keys of
    dk and dv left out, a 16-wide k-step of the head dim dropped from the
    logits and da v^T, or w not normalised (exp(s - rowmax)), it fails."""
    from chip_smoke import attn_bwd_check
    from dxmi_tpu_torch.ops.attn_block import attn_block_bwd_reference

    x, gs, gb, wq, bq, wp, _ = _attn_inputs(256, 128, 12)
    x, wq, bq, wp = (t.to(dtype) for t in (x, wq, bq, wp))
    g = torch.Generator().manual_seed(13)
    ct = (torch.randn(x.shape, generator=g) + 0.5).to(dtype)
    refs = attn_block_bwd_reference(x, ct, gs, gb, wq, bq, wp, 2)
    outs = _attn_bwd_replica(x, ct, gs, gb, wq, bq, wp, 2, fault)
    if fault is None:
        attn_bwd_check(outs, refs, dtype, "replica")
    else:
        with pytest.raises(AssertionError):
            attn_bwd_check(outs, refs, dtype, "replica")


@pytest.mark.parametrize("fault", [None, "dropped_sample", "sample_twice"])
def test_k6_fp32_gate_sees_partial_faults(fault):
    """K6 fp32's one-launch route sums per-sample partials of the parameter
    cotangents in a second launch. The replica built that way (each sample's
    cotangents alone, then summed in sample order) passes the fp32 gate at
    E5's map (S = 64, C = 64, nh 2, batch 8); with one sample's share of
    dW_qkv dropped, or every partial summed with one sample twice, it
    fails."""
    from chip_smoke import attn_bwd_check
    from dxmi_tpu_torch.ops.attn_block import attn_block_bwd_reference

    B, S, C, nh = 8, 64, 64, 2
    g = torch.Generator().manual_seed(21)
    x = torch.randn(B, S, C, generator=g) * 2 + 0.5
    ct = torch.randn(B, S, C, generator=g) + 0.5
    _, gs, gb, wq, bq, wp, _ = (t.float() for t in _attn_inputs(S, C, 22))
    refs = attn_block_bwd_reference(x, ct, gs, gb, wq, bq, wp, nh)
    parts = [_attn_bwd_replica(x[b:b + 1], ct[b:b + 1], gs, gb, wq, bq, wp,
                               nh) for b in range(B)]
    order = list(range(B)) + ([3] if fault == "sample_twice" else [])
    sums = []
    for i in range(1, 7):
        acc = torch.zeros_like(parts[0][i])
        for b in order:
            if not (fault == "dropped_sample" and i == 3 and b == 5):
                acc = acc + parts[b][i]
        sums.append(acc)
    outs = (torch.cat([p[0] for p in parts]), *sums)
    if fault is None:
        attn_bwd_check(outs, refs, torch.float32, "replica")
    else:
        with pytest.raises(AssertionError):
            attn_bwd_check(outs, refs, torch.float32, "replica")


def _mean_rels(outs, refs):
    return [((a.float() - b.float()).abs().mean()
             / b.float().abs().mean()).item() for a, b in zip(outs, refs)]


@pytest.mark.parametrize("kernel", ["flash", "k6_bf16"])
def test_bwd_checks_blind_to_di_from_rounded_w(kernel):
    """A limit of the gates, measured: di = rowsum(bf16(w) dp) in place of
    the fp32 w moves dq and dk by 5.0e-4 and 5.4e-4 of their mean in K4's
    backward (the replica's own errors: 1e-6) and K6's cotangents by up to
    7.0e-4 (about twice the replica's own), yet stays inside
    FLASH_BWD_MEAN_REL (2^-10) and ATTN_BWD_BF16_MEAN_REL (5e-3), which
    allow for bf16 rounding flips: the card's gates cannot refuse this
    fault. The kernels take di from the fp32 w (K6's statistics pass) or
    from o (K4-dkv's di launch)."""
    from chip_smoke import (ATTN_BWD_BF16_MEAN_REL, FLASH_BWD_MEAN_REL,
                            attn_bwd_check, flash_bwd_check)
    from dxmi_tpu_torch.ops.attention import flash_mha_reference_bwd
    from dxmi_tpu_torch.ops.attn_block import attn_block_bwd_reference

    if kernel == "flash":
        qkv, o, lse, do, sm = _flash_bwd_case(11)
        ref = flash_mha_reference_bwd(qkv, o, lse, do, sm).unbind(2)
        good, bad = (_flash_bwd_replica(qkv, o, lse, do, sm, f).unbind(2)
                     for f in (None, "di_rounded"))
        for i in range(3):
            flash_bwd_check(bad[i], ref[i], f"grad {i}")
        limit, moved = FLASH_BWD_MEAN_REL, (0, 1)  # dq, dk
    else:
        x, gs, gb, wq, bq, wp, _ = _attn_inputs(256, 128, 12)
        x, wq, bq, wp = (t.to(BF16) for t in (x, wq, bq, wp))
        g = torch.Generator().manual_seed(13)
        ct = (torch.randn(x.shape, generator=g) + 0.5).to(BF16)
        args = (x, ct, gs, gb, wq, bq, wp, 2)
        ref = attn_block_bwd_reference(*args)
        good, bad = (_attn_bwd_replica(*args, f) for f in (None, "di_rounded"))
        attn_bwd_check(bad, ref, BF16, "replica")
        limit, moved = ATTN_BWD_BF16_MEAN_REL, (0, 1, 3)  # dx, dgs, dw_qkv
    rel_good, rel_bad = _mean_rels(good, ref), _mean_rels(bad, ref)
    print(kernel, rel_good, rel_bad)
    assert max(rel_bad) < limit
    assert all(rel_bad[i] > 1.5 * rel_good[i] for i in moved)


def test_k6_check_blind_to_ds_from_rounded_w():
    """A limit of K6's gate, measured: ds = bf16(w) (dp - di) in place of
    the fp32 w in K6's dq (and dk) products moves dx by 2.7e-4 and the
    parameter cotangents by up to 1.3e-3 of their mean (3.8-4.6 times the
    replica's own errors), yet stays inside ATTN_BWD_BF16_DX_MEAN_REL (1e-3)
    and ATTN_BWD_BF16_MEAN_REL (5e-3), which allow for rounding flips of the
    recomputed forward. K4's backward gate refuses the same fault
    (test_flash_bwd_check, "ds_rounded_p": dq and dk move by 2.7e-3, above
    2^-10), and K6's dq pass is K4-dq's kernel, so the card sees it there.
    The kernels take ds from the accumulator's unrounded p."""
    from chip_smoke import (ATTN_BWD_BF16_DX_MEAN_REL, ATTN_BWD_BF16_MEAN_REL,
                            attn_bwd_check)
    from dxmi_tpu_torch.ops.attn_block import attn_block_bwd_reference

    x, gs, gb, wq, bq, wp, _ = _attn_inputs(256, 128, 12)
    x, wq, bq, wp = (t.to(BF16) for t in (x, wq, bq, wp))
    g = torch.Generator().manual_seed(13)
    ct = (torch.randn(x.shape, generator=g) + 0.5).to(BF16)
    args = (x, ct, gs, gb, wq, bq, wp, 2)
    ref = attn_block_bwd_reference(*args)
    good, bad = (_attn_bwd_replica(*args, f) for f in (None, "ds_rounded_p"))
    attn_bwd_check(bad, ref, BF16, "replica")
    rel_good, rel_bad = _mean_rels(good, ref), _mean_rels(bad, ref)
    print(rel_good, rel_bad)
    assert rel_bad[0] < ATTN_BWD_BF16_DX_MEAN_REL
    assert max(rel_bad[1:]) < ATTN_BWD_BF16_MEAN_REL
    assert all(rel_bad[i] > 3 * rel_good[i] for i in (0, 1, 2, 3, 4))


# ---- the E3 wiring gates: chip_smoke.wiring_check ------------------------

# configs/imagenet64/T10.yaml at a shrunken width: a 32x32 map (S = 1024,
# so the flash path runs there) and attention at every map, as E3 has it
WIRING_ARGS = [
    "--diffusion.image_size", "32", "--diffusion.num_channels", "32",
    "--diffusion.num_res_blocks", "1", "--diffusion.attention_resolutions",
    "32,16,8", "--diffusion.channel_mult", "1,2,2",
    "--diffusion.num_head_channels", "16", "--diffusion.num_classes", "4",
    "--sampler.sample_shape", "[3,32,32]", "--sampler.num_classes", "4",
    "--value.net.nh", "16"]


def _swap(i, j):
    def fault(grads):
        grads = list(grads)
        grads[i], grads[j] = grads[j], grads[i]
        return tuple(grads)
    return fault


def _drop(i):
    def fault(grads):
        grads = list(grads)
        grads[i] = torch.zeros_like(grads[i])
        return tuple(grads)
    return fault


# fault -> (autograd Function, how its backward's outputs are miswired)
WIRING_FAULTS = {
    "swap_dk_dv": ("FlashAttention", _swap(1, 2)),
    "swap_dgs_dgb": ("FusedAttnBlockTrain", _swap(1, 2)),
    "drop_db_proj": ("FusedAttnBlockTrain", _drop(6)),
}


@pytest.mark.parametrize("fault", [None, *WIRING_FAULTS])
def test_wiring_check(monkeypatch, fault):
    """The first sampler minibatch's gradient by einsum, flash and
    fused_train (the plain versions here) at a shrunken width in fp32 passes
    the E3 wiring gates; with a cotangent of FlashAttention or
    FusedAttnBlockTrain wired to the wrong input or dropped, the worst
    attention group moves by its whole norm and the gate fails (the whole
    gradient, diluted, can stay under its own limit)."""
    import chip_smoke
    from dxmi_tpu_torch.config import (merge, parse_nested_args,
                                       parse_unknown_args)
    from dxmi_tpu_torch.ops import attention, attn_block

    if fault is not None:
        name, miswire = WIRING_FAULTS[fault]
        fn = getattr(attention, name, None) or getattr(attn_block, name)
        backward = fn.backward
        monkeypatch.setattr(fn, "backward", staticmethod(
            lambda ctx, ct: miswire(backward(ctx, ct))))
    cfg = merge(chip_smoke.imagenet64_train_config(), parse_nested_args(
        parse_unknown_args(WIRING_ARGS + ["--diffusion.use_fp16", "False"])))
    torch.manual_seed(0)  # the value net's initialisation
    grads, groups = chip_smoke.e3_grads(cfg, 8, 8, device="cpu")
    if fault is None:
        lines = chip_smoke.wiring_check(grads, groups)
        print("\n".join(lines))
        return
    with pytest.raises(AssertionError, match="E3 wiring"):
        chip_smoke.wiring_check(grads, groups)
    readings = [chip_smoke.wiring_readings(grads[a], grads[b], groups)
                for a, b in chip_smoke.E3_PAIRS]
    whole = max(r[0] for r in readings)
    worst = max(readings, key=lambda r: r[1])
    print(fault, whole, worst)
    assert worst[1] >= 0.99, readings


# ---- K4's wrapper refusals (the TMA tensor maps' layout) -----------------

def _qkv_views(B=1, S=64, nh=2, d=64, offset=0):
    buf = torch.zeros(B * S * 3 * nh * d + offset, dtype=BF16)
    qkv = buf[offset:].view(B, S, 3, nh, d)
    return qkv.unbind(2)


@pytest.mark.parametrize("fault", ["misaligned", "row_stride", "S", "d",
                                   "strides_differ", "cpu"])
def test_flash_kernel_refuses(fault):
    """flash_fwd_kernel raises before building anything on operands the
    tensor maps cannot describe (bases off 16 bytes, row strides that are
    not multiples of 8 elements, S % 64, d past 128, q, k and v with
    different row strides), and on CPU tensors."""
    q, k, v = _qkv_views()
    if fault == "misaligned":  # one bf16 element off a 16-byte boundary
        q, k, v = _qkv_views(offset=1)
    elif fault == "row_stride":  # rows 3 nh d + 4 elements apart
        buf = torch.zeros(64, 3 * 2 * 64 + 4, dtype=BF16)
        q = buf[:, :128].view(1, 64, 2, 64)
        k = buf[:, 128:256].view(1, 64, 2, 64)
        v = buf[:, 256:384].view(1, 64, 2, 64)
    elif fault == "S":
        q, k, v = _qkv_views(S=96)
    elif fault == "d":
        q, k, v = _qkv_views(d=136)
    elif fault == "strides_differ":
        k = k.contiguous()
    with pytest.raises(ValueError):
        flash_fwd_kernel(q, k, v, 0.125)


# ---- K7's fp32 gate against the 3xTF32 products --------------------------

def _tf32(x):
    """x rounded to TF32 (10 mantissa bits; nearest, ties away: cvt.rna)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """x cut to TF32, as the tensor core reads an fp32 operand."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(
        torch.float32)


def _mm(a, b, mode):
    """a @ b as K7 forms it on the card: 3xTF32 (hi hi + hi lo + lo hi, the
    lo parts cut to TF32 by the tensor core) or, planted, one-pass TF32."""
    ah, bh = _tf32(a), _tf32(b)
    if mode == "tf32":
        return ah @ bh
    return (_tf32_trunc(a - ah) @ bh + ah @ _tf32_trunc(b - bh)) + ah @ bh


def _bb_replica(x, gs, gb, wq, bq, wp, bp, nh, mode, eps, kernel="K7"):
    """The fp32 block with its four products emulated in ``mode``: K7's
    one-pass statistics and x s + t, or K2's (bb 1) two-pass statistics
    from K1 and ((x - mean) rstd) gs + gb."""
    B, S, C = x.shape
    d, cg = C // nh, C // GROUPS
    g = x.reshape(B, S, GROUPS, cg)
    mean = g.mean(dim=(1, 3))
    if kernel == "K2":
        var = (g - mean[:, None, :, None]).square().mean(dim=(1, 3))
        rstd = (1.0 / torch.sqrt(var + eps)).repeat_interleave(cg, dim=1)
        mean = mean.repeat_interleave(cg, dim=1)
        h = (x - mean[:, None]) * rstd[:, None] * gs + gb
    else:
        rstd = torch.rsqrt((g * g).mean(dim=(1, 3)) - mean * mean + eps)
        s_c = gs * rstd.repeat_interleave(cg, dim=1)
        t_c = gb - mean.repeat_interleave(cg, dim=1) * s_c
        h = x * s_c[:, None] + t_c[:, None]
    qkv = (_mm(h.reshape(B * S, C), wq, mode) + bq).reshape(B, S, 3, nh, d)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    sc = d ** -0.25
    # the fp32 attention's online softmax: exp(s - max) unnormalised into
    # the AV product, divided by the row sums after it
    lg = _mm(q * sc, (k * sc).transpose(-1, -2), mode)
    w = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    a = _mm(w, v, mode) / w.sum(dim=-1, keepdim=True)
    a = a.permute(0, 2, 1, 3).reshape(B * S, C)
    return x + (_mm(a, wp, mode) + bp).reshape(B, S, C)


@pytest.mark.parametrize("kernel", ["K7", "K2"])
@pytest.mark.parametrize("mode", ["3xtf32", "tf32"])
def test_bb_fp32_gate_tells_3xtf32_from_tf32(mode, kernel):
    """TOL["attn_block_bb"] (K7, batch block 2, against its plain version)
    and TOL["attn_block"] (K2, bb 1, against attn_block_reference) at E4's
    C = 256 and d = 256 reduction depth (batch 2): the 3xTF32 products
    reach 0.07 of the limit in both, one-pass TF32 25 times it."""
    g = torch.Generator().manual_seed(0)

    def n(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=g) * scale + shift

    C = 256
    a = (n(2, 256, C, scale=2.0, shift=0.5), n(C, scale=0.1, shift=1.0),
         n(C, scale=0.1), n(C, 3 * C, scale=C ** -0.5), n(3 * C, scale=0.1),
         n(C, C, scale=C ** -0.5), n(C, scale=0.1))
    if kernel == "K7":
        name = "attn_block_bb"
        ref = attn_block_bb_reference(*a, num_heads=1, eps=1e-6, bb=2)
    else:
        name = "attn_block"
        ref = attn_block_reference(*a, num_heads=1, eps=1e-6)
    out = _bb_replica(*a, 1, mode, 1e-6, kernel)
    if mode == "3xtf32":
        assert max_err(out, ref, name) < 5e-6
    else:
        with pytest.raises(AssertionError, match="elements off"):
            max_err(out, ref, name)


# ---- K1's gates against its order of sums ---------------------------------
# csrc/groupnorm.cu: 256 threads a CTA; thread (rr, v) sums the v-th 16-byte
# vector of rows rr, rr + RP, ... (RP = 256 // vectors a slab row) of its
# CTA's HW / cs rows in order, per channel in fp32; the CTA adds its RP row
# lanes per channel in order, then the channels of each group; the cluster
# adds its cs CTAs' group sums in rank order. Two-pass: the sum of x, then
# of fmaf(x - mean, x - mean, .); bf16_onepass: x and x*x rounded to the
# element type. The apply: fmaf(x - mean, rstd * scale, bias) and SiLU in
# fp32, rounded once, or (bf16_onepass on bf16) every step in bf16.
K1_THREADS = 256
# (slabs, cs) plans the emulation takes: whole rows in a cluster of 2, and
# slabs of whole groups in clusters of 4 and 8
K1_PLANS = [(1, 2), (2, 4), (4, 8)]
K1_FORMS = [(torch.bfloat16, "fp32", "gn_silu_bf16"),
            (torch.bfloat16, "bf16_onepass", "gn_silu_bf16"),
            (torch.float32, "fp32", "gn_silu")]


def _k1_replica(x, scale, bias, G, eps, silu, stats, slabs, cs, fault=None):
    """K1 on the CPU in the kernel's order of sums (above), with ``fault``
    planted: 'dropped_cta' (the last CTA's partial sums left out of the
    cluster's), 'slab_shift' (each slab's statistics taken one group over),
    'one_pass' (fp32 E[x^2] - mean^2 where two-pass is due) or
    'square_unrounded' (the bf16 one-pass sums of x*x in fp32)."""
    B, HW, C = x.shape
    dt = x.dtype
    bf16 = dt == torch.bfloat16
    cg = C // G
    RP = K1_THREADS // (C // slabs // (16 // x.element_size()))
    R, n = HW // cs, float(HW * cg)
    steps = -(-R // RP)

    def rt(t):  # rounded to the element type
        return t.to(dt).float() if bf16 else t

    def lanes(t):  # (B, HW, C) -> (B, cs, steps, RP, C), zeros past row R
        t = t.reshape(B, cs, R, C)
        t = torch.cat([t, t.new_zeros(B, cs, steps * RP - R, C)], dim=2)
        return t.reshape(B, cs, steps, RP, C)

    def row_sums(terms):  # each thread's rows in order
        p = torch.zeros(B, cs, RP, C)
        for j in range(steps):
            p = p + terms[:, :, j]
        return p

    def group_sums(p):  # row lanes, then channels, then the cluster's CTAs
        c = torch.zeros(B, cs, C)
        for lane in range(RP):
            c = c + p[:, :, lane]
        c = c.reshape(B, cs, G, cg)
        g = torch.zeros(B, cs, G)
        for k in range(cg):
            g = g + c[..., k]
        t = torch.zeros(B, G)
        for k in range(cs - (fault == "dropped_cta")):
            t = t + g[:, k]
        return t

    xs = x.float()
    if fault == "slab_shift":
        xs = xs.roll(-cg, dims=-1)
    L = lanes(xs)
    if stats == "fp32" and fault != "one_pass":
        mean = group_sums(row_sums(L)) / n
        d = (L - mean.repeat_interleave(cg, 1)[:, None, None, None]) * lanes(
            torch.ones(B, HW, C))
        p = torch.zeros(B, cs, RP, C)
        for j in range(steps):  # fmaf: one rounding (exact in float64)
            p = (p.double() + d[:, :, j].double() ** 2).float()
        rstd = 1.0 / torch.sqrt(group_sums(p) / n + eps)
    else:
        sq = L * L if fault == "square_unrounded" else rt(L * L)
        m = group_sums(row_sums(L)) / n
        # s2 / n - m * m contracted into one fma
        var = torch.clamp((group_sums(row_sums(sq)) / n).double()
                          - m.double() ** 2, min=0).float()
        if stats == "fp32":
            mean, rstd = m, 1.0 / torch.sqrt(var + eps)
        else:
            mean = rt(m)
            rstd = rt(1.0 / torch.sqrt(rt(rt(var) + rt(torch.tensor(eps)))))
    m_c = mean.repeat_interleave(cg, 1)[:, None]
    r_c = rstd.repeat_interleave(cg, 1)[:, None]
    if bf16 and stats == "bf16_onepass":
        b16 = torch.bfloat16
        u = ((x - m_c.to(b16)) * r_c.to(b16)) * scale.to(b16) + bias.to(b16)
        return u * torch.reciprocal(1 + torch.exp(-u)) if silu else u
    u = ((x.float() - m_c).double() * (r_c * scale).double()
         + bias.double()).float().double()
    if silu:
        u = u / (1 + torch.exp(-u))
    return u.float().to(dt)


def _k1_inputs(dtype, C, HW=256):
    """Two samples around 32 (std 1, per-channel offsets 0.5): a one-pass
    fp32 variance loses ~10 bits to cancellation there, and the bf16 one-pass
    variance reads the rounding of every x*x."""
    g = torch.Generator().manual_seed(5)
    x = (torch.randn(2, HW, C, generator=g) + 32
         + 0.5 * torch.randn(C, generator=g))
    return (x.to(dtype), 1 + 0.1 * torch.randn(C, generator=g),
            0.1 * torch.randn(C, generator=g))


@pytest.mark.parametrize("fault", [None, "dropped_cta", "slab_shift",
                                   "stats_fault"])
@pytest.mark.parametrize("plan", K1_PLANS)
@pytest.mark.parametrize("form", K1_FORMS, ids=["bf16", "bf16_onepass",
                                                "fp32"])
def test_k1_gate_against_its_order_of_sums(form, plan, fault):
    """chip_smoke's K1 gates (2e-5 + 2e-5 |plain| in fp32, 2e-2 + 2e-2
    |plain| in bf16) pass the kernel's order of sums (0.61 of the limit in
    fp32, bit-equal in bf16, on these inputs) and fail each planted fault
    (5.3 times the limit or more): a dropped CTA, a slab shifted by one
    group, and the statistics fault of the form, one-pass fp32 sums (fp32
    statistics) or unrounded squares (bf16_onepass)."""
    dtype, stats, name = form
    if fault == "stats_fault":
        fault = "one_pass" if stats == "fp32" else "square_unrounded"
    x, s, b = _k1_inputs(dtype, 384)
    ref = group_norm_silu_reference(x, s, b, 32, 1e-5, True, stats).float()
    out = _k1_replica(x, s, b, 32, 1e-5, True, stats, *plan, fault).float()
    atol, rtol = TOL[name]
    share = ((out - ref).abs() / (atol + rtol * ref.abs())).max().item()
    if fault is None:
        assert share < 0.7
        max_err(out, ref, name)
    else:
        assert share > 2
        with pytest.raises(AssertionError, match="elements off"):
            max_err(out, ref, name)


# ---- K3's gate: chip_smoke.conv_check ------------------------------------

# The four map sizes of CONV_SHAPES at batch 2 (4 at the 4x4 map, whose 36
# padded positions a sample would leave the second warpgroup of a 128-row
# tile only border rows at batch 2), each with the plan the card takes there
# at batch 100: (chunk channels, padded positions a tile, slices of the
# reduction).
K3_MAPS = [((2, 32, 128, 128), (64, 256, 1)), ((2, 16, 256, 256), (64, 128, 1)),
           ((2, 8, 256, 256), (64, 128, 1)), ((4, 4, 512, 256), (64, 128, 4))]
K3_FAULTS = ("kblock_dropped", "tap_shifted", "border_not_zeroed",
             "no_bias", "warpgroup_rows", "slice_dropped", "slice_twice",
             "group_stats")


def _k3_inputs(B, R, Cin, Cout, seed):
    """chip_smoke.conv_case's distributions on the CPU."""
    g = torch.Generator().manual_seed(seed)

    def n(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=g) * scale + shift

    return (n(B, R, R, Cin, scale=2.0, shift=0.5), n(Cin, scale=0.1, shift=1.0),
            n(Cin, scale=0.1), n(3, 3, Cin, Cout, scale=(9 * Cin) ** -0.5),
            n(Cout, scale=0.1))


def _k3_replica(x, gs, gb, kernel, bias, plan, fault=None, G=32, eps=1e-6):
    """K3 on the CPU in the card's order: GN statistics (float64, then fp32),
    GN + SiLU in fp32 rounded once to bf16 into the zero-padded window; for
    each slice of the chunks, each chunk, each tap and each 16-channel
    k-step of a wgmma, the k-step's products (float64, rounded to fp32)
    added in fp32; the slices' partials added in order, then the bias.
    ``fault`` plants one of K3_FAULTS: one tap's 64-channel k-block
    dropped; column-border outputs reading the neighbouring image row's
    pixel where the padding is due; the window's border rows holding GN +
    SiLU of x = 0 instead of zeros; the bias left out; the second consumer
    warpgroup's 64 rows of every tile left out; the last slice dropped or
    the first added twice; each group normalised with the next group's
    statistics."""
    B, H, W, Cin = x.shape
    Cout = kernel.shape[-1]
    chunk, rows, slices = plan
    xd = x.double().reshape(B, H * W, G, Cin // G)
    mean = xd.mean(dim=(1, 3))
    rstd = 1 / torch.sqrt((xd - mean[:, None, :, None]).square()
                          .mean(dim=(1, 3)) + eps)
    if fault == "group_stats":
        mean, rstd = mean.roll(-1, dims=1), rstd.roll(-1, dims=1)
    m_c = mean.float().repeat_interleave(Cin // G, 1)[:, None, None]
    r_c = rstd.float().repeat_interleave(Cin // G, 1)[:, None, None]

    def gn_silu(v):
        u = ((v - m_c) * r_c) * gs + gb
        return (u / (1 + torch.exp(-u))).to(BF16).float()

    hp = torch.nn.functional.pad(gn_silu(x), (0, 0, 1, 1, 1, 1))
    if fault == "border_not_zeroed":
        border = torch.ones(H + 2, W + 2, dtype=torch.bool)
        border[1:-1, 1:-1] = False
        hp[:, border] = gn_silu(torch.zeros_like(x))[:, :1, :1].reshape(
            B, 1, Cin)
    if fault == "tap_shifted":  # the rows wrap: no column padding
        hp[:, 1:-1, 0] = hp[:, :-2, -2]
        hp[:, 1:-1, -1] = hp[:, 2:, 1]
    w = kernel.to(BF16).double().reshape(9, Cin, Cout)
    n_chunks = -(-Cin // chunk)
    parts = []
    for z in range(slices):
        acc = torch.zeros(B, H, W, Cout)
        for c in range(z * n_chunks // slices, (z + 1) * n_chunks // slices):
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                for k0 in range(c * chunk, min((c + 1) * chunk, Cin), 16):
                    if fault == "kblock_dropped" and tap == 4 and \
                            k0 // 64 == 0:
                        continue
                    a = hp[:, dy:dy + H, dx:dx + W, k0:k0 + 16].double()
                    acc = acc + (a @ w[tap, k0:k0 + 16]).float()
        parts.append(acc)
    if fault == "slice_dropped":
        parts = parts[:-1]
    if fault == "slice_twice":
        parts = [parts[0]] + parts
    y = torch.zeros(B, H, W, Cout)
    for p in parts:
        y = y + p
    if fault != "no_bias":
        y = y + bias
    if fault == "warpgroup_rows":
        Wp = W + 2
        pos = (torch.arange(B)[:, None, None] * (H + 2) * Wp
               + torch.arange(H)[None, :, None] * Wp
               + torch.arange(W)[None, None, :])
        y[(pos % rows) // 64 == 1] = 0
    return y


@pytest.mark.parametrize("shape,plan", K3_MAPS)
def test_k3_gate_passes_its_order_of_sums(shape, plan):
    """chip_smoke.conv_check (5e-3 + 5e-3 |plain|) passes K3's arithmetic:
    the window rounded once to bf16, fp32 sums per wgmma k-step, tap and
    chunk, slices added in order, at each map size."""
    from chip_smoke import conv_check
    from dxmi_tpu_torch.ops.conv_fused import gn_silu_conv_reference

    a = _k3_inputs(*shape, seed=shape[1])
    ref = gn_silu_conv_reference(*a)
    out = _k3_replica(*a, plan)
    share = ((out - ref).abs() / (5e-3 + 5e-3 * ref.abs())).max().item()
    assert share < 0.5, share
    conv_check(out, ref, "replica")


@pytest.mark.parametrize("fault", K3_FAULTS)
@pytest.mark.parametrize("shape,plan", K3_MAPS)
def test_k3_gate_refuses_planted_fault(shape, plan, fault):
    """Each fault of K3_FAULTS at each map size moves some output 12.9 (the
    neighbouring group's statistics at 32x32) to 238 times its limit: no
    blind spot."""
    from chip_smoke import conv_check
    from dxmi_tpu_torch.ops.conv_fused import gn_silu_conv_reference

    a = _k3_inputs(*shape, seed=shape[1])
    out = _k3_replica(*a, plan, fault)
    with pytest.raises(AssertionError, match="elements off"):
        conv_check(out, gn_silu_conv_reference(*a), "replica")
