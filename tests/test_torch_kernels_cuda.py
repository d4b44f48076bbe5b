"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA device.
The file imports no JAX, so on a machine with the card (and no JAX) it runs
without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances are chip_smoke.TOL (stated and reasoned there); the bf16 attention
block is held by chip_smoke.attn_bf16_check (the JAX package's own bf16
criterion and an element-wise limit on the attention part), flash
attention by chip_smoke.flash_check (a per-row limit), the int8 attention
block by chip_smoke.attn_i8_check (a base limit, and one int8 level for the
few elements a rounding flip reached), the int8 conv exactly (its int32
sums are exact and its quantise and epilogue elementwise), and the backward
kernels by chip_smoke.flash_bwd_check (K4-dkv, K4-dq) and
chip_smoke.attn_bwd_check (K6); their autograd functions against autograd
through the plain forwards.
"""
import numpy as np
import pytest
import torch

from chip_smoke import (CONV_SHAPES, K6_PAST_SMALL, K6_SMALL_SHAPES, TOL,
                        attn_bf16_check, attn_i8_check,
                        calibrated_attn_scales, conv_bf16_check, flash_check,
                        flash_lse_check, gn_route_edges)
from dxmi_tpu_torch.ops import _lib
from dxmi_tpu_torch.ops.attention import (flash_fwd_kernel, flash_mha,
                                          flash_mha_reference,
                                          flash_mha_reference_fwd)
from dxmi_tpu_torch.ops import quant
from dxmi_tpu_torch.ops.attn_block import (attn_block, attn_block_bb,
                                           attn_block_bb_reference,
                                           attn_block_int8,
                                           attn_block_int8_plain,
                                           attn_block_reference,
                                           attn_core_reference,
                                           attn_core_wide, prep_int8_mats)
from dxmi_tpu_torch.ops.conv_fused import gn_silu_conv, gn_silu_conv_reference
from dxmi_tpu_torch.ops.groupnorm import (group_norm,
                                          group_norm_silu_reference, route)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _lib.reset_launches()
    return torch.device("cuda")


def _tensors(rs, device, *shapes_scales):
    """Normal tensors (shape, scale, shift) from a numpy RandomState."""
    return [torch.from_numpy((rs.randn(*shape) * scale + shift)
                             .astype(np.float32)).to(device)
            for shape, scale, shift in shapes_scales]


def _check(out, ref, name):
    atol, rtol = TOL[name]
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)
    assert _lib.LAUNCHES[name] == 1


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape", [(100, 1024, 128), (100, 16, 256),
                                   (8, 256, 32), (8, 64, 96), (4, 64, 384),
                                   (3, 7, 64)])
def test_group_norm(card, shape, silu):
    C = shape[-1]
    x, s, b = _tensors(np.random.RandomState(0), card, (shape, 2.0, 0.5),
                       ((C,), 0.1, 1.0), ((C,), 0.1, 0.0))
    _check(group_norm(x, s, b, 32, 1e-6, silu),
           group_norm_silu_reference(x, s, b, 32, 1e-6, silu), "gn_silu")


@pytest.mark.parametrize("B,R,Cin,Cout,W", [
    *((B, R, Cin, Cout, R) for B, R, Cin, Cout in CONV_SHAPES),
    *((B, R, Cin, Cout, R) for B in (128, 32)
      for R, Cin, Cout in ((32, 128, 128), (32, 384, 128), (32, 256, 128))),
    (8, 16, 32, 32, 16), (8, 8, 96, 64, 8), (8, 8, 192, 64, 8),
    (3, 5, 64, 40, 5), (2, 16, 64, 320, 16), (1, 40, 32, 64, 300),
    (1, 128, 64, 64, 128), (1, 512, 32, 32, 512)])
def test_gn_silu_conv(card, B, R, Cin, Cout, W):
    """K3 at every main-path shape of E (batch 100) and at E4's batches 128
    and 32 at 32x32, at small and ragged widths (Cin = 96 in 64-channel
    chunks, Cout = 40, 320), and at widths that take the 32- and 16-channel
    chunks of wide images; a replay bit-equal."""
    args = _tensors(np.random.RandomState(1), card, ((B, R, W, Cin), 2.0, 0.5),
                    ((Cin,), 0.1, 1.0), ((Cin,), 0.1, 0.0),
                    ((3, 3, Cin, Cout), (9 * Cin) ** -0.5, 0.0),
                    ((Cout,), 0.1, 0.0))
    out = gn_silu_conv(*args)
    _check(out, gn_silu_conv_reference(*args), "gn_silu_conv3x3")
    assert torch.equal(out, gn_silu_conv(*args))


@pytest.mark.parametrize("B,S,C,nh", [(100, 256, 256, 1), (128, 256, 256, 1),
                                      (32, 256, 256, 1), (8, 64, 64, 1),
                                      (2, 128, 128, 2), (2, 192, 96, 1)])
def test_attn_block(card, B, S, C, nh):
    """K2 fp32 (K1's two-pass statistics, then K7's tensor-core launches)
    against its plain version, at E's batch 100 and E4's 128 and 32 among
    others; a replay bit-equal."""
    args = _tensors(np.random.RandomState(2), card, ((B, S, C), 2.0, 0.5),
                    ((C,), 0.1, 1.0), ((C,), 0.1, 0.0),
                    ((C, 3 * C), C ** -0.5, 0.0), ((3 * C,), 0.1, 0.0),
                    ((C, C), C ** -0.5, 0.0), ((C,), 0.1, 0.0))
    out = attn_block(*args, num_heads=nh, eps=1e-6)
    _check(out, attn_block_reference(*args, num_heads=nh, eps=1e-6),
           "attn_block")
    assert torch.equal(out, attn_block(*args, num_heads=nh, eps=1e-6))


@pytest.mark.parametrize("B,S,C,nh,bb", [(128, 256, 256, 1, 2),
                                         (128, 256, 256, 1, 4),
                                         (32, 256, 256, 1, 2),
                                         (32, 256, 256, 1, 4),
                                         (8, 64, 64, 1, 2), (6, 128, 128, 2, 3),
                                         (4, 192, 96, 1, 2)])
def test_attn_block_bb(card, B, S, C, nh, bb):
    """K7 (fp32) against its plain version at K2's limit, a replay
    bit-equal, and attn_block routing the same batch block to it."""
    args = _tensors(np.random.RandomState(8), card, ((B, S, C), 2.0, 0.5),
                    ((C,), 0.1, 1.0), ((C,), 0.1, 0.0),
                    ((C, 3 * C), C ** -0.5, 0.0), ((3 * C,), 0.1, 0.0),
                    ((C, C), C ** -0.5, 0.0), ((C,), 0.1, 0.0))
    out = attn_block_bb(*args, num_heads=nh, eps=1e-6, bb=bb)
    ref = attn_block_bb_reference(*args, num_heads=nh, eps=1e-6, bb=bb)
    atol, rtol = TOL["attn_block_bb"]
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)
    assert torch.equal(out, attn_block_bb(*args, num_heads=nh, eps=1e-6,
                                          bb=bb))
    assert torch.equal(out, attn_block(*args, num_heads=nh, eps=1e-6,
                                       block_b=bb))
    assert _lib.LAUNCHES["attn_block_bb"] == 3 and not _lib.LAUNCHES[
        "attn_block"]


@pytest.mark.parametrize("B,S,C,nh,bb", [(100, 256, 576, 9, 2),
                                         (8, 1024, 96, 3, 2),
                                         (4, 256, 128, 1, 4),
                                         (128, 256, 256, 1, 4),
                                         (128, 256, 256, 1, 2),
                                         (64, 256, 256, 1, 4),
                                         (128, 256, 256, 2, 2),
                                         (128, 256, 256, 2, 4),
                                         (32, 256, 256, 2, 2),
                                         (32, 256, 256, 2, 4)])
def test_attn_block_bb_bf16(card, B, S, C, nh, bb):
    rs = np.random.RandomState(9)
    x = _bf16(rs, card, (B, S, C), 1.0, 0.0)
    gs, gb = _tensors(rs, card, ((C,), 0.1, 1.0), ((C,), 0.1, 0.0))
    w = [_bf16(rs, card, shape, scale, 0.0)
         for shape, scale in (((C, 3 * C), C ** -0.5), ((3 * C,), 0.02),
                              ((C, C), C ** -0.5), ((C,), 0.02))]
    out = attn_block_bb(x, gs, gb, *w, num_heads=nh, bb=bb)
    attn_bf16_check(out, attn_block_bb_reference(x, gs, gb, *w,
                                                 num_heads=nh, bb=bb),
                    x, "attn_block_bb_bf16")
    assert torch.equal(out, attn_block_bb(x, gs, gb, *w, num_heads=nh,
                                          bb=bb))
    assert _lib.LAUNCHES["attn_block_bb_bf16"] == 2


# K3 on bf16 x: the four CIFAR-10 map sizes at E-bf16's batch 100 (4x4:
# four slices summed before the one rounding), E4-levers' 64 and 128 at the
# 32x32 and 4x4 maps, and the small and ragged widths of test_gn_silu_conv
@pytest.mark.parametrize("B,R,Cin,Cout,W", [
    (100, 32, 128, 128, 32), (100, 16, 256, 256, 16), (100, 8, 256, 256, 8),
    (100, 4, 256, 256, 4), (100, 4, 512, 256, 4), (64, 32, 384, 128, 32),
    (128, 32, 128, 128, 32), (128, 4, 512, 256, 4), (8, 8, 96, 64, 8),
    (3, 5, 64, 40, 5), (1, 40, 32, 64, 300)])
def test_gn_silu_conv_bf16(card, B, R, Cin, Cout, W):
    """K3 on bf16 x against its plain version (chip_smoke.conv_bf16_check:
    the fp32 form's limit plus one bf16 ulp of y), bf16 out, a replay
    bit-equal."""
    x, *rest = _tensors(np.random.RandomState(11), card,
                        ((B, R, W, Cin), 2.0, 0.5), ((Cin,), 0.1, 1.0),
                        ((Cin,), 0.1, 0.0),
                        ((3, 3, Cin, Cout), (9 * Cin) ** -0.5, 0.0),
                        ((Cout,), 0.1, 0.0))
    x = x.bfloat16()
    out = gn_silu_conv(x, *rest)
    assert out.dtype == torch.bfloat16
    conv_bf16_check(out, gn_silu_conv_reference(x, *rest), "K3 bf16")
    assert torch.equal(out, gn_silu_conv(x, *rest))
    assert _lib.LAUNCHES["gn_silu_conv3x3_bf16"] == 2
    assert not _lib.LAUNCHES["gn_silu_conv3x3"]


def test_gn_silu_conv_bf16_autograd(card):
    """K3's gradient on bf16 x: the vjp of the fp32 reference at the widened
    x and an fp32 cotangent, x's gradient rounded to bf16; the same as
    autograd through the plain version on the widened x."""
    rs = np.random.RandomState(12)
    x, *rest = _tensors(rs, card, ((4, 8, 8, 64), 1.0, 0.0), ((64,), 0.1, 1.0),
                        ((64,), 0.1, 0.0), ((3, 3, 64, 32), 0.05, 0.0),
                        ((32,), 0.1, 0.0))
    ct = torch.randn(4, 8, 8, 32, device=card).bfloat16()
    got = [x.bfloat16().requires_grad_()] + [
        a.clone().requires_grad_() for a in rest]
    gn_silu_conv(*got).backward(ct)
    want = [x.bfloat16().float().requires_grad_()] + [
        a.clone().requires_grad_() for a in rest]
    gn_silu_conv_reference(*want, operand_dtype=torch.float32).backward(
        ct.float())
    assert got[0].grad.dtype == torch.bfloat16
    torch.testing.assert_close(got[0].grad, want[0].grad.bfloat16(), rtol=0,
                               atol=0)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g.grad, w.grad, rtol=0, atol=0)
    assert _lib.LAUNCHES["gn_silu_conv3x3_bf16"] == 1


@pytest.mark.parametrize("B,S,C", [(100, 256, 256), (128, 256, 256),
                                   (64, 256, 256), (2, 256, 192),
                                   (4, 64, 160)])
def test_attn_block_bf16_d256(card, B, S, C):
    """K2 bf16 at one head of d > 128 (the CIFAR-10 blocks' d = 256: K1's
    statistics, the wgmma GEMMs, the wide attention core) against its plain
    version, a replay bit-equal, counted as attn_block_bf16_d256."""
    rs = np.random.RandomState(13)
    x = _bf16(rs, card, (B, S, C), 2.0, 0.5)
    gs, gb = _tensors(rs, card, ((C,), 0.1, 1.0), ((C,), 0.1, 0.0))
    w = [_bf16(rs, card, shape, scale, 0.0)
         for shape, scale in (((C, 3 * C), C ** -0.5), ((3 * C,), 0.1),
                              ((C, C), C ** -0.5), ((C,), 0.1))]
    out = attn_block(x, gs, gb, *w, num_heads=1, eps=1e-6)
    attn_bf16_check(out, attn_block_reference(x, gs, gb, *w, num_heads=1,
                                              eps=1e-6), x, "K2 bf16 d256")
    assert torch.equal(out, attn_block(x, gs, gb, *w, num_heads=1, eps=1e-6))
    assert dict(_lib.LAUNCHES) == {"attn_block_bf16_d256": 2}


@pytest.mark.parametrize("nh", [1, 2])
@pytest.mark.parametrize("d", [136, 192, 256])
@pytest.mark.parametrize("S", [64, 256, 1024])
def test_attn_core_wide(card, S, d, nh):
    """The wide attention core alone (bf16, 128 < d <= 256; one consumer
    warpgroup at S = 64, two above; d = 136 and 192 leave columns of the
    padded width to TMA's zeros) against its plain version under K4's gate
    (chip_smoke.flash_check, which also allows for another rounding of p),
    a replay bit-equal."""
    rs = np.random.RandomState(14)
    B, C = 2, nh * d
    qkv = torch.from_numpy(rs.randn(B, S, 3 * C).astype(np.float32)).to(card)
    qkv[..., :C] *= 2 * d ** -0.25  # logits of scale 2: a peaked softmax
    qkv[..., C:2 * C] *= d ** -0.25
    qkv = qkv.bfloat16()
    out = attn_core_wide(qkv, nh)
    q, k, v = qkv.reshape(B, S, 3, nh, d).unbind(2)
    flash_check(out.reshape(q.shape),
                attn_core_reference(qkv, nh).reshape(q.shape), q, k, v, 1.0,
                "attn_core_wide")
    assert torch.equal(out, attn_core_wide(qkv, nh))
    assert dict(_lib.LAUNCHES) == {"attn_core_wide": 2}


@pytest.mark.parametrize("nh", [1, 2])
@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("S", [64, 256, 1024])
def test_attn_block_bb_bf16_wide(card, S, d, nh):
    """K7 bf16 at 128 < d <= 256 (K1's one-pass fp32 statistics, then K2
    bf16's launches with the wide core) against its plain version, a
    replay bit-equal. d = 136 has no width that GroupNorm(32) takes: the
    core's own test holds it."""
    rs = np.random.RandomState(15)
    B, C = 4, nh * d
    x = _bf16(rs, card, (B, S, C), 2.0, 0.5)
    gs, gb = _tensors(rs, card, ((C,), 0.1, 1.0), ((C,), 0.1, 0.0))
    w = [_bf16(rs, card, shape, scale, 0.0)
         for shape, scale in (((C, 3 * C), C ** -0.5), ((3 * C,), 0.02),
                              ((C, C), C ** -0.5), ((C,), 0.02))]
    out = attn_block_bb(x, gs, gb, *w, num_heads=nh, bb=2)
    attn_bf16_check(out, attn_block_bb_reference(x, gs, gb, *w,
                                                 num_heads=nh, bb=2),
                    x, "attn_block_bb_bf16 wide")
    assert torch.equal(out, attn_block_bb(x, gs, gb, *w, num_heads=nh, bb=2))
    assert dict(_lib.LAUNCHES) == {"attn_block_bb_bf16": 2}


def test_attn_block_autograd_matches_plain_autograd(card):
    """attn_block's gradient with the K7 forward: the vjp of the fp32
    reference, which autograd through attn_block_reference equals."""
    rs = np.random.RandomState(10)
    C = 64
    args = _tensors(rs, card, ((8, 64, C), 1.0, 0.0), ((C,), 0.1, 1.0),
                    ((C,), 0.1, 0.0), ((C, 3 * C), C ** -0.5, 0.0),
                    ((3 * C,), 0.1, 0.0), ((C, C), C ** -0.5, 0.0),
                    ((C,), 0.1, 0.0))
    ct = torch.randn(8, 64, C, device=card)
    got = [a.clone().requires_grad_() for a in args]
    attn_block(*got, num_heads=1, eps=1e-6, block_b=2).backward(ct)
    want = [a.clone().requires_grad_() for a in args]
    attn_block_reference(*want, num_heads=1, eps=1e-6).backward(ct)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.grad, w.grad, rtol=0, atol=0)
    assert _lib.LAUNCHES["attn_block_bb"] == 1


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    x = torch.zeros(2, 8, 8, 48, device=card)
    with pytest.raises(ValueError):
        gn_silu_conv(x, x.new_ones(48), x.new_zeros(48),
                     x.new_zeros(3, 3, 48, 64), x.new_zeros(64))
    y = torch.zeros(2, 16, 64, device=card)
    with pytest.raises(ValueError):
        attn_block(y, y.new_ones(64), y.new_zeros(64), y.new_zeros(64, 192),
                   y.new_zeros(192), y.new_zeros(64, 64), y.new_zeros(64),
                   num_heads=1)
    with pytest.raises(ValueError):
        group_norm(torch.zeros(2, 8, 64, device=card).transpose(1, 2),
                   torch.ones(8, device=card), torch.zeros(8, device=card), 8)
    assert not _lib.LAUNCHES


def _bf16(rs, device, shape, scale, shift):
    return torch.from_numpy((rs.randn(*shape) * scale + shift)
                            .astype(np.float32)).to(device).bfloat16()


@pytest.mark.parametrize("stats", ["fp32", "bf16_onepass"])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape", [(100, 64, 1536), (100, 4096, 192),
                                   (8, 64, 1344), (8, 256, 960),
                                   (4, 16, 1152), (4, 1024, 384),
                                   (3, 7, 64)])
def test_group_norm_bf16(card, shape, silu, stats):
    rs = np.random.RandomState(3)
    C = shape[-1]
    x = _bf16(rs, card, shape, 2.0, 0.5)
    s, b = _tensors(rs, card, ((C,), 0.1, 1.0), ((C,), 0.1, 0.0))
    atol, rtol = TOL["gn_silu_bf16"]
    torch.testing.assert_close(
        group_norm(x, s, b, 32, 1e-5, silu, stats).float(),
        group_norm_silu_reference(x, s, b, 32, 1e-5, silu, stats).float(),
        rtol=rtol, atol=atol)
    assert _lib.LAUNCHES["gn_silu_bf16"] == 1


@pytest.mark.parametrize("side", ["on_chip", "split"])
@pytest.mark.parametrize("form", [("bf16", "fp32"), ("bf16", "bf16_onepass"),
                                  ("fp32", "fp32")])
@pytest.mark.parametrize("cg", [6, 12, 24, 48])
def test_group_norm_route_edges(card, cg, form, side):
    """K1 on either side of its route gate: the largest map the on-chip
    route takes at this width and the next one (split), against its plain
    version, a replay bit-equal."""
    dtype = torch.bfloat16 if form[0] == "bf16" else torch.float32
    name = "gn_silu_bf16" if form[0] == "bf16" else "gn_silu"
    C = 32 * cg
    hw = gn_route_edges(C, dtype)[side == "split"]
    assert route(hw, C, 32, dtype).on_chip == (side == "on_chip")
    rs = np.random.RandomState(11)
    x, s, b = _tensors(rs, card, ((4, hw, C), 2.0, 0.5), ((C,), 0.1, 1.0),
                       ((C,), 0.1, 0.0))
    x = x.to(dtype)
    out = group_norm(x, s, b, 32, 1e-5, True, form[1])
    atol, rtol = TOL[name]
    torch.testing.assert_close(
        out.float(),
        group_norm_silu_reference(x, s, b, 32, 1e-5, True, form[1]).float(),
        rtol=rtol, atol=atol)
    assert torch.equal(out, group_norm(x, s, b, 32, 1e-5, True, form[1]))
    assert _lib.LAUNCHES[name] == 2


@pytest.mark.parametrize("shape", [(8, 1024, 96), (4, 64, 1536)])
def test_group_norm_fp32_onepass(card, shape):
    C = shape[-1]
    x, s, b = _tensors(np.random.RandomState(4), card, (shape, 2.0, 0.5),
                       ((C,), 0.1, 1.0), ((C,), 0.1, 0.0))
    _check(group_norm(x, s, b, 32, 1e-5, True, "bf16_onepass"),
           group_norm_silu_reference(x, s, b, 32, 1e-5, True, "bf16_onepass"),
           "gn_silu")


def _bf16_block(rs, device, B, S, C):
    x = _bf16(rs, device, (B, S, C), 1.0, 0.0)
    gs, gb = _tensors(rs, device, ((C,), 0.1, 1.0), ((C,), 0.1, 0.0))
    w = [_bf16(rs, device, shape, scale, 0.0)
         for shape, scale in (((C, 3 * C), C ** -0.5), ((3 * C,), 0.02),
                              ((C, C), C ** -0.5), ((C,), 0.02))]
    return x, gs, gb, *w


# the ImageNet64 maps; E3 fused_train's forward (batch 128); the wgmma
# GEMMs' edges: M = 192 (half of the last 128-row tile), C = 64 and 96
# (N tiles and 64-column boxes past N, one k-block zero-filled past K)
@pytest.mark.parametrize("B,S,C,nh", [(8, 1024, 384, 6), (8, 256, 576, 9),
                                      (8, 64, 768, 12), (2, 64, 64, 2),
                                      (2, 128, 96, 3), (128, 1024, 384, 6),
                                      (3, 64, 768, 12)])
def test_attn_block_bf16(card, B, S, C, nh):
    a = _bf16_block(np.random.RandomState(5), card, B, S, C)
    attn_bf16_check(attn_block(*a, num_heads=nh),
                    attn_block_reference(*a, num_heads=nh), a[0],
                    "attn_block_bf16")
    assert _lib.LAUNCHES["attn_block_bf16"] == 1


@pytest.mark.parametrize("B,S,nh,d", [(4, 1024, 6, 64), (2, 512, 2, 128),
                                      (2, 512, 4, 32), (1, 640, 2, 36)])
def test_flash_mha(card, B, S, nh, d):
    rs = np.random.RandomState(6)
    q, k, v = (_bf16(rs, card, (B, S, nh, d), 1.0, 0.0) for _ in range(3))
    flash_check(flash_mha(q, k, v, d ** -0.5),
                flash_mha_reference(q, k, v, d ** -0.5), q, k, v, d ** -0.5,
                "flash_attn")
    assert _lib.LAUNCHES["flash_attn"] == 1


@pytest.mark.parametrize("layout", ["qkv", "separate"])
@pytest.mark.parametrize("d", [24, 32, 40, 64, 128])
@pytest.mark.parametrize("S", [64, 256, 1024])
def test_flash_kernel_edges(card, S, d, layout):
    """K4's wgmma kernel at its tile forms (S = 64: one consumer warpgroup;
    S % 128 == 0: two), every padded head width, on views of one qkv buffer
    and on three tensors, with its logsumexp."""
    rs = np.random.RandomState(S + d)
    B, nh = 2, 3
    if layout == "qkv":
        q, k, v = _bf16(rs, card, (B, S, 3, nh, d), 1.0, 0.0).unbind(2)
    else:
        q, k, v = (_bf16(rs, card, (B, S, nh, d), 1.0, 0.0)
                   for _ in range(3))
    lse = torch.empty((B, nh, S), device=card)
    out = flash_fwd_kernel(q, k, v, d ** -0.5, lse)
    ref, ref_lse = flash_mha_reference_fwd(q, k, v, d ** -0.5)
    flash_check(out, ref, q, k, v, d ** -0.5, "flash_attn")
    flash_lse_check(lse, ref_lse, "flash_attn")
    assert _lib.LAUNCHES["flash_attn"] == 1


def test_flash_mha_reads_qkv_views(card):
    """q, k, v as strided views of one (B, S, 3, nh, d) tensor, as the ADM
    attention block passes them."""
    qkv = _bf16(np.random.RandomState(7), card, (2, 1024, 3, 6, 64), 1.0, 0.0)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    flash_check(flash_mha(q, k, v, 0.125), flash_mha_reference(q, k, v, 0.125),
                q, k, v, 0.125, "flash_attn")


def test_unported_forms_raise(card):
    """A CUDA tensor launches the kernel or raises: K2 has no bf16 form at
    d % 8 != 0 (here d = 4) and K4 no fp32 form yet."""
    rs = np.random.RandomState(8)
    x = _bf16(rs, card, (1, 256, 96), 1.0, 0.0)
    gs, gb = _tensors(rs, card, ((96,), 0.1, 1.0), ((96,), 0.1, 0.0))
    w = [_bf16(rs, card, shape, 0.05, 0.0)
         for shape in ((96, 288), (288,), (96, 96), (96,))]
    with pytest.raises(NotImplementedError):
        attn_block(x, gs, gb, *w, num_heads=24)
    q = torch.zeros(1, 512, 2, 64, device=card)
    with pytest.raises(NotImplementedError):
        flash_mha(q, q, q, 0.125)
    assert not _lib.LAUNCHES


def _i8_block(rs, device, B, S, C, nh, dtype):
    x, gs, gb = _tensors(rs, device, ((B, S, C), 1.0, 0.0), ((C,), 0.1, 1.0),
                         ((C,), 0.1, 0.0))
    wq, bq, wp, bp = _tensors(rs, device, ((C, 3 * C), C ** -0.5, 0.0),
                              ((3 * C,), 0.02, 0.0), ((C, C), C ** -0.5, 0.0),
                              ((C,), 0.02, 0.0))
    mats = prep_int8_mats(wq, wp, *calibrated_attn_scales(x, gs, gb, wq, bq,
                                                          nh))
    return x.to(dtype), gs, gb, mats, bq, bp


# bf16 also at the wgmma GEMMs' edges: M = 192 (half of the last 128-row
# tile) at LSUN's C = 1024 (eight 128-byte k-blocks), C = 96 (a k-block
# zero-filled past K)
@pytest.mark.parametrize("B,S,C,nh,dtype", [
    (8, 64, 64, 2, torch.float32), (2, 256, 128, 2, torch.float32),
    (8, 1024, 384, 6, torch.bfloat16), (8, 256, 576, 9, torch.bfloat16),
    (8, 64, 768, 12, torch.bfloat16), (4, 256, 1024, 16, torch.bfloat16),
    (2, 128, 96, 3, torch.bfloat16), (3, 64, 1024, 16, torch.bfloat16)])
def test_attn_block_int8(card, B, S, C, nh, dtype):
    a = _i8_block(np.random.RandomState(9), card, B, S, C, nh, dtype)
    attn_i8_check(attn_block_int8(*a, nh), attn_block_int8_plain(*a, nh),
                  a[0], a[3], "attn_block_i8")
    assert _lib.LAUNCHES["attn_block_i8"] == 1


@pytest.mark.parametrize("form", ["bf16", "i8"])
@pytest.mark.parametrize("B,S,C,nh", [(8, 1024, 384, 6), (8, 256, 576, 9),
                                      (8, 64, 768, 12), (3, 64, 768, 12)])
def test_attn_blocks_replay_bit_equal(card, form, B, S, C, nh):
    """K2 bf16 and K5 (bf16) sum in fixed orders (no split-k, no
    atomics): a replay is bit-equal."""
    rs = np.random.RandomState(13)
    if form == "bf16":
        a = _bf16_block(rs, card, B, S, C)
        run = lambda: attn_block(*a, num_heads=nh)  # noqa: E731
    else:
        a = _i8_block(rs, card, B, S, C, nh, torch.bfloat16)
        run = lambda: attn_block_int8(*a, nh)  # noqa: E731
    assert torch.equal(run(), run())


@pytest.mark.parametrize("B,R,Cin,Cout,k,pad,dtype,dynamic", [
    (4, 8, 1536, 768, 3, quant.SAME_3X3, torch.bfloat16, False),
    (2, 32, 384, 384, 2, ((1, 0), (0, 1)), torch.bfloat16, False),
    (2, 32, 384, 384, 2, ((0, 1), (1, 0)), torch.bfloat16, False),
    (2, 64, 192, 192, 3, quant.SAME_3X3, torch.bfloat16, True),
    (4, 16, 96, 64, 3, quant.SAME_3X3, torch.float32, False),
    (3, 5, 64, 40, 1, ((0, 0), (0, 0)), torch.float32, False),
    # the tiles' edges: the other two phase pads; Cout = 192 (one N tile)
    # and 576 (three); M off the 128-pixel tile with Cin = 96 (half of the
    # last 64-channel chunk); fp32 x with a dynamic scale; the widest
    # windows (bf16 in 32-channel chunks past W = 382, fp32 at W = 512)
    (2, 32, 384, 384, 2, ((1, 0), (1, 0)), torch.bfloat16, False),
    (2, 32, 384, 384, 2, ((0, 1), (0, 1)), torch.bfloat16, False),
    (3, 64, 384, 192, 3, quant.SAME_3X3, torch.bfloat16, False),
    (2, 16, 576, 576, 3, quant.SAME_3X3, torch.bfloat16, False),
    (3, 10, 96, 576, 3, quant.SAME_3X3, torch.bfloat16, False),
    (4, 16, 96, 64, 3, quant.SAME_3X3, torch.float32, True),
    (1, 400, 32, 16, 3, quant.SAME_3X3, torch.bfloat16, False),
    (1, 512, 32, 16, 3, quant.SAME_3X3, torch.float32, False)])
def test_int8_conv(card, B, R, Cin, Cout, k, pad, dtype, dynamic):
    rs = np.random.RandomState(10)
    x, w, b = _tensors(rs, card, ((B, R, R, Cin), 2.0, 0.3),
                       ((k, k, Cin, Cout), (k * k * Cin) ** -0.5, 0.0),
                       ((Cout,), 0.1, 0.0))
    x = x.to(dtype)
    if dynamic:
        out = quant.int8_conv(x, w, b, padding=pad, out_dtype=dtype)
        a = torch.clamp(x.float().abs().amax(), min=1e-8) / 127.0
    else:
        a = quant.calib_channel_scale(x.reshape(-1, Cin))
        out = quant.int8_conv_static(x, w, b, a, padding=pad,
                                     out_dtype=dtype)
    ref = quant.int8_conv_reference(x, quant.prepare_conv_static(w, a), b,
                                    pad, dtype)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert _lib.LAUNCHES["int8_conv"] == 1


@pytest.mark.parametrize("B,R,Cin,Cout,k,pad,dtype,dynamic", [
    # the CIFAR-10 Downsample convs on their (0, 1)-padded maps (33, 17, 9)
    (4, 33, 128, 128, 3, ((0, 0), (0, 0)), torch.float32, False),
    (4, 17, 256, 256, 3, ((0, 0), (0, 0)), torch.bfloat16, False),
    (5, 9, 256, 256, 3, ((0, 0), (0, 0)), torch.float32, True),
    # the same pads inside the conv, SAME at an odd map, 1x1 and 2x2 taps,
    # Cout past one 192-channel tile, Cin = 96, the widest map (W = 128)
    (4, 32, 128, 128, 3, ((0, 1), (0, 1)), torch.bfloat16, False),
    (3, 9, 64, 40, 3, ((1, 1), (1, 1)), torch.float32, False),
    (2, 16, 64, 32, 1, ((0, 0), (0, 0)), torch.bfloat16, True),
    (2, 16, 96, 320, 2, ((1, 0), (0, 1)), torch.bfloat16, False),
    (1, 128, 32, 16, 3, ((0, 1), (0, 1)), torch.float32, False),
    (1, 128, 32, 16, 3, ((1, 1), (1, 1)), torch.bfloat16, False)])
def test_int8_conv_stride2(card, B, R, Cin, Cout, k, pad, dtype, dynamic):
    """K8's stride-2 form (four parity planes) against its plain version:
    exact, and a replay bit-equal."""
    rs = np.random.RandomState(13)
    x, w, b = _tensors(rs, card, ((B, R, R, Cin), 2.0, 0.3),
                       ((k, k, Cin, Cout), (k * k * Cin) ** -0.5, 0.0),
                       ((Cout,), 0.1, 0.0))
    x = x.to(dtype)
    if dynamic:
        def run():
            return quant.int8_conv(x, w, b, (2, 2), pad, out_dtype=dtype)
        a = torch.clamp(x.float().abs().amax(), min=1e-8) / 127.0
    else:
        a = quant.calib_channel_scale(x.reshape(-1, Cin))

        def run():
            return quant.int8_conv_static(x, w, b, a, (2, 2), pad,
                                          out_dtype=dtype)
    out = run()
    ref = quant.int8_conv_reference(x, quant.prepare_conv_static(w, a), b,
                                    pad, dtype, stride=2)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert _lib.LAUNCHES["int8_conv_s2"] == 1 and not _lib.LAUNCHES[
        "int8_conv"]
    assert torch.equal(out, run())


@pytest.mark.parametrize("stats", ["bf16_onepass", "fp32"])
@pytest.mark.parametrize("shape", [(100, 1024, 128), (100, 1024, 384),
                                   (96, 256, 512), (96, 16, 256)])
def test_group_norm_cifar_bf16(card, shape, stats):
    """K1 at the CIFAR-10 net's bf16 widths (4, 12, 16 and 8 channels a
    group) against its plain version, and a replay bit-equal."""
    C = shape[-1]
    x, s, b = _tensors(np.random.RandomState(14), card, (shape, 2.0, 0.5),
                       ((C,), 0.1, 1.0), ((C,), 0.1, 0.0))
    x = x.bfloat16()
    out = group_norm(x, s, b, 32, 1e-6, True, stats)
    ref = group_norm_silu_reference(x, s, b, 32, 1e-6, True, stats)
    atol, rtol = TOL["gn_silu_bf16"]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=atol)
    assert torch.equal(out, group_norm(x, s, b, 32, 1e-6, True, stats))


@pytest.mark.parametrize("rows,Cin,Cout", [(300, 384, 1152), (64, 96, 8)])
def test_int8_matmul(card, rows, Cin, Cout):
    """int8_matmul_static, K8 on a W = 1 image (1x1 taps): exact."""
    rs = np.random.RandomState(12)
    x, w, b = _tensors(rs, card, ((rows, Cin), 2.0, 0.3),
                       ((Cin, Cout), Cin ** -0.5, 0.0), ((Cout,), 0.1, 0.0))
    x = x.bfloat16()
    a = quant.calib_channel_scale(x)
    out = quant.int8_matmul_static(x, w, b, a)
    ref = quant.int8_conv_reference(
        x.reshape(rows, 1, 1, Cin),
        quant.prepare_conv_static(w.reshape(1, 1, Cin, Cout), a), b,
        ((0, 0), (0, 0)), torch.bfloat16).reshape(rows, Cout)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert _lib.LAUNCHES["int8_conv"] == 1


def test_int8_forms_raise(card):
    """K5 has no bf16 form at d=256 and K8 no form at Cin % 32 != 0."""
    rs = np.random.RandomState(11)
    x = _bf16(rs, card, (1, 256, 256), 1.0, 0.0)
    v = torch.ones(256, device=card)
    mats = prep_int8_mats(torch.ones(256, 768, device=card),
                          torch.ones(256, 256, device=card), v, v)
    with pytest.raises(NotImplementedError):
        attn_block_int8(x, v, v, mats, torch.zeros(768, device=card), v, 1)
    x = torch.zeros(1, 8, 8, 48, device=card)
    with pytest.raises(ValueError):
        quant.int8_conv_static(x, torch.ones(3, 3, 48, 32, device=card), None,
                               torch.ones(48, device=card))
    assert not _lib.LAUNCHES


# ---- the training slice: K4-dkv, K4-dq, K6 and their autograd functions ----


@pytest.mark.parametrize("B,S,nh,d", [(4, 1024, 6, 64), (2, 512, 2, 64),
                                      (2, 512, 4, 32), (2, 512, 3, 40),
                                      (2, 512, 4, 24)])
def test_flash_backward(card, B, S, nh, d):
    from chip_smoke import (FLASH_CHAIN_MEAN_REL, flash_bwd_check,
                            flash_lse_check)
    from dxmi_tpu_torch.ops.attention import (flash_mha_bwd, flash_mha_fwd,
                                              flash_mha_reference_bwd,
                                              flash_mha_reference_fwd)

    g = torch.Generator(device=card).manual_seed(0)
    qkv = torch.randn(B, S, 3, nh, d, generator=g, device=card).bfloat16()
    do = torch.randn(B, S, nh, d, generator=g, device=card).bfloat16()
    o, lse = flash_mha_fwd(qkv, d ** -0.5)
    o_p, lse_p = flash_mha_reference_fwd(*qkv.unbind(2), d ** -0.5)
    flash_lse_check(lse, lse_p, "lse")
    got = flash_mha_bwd(qkv, o, lse, do, d ** -0.5)
    ref = flash_mha_reference_bwd(qkv, o, lse, do, d ** -0.5)
    chain = flash_mha_reference_bwd(qkv, o_p, lse_p, do, d ** -0.5)
    for i in range(3):
        flash_bwd_check(got[:, :, i], ref[:, :, i], f"grad {i}")
        flash_bwd_check(got[:, :, i], chain[:, :, i], f"grad {i} chained",
                        mean_rel=FLASH_CHAIN_MEAN_REL, elementwise=False)
    assert torch.equal(got, flash_mha_bwd(qkv, o, lse, do, d ** -0.5))
    assert _lib.LAUNCHES["flash_attn_bwd_dkv"] == 2
    assert _lib.LAUNCHES["flash_attn_bwd_dq"] == 2


def test_flash_autograd_matches_plain_autograd(card):
    """FlashAttention's gradients against autograd through the plain forward
    (whose backward is PyTorch's own): the same function, differing by
    the roundings of p, ds and the bf16 gradients."""
    from dxmi_tpu_torch.ops.attention import (flash_fwd_kernel, flash_mha,
                                          flash_mha_reference,
                                          flash_mha_reference_fwd)

    g = torch.Generator(device=card).manual_seed(1)
    qkv = torch.randn(2, 1024, 3, 6, 64, generator=g, device=card).bfloat16()
    do = torch.randn(2, 1024, 6, 64, generator=g, device=card).bfloat16()
    a = qkv.clone().requires_grad_(True)
    ga, = torch.autograd.grad(flash_mha(*a.unbind(2), 0.125), a, do)
    b = qkv.float().requires_grad_(True)
    gb, = torch.autograd.grad(flash_mha_reference(*b.unbind(2), 0.125), b,
                              do.float())
    rel = ((ga.float() - gb).abs().mean() / gb.abs().mean()).item()
    assert rel < 2e-2, rel
    assert _lib.LAUNCHES["flash_attn"] == 1


@pytest.mark.parametrize("B,S,C,nh,dtype", [
    (4, 1024, 384, 6, torch.bfloat16), (8, 256, 576, 9, torch.bfloat16),
    (8, 64, 768, 12, torch.bfloat16), (8, 64, 64, 2, torch.float32),
    (2, 128, 96, 3, torch.float32),
    # the tensor-core kernels' edges: one 64-row tile at d = 32; head dims
    # zero-padded to 64 (d = 40) and to 32 (d = 24); heads off 16 bytes
    # (d = 36: 8-byte loads)
    (4, 64, 256, 8, torch.bfloat16), (2, 128, 320, 8, torch.bfloat16),
    (2, 256, 192, 8, torch.bfloat16), (2, 64, 288, 8, torch.bfloat16)])
def test_attn_block_backward(card, B, S, C, nh, dtype):
    from chip_smoke import attn_bwd_check
    from dxmi_tpu_torch.ops.attn_block import (attn_block_bwd,
                                               attn_block_bwd_reference)

    rs = np.random.RandomState(2)
    x, ct, gs, gb, wq, bq, wp = _tensors(
        rs, card, ((B, S, C), 2.0, 0.5), ((B, S, C), 1.0, 0.5),
        ((C,), 0.1, 1.0), ((C,), 0.1, 0.0), ((C, 3 * C), C ** -0.5, 0.0),
        ((3 * C,), 0.1, 0.0), ((C, C), C ** -0.5, 0.0))
    args = (x.to(dtype), ct.to(dtype), gs, gb, wq.to(dtype), bq.to(dtype),
            wp.to(dtype))
    outs = attn_block_bwd(*args, nh)
    attn_bwd_check(outs, attn_block_bwd_reference(*args, nh), dtype, "K6")
    assert all(torch.equal(a, b) for a, b in zip(outs,
                                                  attn_block_bwd(*args, nh)))


@pytest.mark.parametrize("B,S,C,nh", K6_SMALL_SHAPES + K6_PAST_SMALL)
def test_attn_block_backward_fp32_routes(card, B, S, C, nh):
    """K6 fp32 under its gate and bit-equal on replay, on the one-launch
    route inside its limit (S = 64, C <= 64) and on the multi-launch route
    past it, each call counted on its own route."""
    from chip_smoke import k6_fp32_route_check
    from dxmi_tpu_torch.ops.attn_block import bwd_small_takes

    gen = torch.Generator(device=card).manual_seed(7)
    assert bwd_small_takes(S, C, nh, torch.float32) == (
        (B, S, C, nh) in K6_SMALL_SHAPES)
    k6_fp32_route_check(gen, B, S, C, nh)


def test_tensor_core_backward_replays_bit_equal(card):
    """K4-dkv (di, dk and dv), K4-dq (dq) and K6 in bf16 at the 32x32
    map's widths: each replay equals the first call bit for bit (every sum
    is owned by one warp in a fixed order, with no atomics)."""
    from dxmi_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                              flash_mha_fwd)
    from dxmi_tpu_torch.ops.attn_block import attn_block_bwd

    g = torch.Generator(device=card).manual_seed(5)
    qkv = torch.randn(8, 1024, 3, 6, 64, generator=g, device=card).bfloat16()
    do = torch.randn(8, 1024, 6, 64, generator=g, device=card).bfloat16()
    o, lse = flash_mha_fwd(qkv, 0.125)
    di, dqkv = flash_bwd_dkv(qkv, o, lse, do, 0.125)
    flash_bwd_dq(qkv, do, lse, di, dqkv, 0.125)
    for _ in range(2):
        di2, dqkv2 = flash_bwd_dkv(qkv, o, lse, do, 0.125)
        flash_bwd_dq(qkv, do, lse, di2, dqkv2, 0.125)
        assert torch.equal(di, di2)
        assert torch.equal(dqkv, dqkv2)
    assert _lib.LAUNCHES["flash_attn_bwd_dkv"] == 3
    assert _lib.LAUNCHES["flash_attn_bwd_dq"] == 3
    rs = np.random.RandomState(6)
    B, S, C, nh = 8, 1024, 384, 6
    x, ct, gs, gb, wq, bq, wp = _tensors(
        rs, card, ((B, S, C), 2.0, 0.5), ((B, S, C), 1.0, 0.5),
        ((C,), 0.1, 1.0), ((C,), 0.1, 0.0), ((C, 3 * C), C ** -0.5, 0.0),
        ((3 * C,), 0.1, 0.0), ((C, C), C ** -0.5, 0.0))
    args = (x.bfloat16(), ct.bfloat16(), gs, gb, wq.bfloat16(), bq.bfloat16(),
            wp.bfloat16())
    first = attn_block_bwd(*args, nh)
    for _ in range(2):
        assert all(torch.equal(a, b)
                   for a, b in zip(first, attn_block_bwd(*args, nh)))
    assert _lib.LAUNCHES["attn_block_bwd_bf16"] == 3


def test_fused_train_autograd_matches_plain_autograd(card):
    """FusedAttnBlockTrain (K2 forward, K6 backward) with fp32 master
    parameters against autograd through the fp32 plain forward: the fp32
    block within the JAX package's 5e-4 limits."""
    from dxmi_tpu_torch.ops.attn_block import (attn_block_reference,
                                               fused_attn_block_train)

    rs = np.random.RandomState(3)
    B, S, C, nh = 4, 64, 64, 2
    params = _tensors(rs, card, ((B, S, C), 2.0, 0.5), ((C,), 0.1, 1.0),
                      ((C,), 0.1, 0.0), ((C, 3 * C), C ** -0.5, 0.0),
                      ((3 * C,), 0.1, 0.0), ((C, C), C ** -0.5, 0.0),
                      ((C,), 0.1, 0.0))
    ct = torch.randn(B, S, C, device=card)
    a = [t.clone().requires_grad_(True) for t in params]
    ga = torch.autograd.grad(fused_attn_block_train(*a, num_heads=nh), a, ct)
    b = [t.clone().requires_grad_(True) for t in params]
    gb = torch.autograd.grad(attn_block_reference(*b, num_heads=nh), b, ct)
    for x, y in zip(ga, gb):
        torch.testing.assert_close(x, y, rtol=5e-4, atol=5e-4)
    assert _lib.LAUNCHES["attn_block"] == 1
    assert _lib.LAUNCHES["attn_block_bwd_small"] == 1


def test_group_norm_autograd(card):
    """K1 forward with the plain version's gradient on the card."""
    rs = np.random.RandomState(4)
    x, s, b = _tensors(rs, card, ((4, 256, 192), 2.0, 0.5), ((192,), 0.1, 1.0),
                       ((192,), 0.1, 0.0))
    x = x.bfloat16().requires_grad_(True)
    s.requires_grad_(True)
    y = group_norm(x, s, b, 32, 1e-5, True, "bf16_onepass")
    gy = torch.randn_like(y)
    got = torch.autograd.grad(y, (x, s), gy)
    x2 = x.detach().requires_grad_(True)
    s2 = s.detach().requires_grad_(True)
    want = torch.autograd.grad(group_norm_silu_reference(
        x2, s2, b, 32, 1e-5, True, "bf16_onepass"), (x2, s2), gy)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    assert _lib.LAUNCHES["gn_silu_bf16"] == 1


def test_backward_forms_raise(card):
    from dxmi_tpu_torch.ops.attention import flash_mha_fwd
    from dxmi_tpu_torch.ops.attn_block import attn_block_bwd

    with pytest.raises(NotImplementedError):
        flash_mha_fwd(torch.zeros(1, 512, 3, 2, 64, device=card), 0.125)
    with pytest.raises(NotImplementedError):
        flash_mha_fwd(torch.zeros(1, 512, 3, 1, 128, device=card,
                                  dtype=torch.bfloat16), 0.125)
    # heads off 16 bytes (d = 36) reach K4-dq through K6 only: the flash
    # backward's di launch loads 16 bytes at a time
    with pytest.raises(NotImplementedError):
        flash_mha_fwd(torch.zeros(1, 512, 3, 2, 36, device=card,
                                  dtype=torch.bfloat16), 0.125)
    x = torch.zeros(1, 64, 256, device=card)
    with pytest.raises(NotImplementedError):
        attn_block_bwd(x, x, torch.ones(256, device=card),
                       torch.zeros(256, device=card),
                       torch.zeros(256, 768, device=card),
                       torch.zeros(768, device=card),
                       torch.zeros(256, 256, device=card), 2)
