"""The int8 attention block (dxmi_tpu_torch.ops.attn_block: K5's plain
version, its preparation and the JAX oracle) against dxmi_tpu on the CPU,
at the JAX interpret-mode shapes (S=64, C=64 and S=256, C=128, two heads).

- prep_int8_mats equals _prep_int8_mats (int8 weights, scales: exact);
- the port's attn_block_int8_reference equals the JAX oracle (fp32 and bf16
  alike: the same rounding steps, exact int8 products);
- the plain K5 against _kernel_i8 in interpret mode: fp32 at the JAX
  package's own rtol = atol = 2e-4 (tests/test_attn_block.py:335); bf16 at
  its mean relative error < 2e-2, and element by element within one bf16
  ulp of |y| plus one int8 level of the proj at that column (127 swp[n]):
  the two compute their GN statistics in another fp32 order, which can flip
  an int8 rounding;
- the plain K5 stays in the oracle's W8A8 class (< 2e-2 from it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import bf16_ulp
from dxmi_tpu.ops import attn_block as ja
from dxmi_tpu_torch.ops import _lib
from dxmi_tpu_torch.ops import attn_block as ta

SHAPES = [(2, 64, 64, 2), (2, 256, 128, 2)]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _inputs(B, S, C, seed, act=(0.03, 0.02)):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, C).astype(np.float32)
    gs = (1 + 0.1 * rs.randn(C)).astype(np.float32)
    gb = (0.1 * rs.randn(C)).astype(np.float32)
    wq = (rs.randn(C, 3 * C) / np.sqrt(C)).astype(np.float32)
    bq = (0.02 * rs.randn(3 * C)).astype(np.float32)
    wp = (rs.randn(C, C) / np.sqrt(C)).astype(np.float32)
    bp = (0.02 * rs.randn(C)).astype(np.float32)
    sa_q = (act[0] * (1 + 0.2 * rs.rand(C))).astype(np.float32)
    sa_p = (act[1] * (1 + 0.2 * rs.rand(C))).astype(np.float32)
    return x, gs, gb, wq, bq, wp, bp, sa_q, sa_p


def _both(args, jdt, tdt):
    j = [jnp.asarray(a) for a in args]
    t = [torch.from_numpy(a) for a in args]
    j[0], t[0] = j[0].astype(jdt), t[0].to(tdt)
    return j, t


def _plain(t, nh):
    x, gs, gb, wq, bq, wp, bp, sa_q, sa_p = t
    mats = ta.prep_int8_mats(wq, wp, sa_q, sa_p)
    return ta.attn_block_int8_plain(x, gs, gb, mats, bq, bp, nh), mats


@pytest.mark.parametrize("zeros", [False, True])
def test_prep_int8_mats_equal(zeros):
    """Including uncalibrated (zero) scales, floored at 1e-8."""
    args = _inputs(1, 64, 64, 0)
    if zeros:
        args = (*args[:7], np.zeros(64, np.float32), np.zeros(64, np.float32))
    j, t = _both(args, jnp.float32, torch.float32)
    want = ja._prep_int8_mats(j[3], j[5], j[7], j[8])
    got = ta.prep_int8_mats(t[3], t[5], t[7], t[8])
    for w, g in zip(want, (got.wq.t(), got.swq, got.isa_q, got.wp.t(),
                           got.swp, got.isa_p)):
        np.testing.assert_array_equal(np.asarray(w).reshape(g.shape),
                                      g.numpy())
    assert got.wq.dtype == torch.int8 and got.wq.is_contiguous()


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("B,S,C,nh", SHAPES)
def test_oracle_equals_jax_oracle(B, S, C, nh, jdt, tdt):
    j, t = _both(_inputs(B, S, C, 1), jdt, tdt)
    want = np.asarray(ja.attn_block_int8_reference(*j, num_heads=nh),
                      np.float32)
    got = ta.attn_block_int8_reference(*t, num_heads=nh)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("B,S,C,nh", SHAPES)
def test_plain_fp32_matches_pallas_kernel_interpret(B, S, C, nh):
    j, t = _both(_inputs(B, S, C, 3), jnp.float32, torch.float32)
    want = np.asarray(ja.fused_attn_block_int8(*j, num_heads=nh,
                                               interpret=True))
    got, _ = _plain(t, nh)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("B,S,C,nh", SHAPES)
def test_plain_bf16_matches_pallas_kernel_interpret(B, S, C, nh):
    j, t = _both(_inputs(B, S, C, 4), jnp.bfloat16, torch.bfloat16)
    want = torch.from_numpy(np.asarray(
        ja.fused_attn_block_int8(*j, num_heads=nh, interpret=True),
        np.float32))
    got, mats = _plain(t, nh)
    err = (got.float() - want).abs()
    assert err.mean() / want.abs().mean() < 2e-2
    limit = bf16_ulp(torch.maximum(got.float().abs(), want.abs())) \
        + 127 * mats.swp
    assert (err <= limit).all(), float((err - limit).max())


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_plain_in_the_oracles_w8a8_class(jdt, tdt):
    j, t = _both(_inputs(2, 256, 128, 5), jdt, tdt)
    ref = np.asarray(ja.attn_block_int8_reference(*j, num_heads=2),
                     np.float32)
    got, _ = _plain(t, 2)
    rel = np.abs(got.float().numpy() - ref).mean() / np.abs(ref).mean()
    assert rel < 2e-2, rel


def test_uncalibrated_scales_stay_finite():
    args = _inputs(1, 64, 64, 6)
    args = (*args[:7], np.zeros(64, np.float32), np.zeros(64, np.float32))
    _, t = _both(args, jnp.float32, torch.float32)
    got, _ = _plain(t, 2)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("S,C,nh,ok8,ok", [
    (1024, 384, 6, True, True), (256, 1024, 16, True, False),
    (64, 1024, 16, True, False), (256, 1280, 20, False, False),
    (1024, 512, 8, True, True), (2048, 512, 8, False, False)])
def test_gate_int8_admits_c1024(monkeypatch, S, C, nh, ok8, ok):
    """The int8 gate raises the weight cap to C <= 1024 (LSUN's 16x16 and
    8x8 maps), as the JAX gate does."""
    monkeypatch.setenv("DXMI_FUSED_ATTN_FORCE", "1")
    assert ta.fused_attn_available(S, C, nh, int8=True) == ok8
    assert ta.fused_attn_available(S, C, nh) == ok
    assert ja.fused_attn_available(S, C, nh, int8=True) == ok8
    assert ja.fused_attn_available(S, C, nh) == ok


def test_cpu_tensor_takes_plain_version():
    _lib.reset_launches()
    _, t = _both(_inputs(1, 64, 64, 7), jnp.float32, torch.float32)
    x, gs, gb, wq, bq, wp, bp, sa_q, sa_p = t
    mats = ta.prep_int8_mats(wq, wp, sa_q, sa_p)
    got = ta.attn_block_int8(x, gs, gb, mats, bq, bp, 2)
    want = ta.attn_block_int8_plain(x, gs, gb, mats, bq, bp, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not _lib.LAUNCHES


@pytest.mark.parametrize("S,C,nh,dtype,exc", [
    (64, 1280, 20, torch.bfloat16, ValueError),      # outside the gate
    (256, 256, 1, torch.bfloat16, NotImplementedError),  # bf16 d=256
    (64, 96, 4, torch.float32, NotImplementedError)])    # fp32 d=24
def test_card_tensor_outside_kernel_raises(S, C, nh, dtype, exc):
    """A tensor off the CPU launches K5 or raises (the meta device stands
    in for the card: the checks run before any launch)."""
    x = torch.empty(1, S, C, dtype=dtype, device="meta")
    v = torch.empty(C, device="meta")
    mats = ta.Int8AttnMats(torch.empty(3 * C, C, dtype=torch.int8,
                                       device="meta"),
                           torch.empty(3 * C, device="meta"), v,
                           torch.empty(C, C, dtype=torch.int8, device="meta"),
                           v, v)
    with pytest.raises(exc):
        ta.attn_block_int8(x, v, v, mats, torch.empty(3 * C, device="meta"),
                           v, nh)
