"""K3 (GN+SiLU+conv3x3): the port's plain version against dxmi_tpu on the
CPU, with fp32 operands (against ``gn_silu_conv_reference``) and with bf16
operands (against the TPU kernel's arithmetic: GN+SiLU in fp32, operands
rounded to bf16, products summed in fp32, fp32 bias), on fp32 and on bf16
x (whose output the TPU kernel rounds to bf16); the autograd on bf16 x
against the vjp the JAX package means its backward to be, and the JAX
backward's own fault on bf16 x; and the CUDA kernel against the plain
version on the card (tests/test_torch_kernels_cuda.py)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxmi_tpu.ops.conv_fused import fused_gn_silu_conv
from dxmi_tpu.ops.conv_fused import gn_silu_conv_reference as jax_ref
from dxmi_tpu.ops.groupnorm import group_norm_silu_reference as jax_gn
from dxmi_tpu_torch.ops import _lib
from dxmi_tpu_torch.ops.conv_fused import (fused_conv_available, gn_silu_conv,
                                           gn_silu_conv_reference)

# (B, H, Cin, Cout): the fixture network's shapes and a full-width one
SHAPES = [(2, 16, 32, 32), (2, 8, 96, 64), (2, 8, 192, 64), (1, 4, 128, 256)]


def _inputs(B, R, Cin, Cout, seed=0):
    rs = np.random.RandomState(seed)
    return ((rs.randn(B, R, R, Cin) * 2 + 0.5).astype(np.float32),
            (1 + 0.1 * rs.randn(Cin)).astype(np.float32),
            (0.1 * rs.randn(Cin)).astype(np.float32),
            (rs.randn(3, 3, Cin, Cout) / np.sqrt(9 * Cin)).astype(np.float32),
            (0.1 * rs.randn(Cout)).astype(np.float32))


def _jax_bf16(x, gs, gb, k, b):
    h = jax_gn(x, gs, gb, 32, 1e-6, True).astype(jnp.bfloat16)
    out = jax.lax.conv_general_dilated(
        h, k.astype(jnp.bfloat16), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    return out + b


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_fp32_matches_jax(shape):
    args = _inputs(*shape)
    ours = gn_silu_conv_reference(*(torch.from_numpy(a) for a in args),
                                  operand_dtype=torch.float32)
    ref = jax_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_bf16_matches_jax_bf16(shape):
    # Both sides round the same fp32 GN+SiLU values to bf16; where the two
    # fp32 values differ by an ulp across a bf16 rounding boundary, one
    # product moves by |w| * 2^-8 |h| (~1e-3 at most here). Against the
    # fp32 reference the bf16 error is ~10x larger, which the last check
    # shows is what bf16 rounding does.
    args = _inputs(*shape)
    ours = gn_silu_conv_reference(*(torch.from_numpy(a) for a in args)).numpy()
    ref = np.asarray(_jax_bf16(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-3)
    fp32 = np.asarray(jax_ref(*(jnp.asarray(a) for a in args)))
    assert np.abs(ours - fp32).max() > 4 * np.abs(ours - ref).max()


def test_cpu_tensor_takes_plain_version():
    args = [torch.from_numpy(a) for a in _inputs(*SHAPES[0])]
    _lib.reset_launches()
    torch.testing.assert_close(gn_silu_conv(*args),
                               gn_silu_conv_reference(*args), rtol=0, atol=0)
    assert not _lib.LAUNCHES


@pytest.mark.parametrize("cin,cout,width,ok", [
    (32, 32, 16, True), (96, 64, 8, True), (512, 256, 4, True),
    (128, 128, 512, True), (48, 64, 8, False), (64, 12, 8, False),
    (128, 128, 513, False), (2048, 256, 8, False)])
def test_gate(cin, cout, width, ok):
    assert fused_conv_available(cin, cout, width) is ok



# bf16 x: the fixture net's shapes and the full-width 4x4 map, which the
# card sums in 4 slices (the plain version has none)
BF16_SHAPES = SHAPES + [(2, 4, 256, 256)]


def _jax_tpu_body_bf16(x, gs, gb, k, b):
    """``_kernel`` (``conv_fused.py:36-73``) on bf16 x, composed in JAX: x
    widened to fp32, one-pass fp32 GroupNorm statistics (var = E[x^2] -
    mean^2), GN and SiLU in fp32, h rounded to bf16, bf16 products summed in
    fp32, the fp32 bias, the output rounded to bf16."""
    old = os.environ.get("DXMI_GN_STATS")
    os.environ["DXMI_GN_STATS"] = "onepass"
    try:
        h = jax_gn(x.astype(jnp.float32), gs, gb, 32, 1e-6, True)
    finally:
        if old is None:
            del os.environ["DXMI_GN_STATS"]
        else:
            os.environ["DXMI_GN_STATS"] = old
    out = jax.lax.conv_general_dilated(
        h.astype(jnp.bfloat16), k.astype(jnp.bfloat16), (1, 1),
        ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    return (out + b).astype(jnp.bfloat16)


def _bf16_ulp(a):
    """One bf16 ulp of |a| (8 significant bits)."""
    return np.ldexp(1.0, np.frexp(np.maximum(np.abs(a), 2.0 ** -126))[1] - 8)


@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_plain_bf16_x_matches_tpu_body(shape):
    """bf16 in, bf16 out: within 2e-3 (the operand flips of
    test_plain_bf16_matches_jax_bf16: both take one-pass fp32 statistics,
    in different summation orders) plus one bf16 ulp of |out| (the output's
    one rounding, which such a flip can move across a boundary)."""
    x, *rest = _inputs(*shape)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(_jax_tpu_body_bf16(xb, *(jnp.asarray(a) for a in rest))
                     .astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16()
    ours = gn_silu_conv_reference(xt, *(torch.from_numpy(a) for a in rest))
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    lim = 2e-3 + _bf16_ulp(np.maximum(np.abs(ours), np.abs(ref)))
    assert (np.abs(ours - ref) <= lim).all(), np.abs(ours - ref).max()
    # the fp32 form on the widened x (two-pass statistics) rounds to it but
    # where the statistics' fp32 rounding moves h across a bf16 boundary
    wide = gn_silu_conv_reference(xt.float(),
                                  *(torch.from_numpy(a) for a in rest))
    wide = wide.bfloat16().float().numpy()
    assert (np.abs(wide - ours) <= lim).all(), np.abs(wide - ours).max()


@pytest.mark.parametrize("shape", SHAPES[:2] + [(2, 4, 256, 256)])
def test_bf16_x_gradient_is_the_fp32_vjp(shape):
    """The backward on bf16 x is the vjp of the JAX package's fp32
    ``gn_silu_conv_reference`` at x widened to fp32 and an fp32 cotangent
    (what ``_fgsc_bwd`` computes for fp32 x): the parameters' gradients
    fp32 within 1e-5 of their largest, x's rounded once to bf16 (within one
    bf16 ulp of JAX's, rounded)."""
    x, *rest = _inputs(*shape)
    rs = np.random.RandomState(9)
    B, R, _, Cout = shape
    ct = np.asarray(jnp.asarray(rs.randn(B, R, R, Cout).astype(np.float32))
                    .astype(jnp.bfloat16).astype(jnp.float32))
    xw = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    _, vjp = jax.vjp(lambda *a: jax_ref(*a, num_groups=32, eps=1e-6),
                     jnp.asarray(xw), *(jnp.asarray(a) for a in rest))
    want = [np.asarray(g) for g in vjp(jnp.asarray(ct))]
    ins = [torch.from_numpy(xw).bfloat16().requires_grad_(True)] + [
        torch.from_numpy(a).requires_grad_(True) for a in rest]
    y = gn_silu_conv(*ins)
    assert y.dtype == torch.bfloat16
    y.backward(torch.from_numpy(ct).bfloat16())
    dx = ins[0].grad
    assert dx.dtype == torch.bfloat16
    dxw = np.asarray(jnp.asarray(want[0]).astype(jnp.bfloat16)
                     .astype(jnp.float32))
    # plus 1e-5 of the largest, the fp32 summation order where a gradient
    # element is a cancellation
    lim = _bf16_ulp(dxw) + 1e-5 * np.abs(dxw).max()
    assert (np.abs(dx.float().numpy() - dxw) <= lim).all()
    for t, w in zip(ins[1:], want[1:]):
        assert t.grad.dtype == torch.float32
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_jax_backward_raises_on_bf16_x():
    """The JAX package's own K3 backward cannot run on bf16 x: ``_fgsc_bwd``
    hands the vjp of a reference whose output is bf16 an fp32 cotangent
    (ROADMAP.md §3, a known difference; the port's backward above is the
    fp32 vjp it means)."""
    x, *rest = _inputs(*SHAPES[0])
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    args = [jnp.asarray(a) for a in rest]

    def loss(xx):
        return jnp.sum(fused_gn_silu_conv(xx, *args, 32, 1e-6)
                       .astype(jnp.float32))

    with pytest.raises((ValueError, TypeError), match="float32"):
        jax.grad(loss)(xb)
