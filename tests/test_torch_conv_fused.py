"""K3 (GN+SiLU+conv3x3): the port's plain version against dxmi_tpu on the
CPU, with fp32 operands (against ``gn_silu_conv_reference``) and with bf16
operands (against the TPU kernel's arithmetic: GN+SiLU in fp32, operands
rounded to bf16, products summed in fp32, fp32 bias); and the CUDA kernel
against the plain version on the card (tests/test_torch_kernels_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

