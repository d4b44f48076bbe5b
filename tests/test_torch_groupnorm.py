"""K1 (GroupNorm(+SiLU)): the port's plain version against dxmi_tpu's
``group_norm_silu_reference`` on the CPU, and the CUDA kernel against the
plain version on the card (tests/test_torch_kernels_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxmi_tpu.ops.groupnorm import group_norm_silu_reference as jax_gn
from dxmi_tpu_torch.ops import _lib
from dxmi_tpu_torch.ops.groupnorm import group_norm, group_norm_silu_reference

SHAPES = [(2, 8, 8, 64), (3, 4, 4, 96), (2, 16, 16, 32), (2, 64, 128)]


def _inputs(shape, seed=0):
    rs = np.random.RandomState(seed)
    C = shape[-1]
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(C)).astype(np.float32)
    bias = (0.1 * rs.randn(C)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax(shape, silu):
    x, s, b = _inputs(shape)
    ours = group_norm_silu_reference(torch.from_numpy(x), torch.from_numpy(s),
                                     torch.from_numpy(b), 32, 1e-6, silu)
    ref = jax_gn(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 32, 1e-6, silu)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_cpu_tensor_takes_plain_version():
    x, s, b = (torch.from_numpy(a) for a in _inputs(SHAPES[0]))
    _lib.reset_launches()
    out = group_norm(x, s, b, 32, 1e-6, True)
    torch.testing.assert_close(out, group_norm_silu_reference(x, s, b, 32, 1e-6,
                                                              True),
                               rtol=0, atol=0)
    assert not _lib.LAUNCHES



# ---- wide groups, bf16 and the statistics modes (the ADM nets) -----------
# Group widths 6 to 48 channels (ImageNet64: C = 192 ... 1536); bf16 input
# with fp32 affine parameters, eps 1e-5, in both DXMI_GN_STATS modes that
# the generation entry offers. The plain version repeats the JAX
# reference's rounding steps, so the two agree to one bf16 ulp (2^-8
# relative, 2^-7 where a flipped mean or rstd moves a whole group) at the
# rare values where torch's and XLA's fp32 libm results straddle a bf16
# rounding boundary; fp32 input agrees to 1e-5 as above.
WIDE = [(2, 4, 4, 192), (2, 4, 4, 384), (2, 2, 2, 1344), (2, 2, 2, 1536),
        (2, 8, 8, 960), (2, 3, 3, 576)]


@pytest.mark.parametrize("stats", ["fp32", "bf16_onepass"])
@pytest.mark.parametrize("shape", WIDE)
def test_plain_matches_jax_wide_bf16(monkeypatch, shape, stats):
    x, s, b = _inputs(shape, seed=2)
    xb = torch.from_numpy(x).bfloat16()
    ours = group_norm_silu_reference(xb, torch.from_numpy(s),
                                     torch.from_numpy(b), 32, 1e-5, True,
                                     stats)
    assert ours.dtype == torch.bfloat16
    monkeypatch.setenv("DXMI_GN_STATS", stats)
    ref = jax_gn(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                 jnp.asarray(s), jnp.asarray(b), 32, 1e-5, True)
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=2 ** -7,
                               atol=2 ** -7)
    # almost every element is bit-equal
    assert np.mean(ours.float().numpy() != ref) < 0.02


@pytest.mark.parametrize("silu", [False, True])
def test_plain_matches_jax_onepass_fp32(monkeypatch, silu):
    x, s, b = _inputs((2, 4, 4, 1536), seed=3)
    ours = group_norm_silu_reference(*(torch.from_numpy(a) for a in (x, s, b)),
                                     32, 1e-5, silu, "bf16_onepass")
    monkeypatch.setenv("DXMI_GN_STATS", "bf16_onepass")
    ref = jax_gn(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 32, 1e-5,
                 silu)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_wide_cpu_tensor_takes_plain_version():
    x, s, b = (torch.from_numpy(a) for a in _inputs((2, 4, 4, 1536)))
    _lib.reset_launches()
    out = group_norm(x.bfloat16(), s, b, 32, 1e-5, True, "bf16_onepass")
    torch.testing.assert_close(
        out, group_norm_silu_reference(x.bfloat16(), s, b, 32, 1e-5, True,
                                       "bf16_onepass"), rtol=0, atol=0)
    assert not _lib.LAUNCHES
    with pytest.raises(ValueError):
        group_norm(x, s, b, 32, 1e-5, True, "bf16")
