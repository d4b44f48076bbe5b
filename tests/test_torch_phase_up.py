"""conv3x3(nearest_up2(x)) by phase decomposition (the ADM decoders'
``up_impl='phase'``): the port against ``dxmi_tpu.ops.phase_up`` and against
the naive upsample-then-conv, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dxmi_tpu.ops.phase_up import conv3x3_nearest_up2 as jax_phase_up
from dxmi_tpu_torch.ops.phase_up import conv3x3_nearest_up2


def _inputs(B, H, W, cin, cout, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, H, W, cin).astype(np.float32),
            (rs.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32),
            rs.randn(cout).astype(np.float32))


def _ours(x, k, b, dtype=torch.float32):
    out = conv3x3_nearest_up2(torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype),
                              torch.from_numpy(k).permute(3, 2, 0, 1),
                              torch.from_numpy(b), dtype)
    return out.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", [(2, 5, 6, 8, 4), (1, 8, 8, 32, 16)])
def test_matches_jax_fp32(shape):
    x, k, b = _inputs(*shape, seed=0)
    ref = jax_phase_up(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                       jnp.float32)
    np.testing.assert_allclose(_ours(x, k, b), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_matches_upsample_then_conv():
    x, k, b = _inputs(2, 4, 4, 16, 8, seed=1)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ref = F.conv2d(F.interpolate(xt, scale_factor=2.0, mode="nearest"),
                   torch.from_numpy(k).permute(3, 2, 0, 1),
                   torch.from_numpy(b), padding=1).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(_ours(x, k, b), ref, rtol=1e-5, atol=1e-5)


def test_matches_jax_bf16():
    """bf16: tap sums in fp32, rounded once; the convs round their outputs
    and the bias add rounds again, as in XLA (one bf16 ulp, 2^-8
    relative, where the two libraries' conv sums straddle a rounding)."""
    x, k, b = _inputs(2, 4, 4, 32, 16, seed=2)
    xb = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    ref = jax_phase_up(jnp.asarray(xb).astype(jnp.bfloat16), jnp.asarray(k),
                       jnp.asarray(b), jnp.bfloat16)
    np.testing.assert_allclose(_ours(xb, k, b, torch.bfloat16),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2 ** -7)
