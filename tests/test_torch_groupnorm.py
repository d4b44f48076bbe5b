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

