"""K1's gradient: the port's ``group_norm`` (``GroupNormFn``: the forward is
K1, the backward differentiates the plain version recomputed from the saved
inputs) against ``jax.grad`` of ``dxmi_tpu.ops.groupnorm.fused_group_norm``
(whose ``_bwd`` does the same, ``groupnorm.py:252-264``), in both statistics
modes the training CLI takes (``--gn_stats``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxmi_tpu.ops.groupnorm import fused_group_norm
from dxmi_tpu_torch.ops import _lib
from dxmi_tpu_torch.ops.groupnorm import group_norm

SHAPES = [(2, 8, 8, 64), (2, 4, 4, 96)]


def _case(shape, seed):
    rs = np.random.RandomState(seed)
    C = shape[-1]
    return ((rs.randn(*shape) * 2 + 0.5).astype(np.float32),
            (1 + 0.1 * rs.randn(C)).astype(np.float32),
            (0.1 * rs.randn(C)).astype(np.float32),
            rs.randn(*shape).astype(np.float32))


def _jax(case, silu, dtype, monkeypatch, stats):
    monkeypatch.setenv("DXMI_GN_STATS", stats)
    x, s, b, g = case
    _, vjp = jax.vjp(lambda x_, s_, b_: fused_group_norm(x_, s_, b_, 32, 1e-5,
                                                         silu),
                     jnp.asarray(x).astype(dtype), jnp.asarray(s),
                     jnp.asarray(b))
    return [np.asarray(t, np.float32)
            for t in vjp(jnp.asarray(g).astype(dtype))]


def _port(case, silu, dtype, stats):
    x, s, b, g = (torch.from_numpy(a) for a in case)
    x = x.to(dtype).requires_grad_(True)
    s, b = s.requires_grad_(True), b.requires_grad_(True)
    y = group_norm(x, s, b, 32, 1e-5, silu, stats)
    return [t.float().numpy()
            for t in torch.autograd.grad(y, (x, s, b), g.to(dtype))]


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_grad_matches_jax_fp32(monkeypatch, shape, silu):
    """fp32 statistics, fp32 tensors: the JAX package's fp32 limits
    (1e-5 relative and absolute, as the forward test)."""
    case = _case(shape, 1)
    for a, b in zip(_port(case, silu, torch.float32, "fp32"),
                    _jax(case, silu, jnp.float32, monkeypatch, "fp32")):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stats", ["fp32", "bf16_onepass"])
@pytest.mark.parametrize("silu", [False, True])
def test_grad_matches_jax_bf16(monkeypatch, stats, silu):
    """bf16 tensors, both statistics modes: the same graph of bf16
    operations, differing where the two frameworks' kernels round a value
    the other way; mean relative error below the JAX package's 3e-2 bf16
    class (tests/test_groupnorm.py)."""
    case = _case(SHAPES[0], 2)
    for a, b in zip(_port(case, silu, torch.bfloat16, stats),
                    _jax(case, silu, jnp.bfloat16, monkeypatch, stats)):
        assert np.abs(a - b).mean() / np.abs(b).mean() < 3e-2


def test_cpu_backward_launches_nothing():
    case = _case(SHAPES[0], 3)
    _lib.reset_launches()
    _port(case, True, torch.float32, "fp32")
    assert not _lib.LAUNCHES
