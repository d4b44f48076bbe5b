"""K2 (the attention block, fp32): the port's plain version against
dxmi_tpu's Pallas kernel in interpret mode and against its
``attn_block_reference`` on the CPU (2e-5, as tests/test_attn_block.py
holds the kernel), and the CUDA kernels against the plain version on the
card (tests/test_torch_kernels_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxmi_tpu.ops.attn_block import attn_block_reference as jax_ref
from dxmi_tpu.ops.attn_block import fused_attn_block
from dxmi_tpu_torch.ops import _lib
from dxmi_tpu_torch.ops.attn_block import (attn_block, attn_block_reference,
                                           fused_attn_available)


def _inputs(B, S, C, seed=0):
    rs = np.random.RandomState(seed)
    return ((rs.randn(B, S, C) * 2 + 0.5).astype(np.float32),
            (1 + 0.1 * rs.randn(C)).astype(np.float32),
            (0.1 * rs.randn(C)).astype(np.float32),
            (rs.randn(C, 3 * C) / np.sqrt(C)).astype(np.float32),
            (0.1 * rs.randn(3 * C)).astype(np.float32),
            (rs.randn(C, C) / np.sqrt(C)).astype(np.float32),
            (0.1 * rs.randn(C)).astype(np.float32))


def _ours(args, nh, eps):
    return attn_block_reference(*(torch.from_numpy(a) for a in args),
                                num_heads=nh, eps=eps).numpy()


def test_plain_matches_pallas_kernel_interpret():
    args = _inputs(2, 64, 64)
    ref = fused_attn_block(*(jnp.asarray(a) for a in args), num_heads=1,
                           eps=1e-6, interpret=True)
    np.testing.assert_allclose(_ours(args, 1, 1e-6), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("nh", [1, 2])
def test_plain_matches_jax_reference(nh):
    args = _inputs(2, 64, 64, seed=1)
    ref = jax_ref(*(jnp.asarray(a) for a in args), num_heads=nh, eps=1e-6)
    np.testing.assert_allclose(_ours(args, nh, 1e-6), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_cpu_tensor_takes_plain_version():
    args = [torch.from_numpy(a) for a in _inputs(1, 64, 64)]
    _lib.reset_launches()
    torch.testing.assert_close(attn_block(*args, num_heads=1),
                               attn_block_reference(*args, num_heads=1),
                               rtol=0, atol=0)
    assert not _lib.LAUNCHES


@pytest.mark.parametrize("S,C,nh,ok", [(256, 256, 1, True), (64, 64, 1, True),
                                       (16, 256, 1, False), (96, 64, 1, False),
                                       (64, 512, 1, False), (64, 512, 2, True),
                                       (64, 48, 1, False),
                                       (64, 2048, 8, False)])
def test_gate(S, C, nh, ok):
    assert fused_attn_available(S, C, nh) is ok

