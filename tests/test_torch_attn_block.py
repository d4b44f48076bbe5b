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
from dxmi_tpu.ops.attn_block import \
    fused_attn_available as jax_fused_attn_available
from dxmi_tpu_torch.ops.attn_block import (attn_block, attn_block_reference,
                                           fused_attn_available, kernel_takes)


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



# ---- bf16, multi-head (the ADM nets) --------------------------------------
# The plain version follows the TPU kernel's bf16 arithmetic; held against the
# Pallas kernel in interpret mode with the max-subtracting softmax and with
# DXMI_FUSED_NOMAX=1 (the JAX generation entry's setting, exact math), at
# the JAX package's own bf16 criterion (tests/test_attn_block.py:103: mean
# relative error below 2e-2) and at a max abs error of 2^-5 (a few bf16
# ulps of the |y| ~ 2-4 outputs: the TPU body's one-pass fp32 statistics
# and its order of sums can flip a rounding of h, q, k, v or a).

def _inputs_bf16(B, S, C, seed):
    x, gs, gb, wq, bq, wp, bp = _inputs(B, S, C, seed)
    return (x.astype(jnp.bfloat16), gs, gb, *(a.astype(jnp.bfloat16)
                                              for a in (wq, bq, wp, bp)))


def _torch_bf16(args):
    return [torch.from_numpy(np.asarray(a.astype(jnp.float32))).bfloat16()
            if a.dtype == jnp.bfloat16 else torch.from_numpy(np.asarray(a))
            for a in args]


@pytest.mark.parametrize("nomax", ["0", "1"])
@pytest.mark.parametrize("C,nh", [(128, 2), (256, 4), (256, 1)])
def test_plain_bf16_matches_pallas_kernel_interpret(monkeypatch, C, nh, nomax):
    """The bf16 plain version against the TPU kernel's body; (256, 1) is
    the CIFAR-10 nets' single head of d = 256, whose attention runs K7's
    launch on the card."""
    args = _inputs_bf16(2, 64, C, seed=3)
    monkeypatch.setenv("DXMI_FUSED_NOMAX", nomax)
    ref = np.asarray(fused_attn_block(*(jnp.asarray(a) for a in args),
                                      num_heads=nh, interpret=True)
                     .astype(jnp.float32))
    ours = attn_block_reference(*_torch_bf16(args), num_heads=nh)
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    err = np.abs(ours - ref)
    assert err.mean() / np.abs(ref).mean() < 2e-2
    assert err.max() <= 2 ** -5, err.max()
    assert np.mean(err == 0) > 0.9


@pytest.mark.parametrize("S,C,nh,ok", [(1024, 384, 6, True),
                                       (256, 576, 9, True),
                                       (64, 768, 12, True),
                                       (64, 1024, 16, False),
                                       (1024, 768, 12, False),
                                       (256, 256, 1, True)])
def test_gate_bf16(monkeypatch, S, C, nh, ok):
    """The ImageNet64 maps pass; LSUN's C=1024 maps and S*C above 1024*512
    fail; the gate is the JAX gate (forced past its backend test) and does
    not look at the dtype, so d=256 passes it in bf16 too."""
    monkeypatch.setenv("DXMI_FUSED_ATTN_FORCE", "1")
    assert fused_attn_available(S, C, nh) is ok
    assert jax_fused_attn_available(S, C, nh) is ok


@pytest.mark.parametrize("C,nh,dtype,ok", [(384, 6, torch.bfloat16, True),
                                           (256, 1, torch.bfloat16, True),
                                           (512, 2, torch.bfloat16, False),
                                           (288, 1, torch.bfloat16, False),
                                           (96, 2, torch.bfloat16, True),
                                           (64, 8, torch.bfloat16, True),
                                           (256, 1, torch.float32, True),
                                           (64, 8, torch.float32, False),
                                           (384, 6, torch.float16, False)])
def test_kernel_takes(C, nh, dtype, ok):
    """bf16: d <= 128, or one head of d <= 256 (K2 and K7; K5 keeps d <=
    128, its core is K4's); fp32: d % 16 == 0."""
    assert kernel_takes(C, nh, dtype) is ok
    if dtype == torch.bfloat16:
        assert kernel_takes(C, nh, dtype, int8=True) is (ok and C // nh
                                                         <= 128)


@pytest.mark.parametrize("S,C,nh,dtype,exc", [
    (256, 512, 2, torch.bfloat16, NotImplementedError),
    (64, 64, 8, torch.float32, NotImplementedError),
    (16, 256, 1, torch.float32, ValueError)])
def test_card_tensor_outside_kernel_raises(S, C, nh, dtype, exc):
    """A tensor off the CPU (here on the meta device) never takes the plain
    version: a shape or form the kernel does not take raises."""
    x = torch.empty(1, S, C, dtype=dtype, device="meta")
    gn = torch.empty(C, device="meta")
    w = [torch.empty(shape, dtype=dtype, device="meta")
         for shape in ((C, 3 * C), (3 * C,), (C, C), (C,))]
    _lib.reset_launches()
    with pytest.raises(exc):
        attn_block(x, gn, gn, *w, num_heads=nh)
    assert not _lib.LAUNCHES
