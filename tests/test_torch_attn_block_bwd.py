"""K6 (the attention block's fused backward): the port's plain version
(``attn_block_bwd_reference``) against ``jax.grad`` of
``dxmi_tpu.ops.attn_block.fused_attn_block_train``, whose backward is the
Pallas kernel ``_kernel_bwd`` run in interpret mode on the CPU, at fp32
(the JAX package's own 5e-4 limits, tests/test_attn_block.py:448-466) and
bf16 (its mean-relative-error criterion, :469-490); autograd of the port's
plain forward as a second, looser check; and the ``FusedAttnBlockTrain``
autograd function. The CUDA kernel is held against the plain version on
the card (tests/test_torch_kernels_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxmi_tpu.ops.attn_block import \
    fused_attn_bwd_available as jax_bwd_available
from dxmi_tpu.ops.attn_block import fused_attn_block_train as jax_train
from dxmi_tpu_torch.ops import _lib
from dxmi_tpu_torch.ops.attn_block import (attn_block_bwd,
                                           attn_block_bwd_reference,
                                           attn_block_reference,
                                           fused_attn_block_train,
                                           fused_attn_bwd_available)

NAMES = ("dx", "dgs", "dgb", "dw_qkv", "db_qkv", "dw_proj", "db_proj")


def _case(B, S, C, seed):
    rs = np.random.RandomState(seed)
    return ((rs.randn(B, S, C) * 2 + 0.5).astype(np.float32),
            (1 + 0.1 * rs.randn(C)).astype(np.float32),
            (0.1 * rs.randn(C)).astype(np.float32),
            (rs.randn(C, 3 * C) / np.sqrt(C)).astype(np.float32),
            (0.1 * rs.randn(3 * C)).astype(np.float32),
            (rs.randn(C, C) / np.sqrt(C)).astype(np.float32),
            (0.1 * rs.randn(C)).astype(np.float32),
            rs.randn(B, S, C).astype(np.float32))


def _jax_grads(case, nh, dtype):
    *args, ct = case
    args = [jnp.asarray(a) for a in args]
    args[0] = args[0].astype(dtype)

    def f(*a):
        return jax_train(*a, num_heads=nh, interpret=True)

    _, vjp = jax.vjp(f, *args)
    return [np.asarray(g, np.float32)
            for g in vjp(jnp.asarray(ct).astype(dtype))]


def _port_grads(case, nh, dtype):
    x, gs, gb, wq, bq, wp, _, ct = (torch.from_numpy(a) for a in case)
    out = attn_block_bwd_reference(x.to(dtype), ct.to(dtype), gs, gb,
                                   wq.to(dtype), bq.to(dtype), wp.to(dtype), nh)
    assert out[0].dtype == dtype and all(g.dtype == torch.float32
                                         for g in out[1:])
    return [g.float().numpy() for g in out]


def test_plain_matches_pallas_bwd_fp32():
    case = _case(2, 256, 128, seed=7)
    for name, ours, ref in zip(NAMES, _port_grads(case, 2, torch.float32),
                               _jax_grads(case, 2, jnp.float32)):
        np.testing.assert_allclose(ours, ref, rtol=5e-4, atol=5e-4,
                                   err_msg=name)


def test_plain_matches_pallas_bwd_bf16():
    """The same bf16 roundings: mean relative error per cotangent below the
    JAX package's 3e-2 (its bf16 backward against fp32)."""
    case = _case(2, 128, 64, seed=8)
    for name, ours, ref in zip(NAMES, _port_grads(case, 2, torch.bfloat16),
                               _jax_grads(case, 2, jnp.bfloat16)):
        rel = np.abs(ours - ref).mean() / (np.abs(ref).mean() + 1e-8)
        assert rel < 3e-2, (name, rel)


def test_plain_matches_autograd_of_plain_forward():
    """The plain backward against autograd of the port's fp32 forward
    (whose GroupNorm statistics are two-pass and whose softmax is torch's):
    the JAX package's fp32 limits."""
    x, gs, gb, wq, bq, wp, bp, ct = (torch.from_numpy(a)
                                     for a in _case(2, 64, 64, seed=9))
    params = [t.clone().requires_grad_(True) for t in (x, gs, gb, wq, bq, wp,
                                                        bp)]
    y = attn_block_reference(*params, num_heads=2)
    want = torch.autograd.grad(y, params, ct)
    got = attn_block_bwd_reference(x, ct, gs, gb, wq, bq, wp, 2)
    for name, a, b in zip(NAMES, got, want):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-4, msg=name)


def test_autograd_function_is_the_plain_backward():
    """FusedAttnBlockTrain on the CPU: forward = attn_block (plain), the
    gradients = attn_block_bwd_reference (weights passed in fp32 as the
    model's master parameters; bf16 x); no kernel launches."""
    x, gs, gb, wq, bq, wp, bp, ct = (torch.from_numpy(a)
                                     for a in _case(2, 64, 64, seed=10))
    x, ct = x.bfloat16(), ct.bfloat16()
    params = [t.clone().requires_grad_(True) for t in (x, gs, gb, wq, bq, wp,
                                                        bp)]
    _lib.reset_launches()
    y = fused_attn_block_train(*params, num_heads=2)
    grads = torch.autograd.grad(y, params, ct)
    assert not _lib.LAUNCHES
    torch.testing.assert_close(y, attn_block_reference(
        x, gs, gb, wq.bfloat16(), bq.bfloat16(), wp.bfloat16(),
        bp.bfloat16(), num_heads=2), rtol=0, atol=0)
    want = attn_block_bwd_reference(x, ct, gs, gb, wq.bfloat16(),
                                    bq.bfloat16(), wp.bfloat16(), 2)
    for name, g, w in zip(NAMES, grads, want):
        assert g.dtype == (torch.bfloat16 if name == "dx" else torch.float32)
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
    torch.testing.assert_close(grads[-1], ct.float().sum((0, 1)))


@pytest.mark.parametrize("S,C,nh", [(1024, 384, 6), (256, 576, 9),
                                    (64, 768, 12), (64, 64, 2),
                                    (1024, 512, 8), (256, 1024, 16),
                                    (192, 96, 3)])
def test_gate_is_the_jax_gate(monkeypatch, S, C, nh):
    monkeypatch.setenv("DXMI_FUSED_ATTN_FORCE", "1")
    assert fused_attn_bwd_available(S, C, nh) is jax_bwd_available(S, C, nh)


def test_card_tensor_outside_the_kernel_raises():
    """On a non-CPU tensor (here the meta device) a shape the kernel does
    not take raises rather than running the plain version: d = 128."""
    x = torch.empty(1, 64, 256, device="meta")
    w = torch.empty(256, 768, device="meta")
    with pytest.raises(NotImplementedError):
        attn_block_bwd(x, x, torch.empty(256, device="meta"),
                       torch.empty(256, device="meta"), w,
                       torch.empty(768, device="meta"),
                       torch.empty(256, 256, device="meta"), 2)
