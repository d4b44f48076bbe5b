"""K7 (the batch-blocked attention block) and the autograd of the K2/K7 and
K3 forwards: the port's plain version and its wrapper against dxmi_tpu's
``_kernel_bb`` in interpret mode (the cases of tests/test_attn_block.py:
291-310, at that test's limits), the ``block_b`` clamp against the one
``fused_attn_block`` applies, and the gradients against ``jax.grad`` of the
JAX ops, whose backward is the vjp of their fp32 reference compositions. The
CUDA kernel itself is held to the plain version on the card
(tests/test_torch_kernels_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxmi_tpu.ops import attn_block as jax_attn
from dxmi_tpu.ops.conv_fused import fused_gn_silu_conv
from dxmi_tpu_torch.ops import _lib
from dxmi_tpu_torch.ops.attn_block import (attn_block, attn_block_bb,
                                           attn_block_bb_reference,
                                           attn_block_reference,
                                           resolve_block_b)
from dxmi_tpu_torch.ops.conv_fused import gn_silu_conv


def _inputs(B, S, C, seed=0):
    rs = np.random.RandomState(seed)
    return ((rs.randn(B, S, C) * 2 + 0.5).astype(np.float32),
            (1 + 0.1 * rs.randn(C)).astype(np.float32),
            (0.1 * rs.randn(C)).astype(np.float32),
            (rs.randn(C, 3 * C) / np.sqrt(C)).astype(np.float32),
            (0.02 * rs.randn(3 * C)).astype(np.float32),
            (rs.randn(C, C) / np.sqrt(C)).astype(np.float32),
            (0.02 * rs.randn(C)).astype(np.float32))


def _jax_bb(args, nh, bb, dtype=jnp.float32):
    x, *rest = (jnp.asarray(a) for a in args)
    return np.asarray(jax_attn.fused_attn_block(
        x.astype(dtype), *rest, num_heads=nh, interpret=True, block_b=bb),
        np.float32)


@pytest.mark.parametrize("bb", [2, 3, 4])
def test_plain_and_wrapper_match_kernel_bb_fp32(bb):
    """(B=6, S=128, C=128, nh 2) at 2e-5 + 2e-5 rel: bb=4 does not divide 6
    and is lowered to 3 in both packages."""
    args = _inputs(6, 128, 128, seed=3)
    ref = _jax_bb(args, 2, bb)
    t = [torch.from_numpy(a) for a in args]
    eff = resolve_block_b(6, 128, 128, bb)
    assert eff == min(bb, 3)
    _lib.reset_launches()
    for out in (attn_block(*t, num_heads=2, block_b=bb),
                attn_block_bb(*t, num_heads=2, bb=eff),
                attn_block_bb_reference(*t, num_heads=2, bb=eff)):
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    assert not _lib.LAUNCHES


def test_plain_matches_kernel_bb_bf16():
    """(B=4, S=256, C=128, nh 1) in bf16 at bb 4, under JAX's own 2e-2
    mean-relative limit against the fp32 reference, and against the TPU
    body's own bf16 output."""
    args = _inputs(4, 256, 128, seed=4)
    ref32 = np.asarray(jax_attn.attn_block_reference(
        *(jnp.asarray(a) for a in args), num_heads=1))
    kern = _jax_bb(args, 1, 4, jnp.bfloat16)
    x, *rest = (torch.from_numpy(a) for a in args)
    xb = x.to(torch.bfloat16)
    w = [rest[0], rest[1]] + [r.to(torch.bfloat16) for r in rest[2:]]
    for out in (attn_block(xb, *w, num_heads=1, block_b=4),
                attn_block_bb_reference(xb, *w, num_heads=1, bb=4)):
        out = out.float().numpy()
        err = np.abs(out - ref32).mean() / np.abs(ref32).mean()
        assert err < 2e-2, err
        # the same roundings as the TPU body: equal but for fp32 summation
        # order flipping a bf16 rounding now and then
        assert np.abs(out - kern).mean() / np.abs(kern).mean() < 2e-3


def test_plain_matches_kernel_bb_bf16_d256():
    """The CIFAR-10 nets' bf16 block, one head of d = 256 (B=2, S=256,
    C=256) at bb 2, under the limits above: K7's own form and the one K2
    bf16 runs at d = 256 (its plain version with two-pass statistics)."""
    args = _inputs(2, 256, 256, seed=5)
    ref32 = np.asarray(jax_attn.attn_block_reference(
        *(jnp.asarray(a) for a in args), num_heads=1))
    kern = _jax_bb(args, 1, 2, jnp.bfloat16)
    x, *rest = (torch.from_numpy(a) for a in args)
    xb = x.to(torch.bfloat16)
    w = [rest[0], rest[1]] + [r.to(torch.bfloat16) for r in rest[2:]]
    for out in (attn_block(xb, *w, num_heads=1, block_b=2),
                attn_block(xb, *w, num_heads=1, block_b=1)):
        out = out.float().numpy()
        assert np.abs(out - ref32).mean() / np.abs(ref32).mean() < 2e-2
        assert np.abs(out - kern).mean() / np.abs(kern).mean() < 2e-3


@pytest.mark.parametrize("B,S,C,block_b,env", [
    (6, 128, 128, 4, None), (6, 128, 128, 3, None), (8, 256, 256, 8, None),
    (128, 256, 256, 4, None), (32, 256, 256, None, "4"),
    (100, 256, 256, None, "4"), (8, 256, 576, 4, None),
    (8, 1024, 384, 4, None), (1, 256, 256, 4, None), (7, 64, 64, 4, None),
    (8, 64, 64, None, None), (8, 64, 64, 1, "4"), (12, 256, 256, 0, None)])
def test_block_b_clamp_matches_jax(monkeypatch, B, S, C, block_b, env):
    """resolve_block_b against the batch block fused_attn_block hands its
    kernel (captured at its _make_op): block_b or DXMI_FUSED_ATTN_BB, then
    cap = max(1, 1024*384 // (S C)), bb <= B, lowered until it divides B."""
    if env is None:
        monkeypatch.delenv("DXMI_FUSED_ATTN_BB", raising=False)
    else:
        monkeypatch.setenv("DXMI_FUSED_ATTN_BB", env)
    seen = []

    def capture(nh, eps, interpret, bb=1, nomax=False, avt=0):
        seen.append(bb)
        return lambda *a: None

    monkeypatch.setattr(jax_attn, "_make_op", capture)
    x = jnp.zeros((B, S, C), jnp.float32)
    vec = jnp.zeros((C,), jnp.float32)
    jax_attn.fused_attn_block(x, vec, vec, None, None, None, None,
                              num_heads=1, block_b=block_b)
    assert resolve_block_b(B, S, C, block_b) == max(seen[0], 1)


def _grads_torch(fn, args, ct):
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*t)
    out.backward(torch.from_numpy(ct))
    return out.detach().numpy(), [a.grad.numpy() for a in t]


@pytest.mark.parametrize("bb", [1, 2])
def test_attn_block_grad_matches_jax(bb):
    """attn_block's gradient (the vjp of the fp32 reference, whatever the
    forward's batch block) against jax.grad of fused_attn_block, whose
    custom_vjp does the same: 1e-4 of each cotangent's largest."""
    args = _inputs(4, 64, 64, seed=5)
    ct = np.random.RandomState(6).randn(4, 64, 64).astype(np.float32)
    out, grads = _grads_torch(
        lambda *t: attn_block(*t, num_heads=2, eps=1e-6, block_b=bb), args,
        ct)

    def f(*a):
        y = jax_attn.fused_attn_block(*a, num_heads=2, eps=1e-6,
                                      interpret=True, block_b=bb)
        return (y * ct).sum()

    ref = jax.grad(f, argnums=tuple(range(7)))(
        *(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(out, attn_block_reference(
        *(torch.from_numpy(a) for a in args), num_heads=2,
        eps=1e-6).numpy(), rtol=2e-5, atol=2e-5)
    for g, r in zip(grads, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())


def test_gn_silu_conv_grad_matches_jax():
    """gn_silu_conv's gradient against jax.grad of fused_gn_silu_conv: both
    are the vjp of the fp32 reference composition recomputed from the saved
    inputs, so the bf16 rounding of the port's forward does not reach them
    (1e-4 of each cotangent's largest); the forwards differ by that
    rounding alone."""
    rs = np.random.RandomState(7)
    args = ((rs.randn(2, 8, 8, 64) * 1.5 + 0.3).astype(np.float32),
            (1 + 0.1 * rs.randn(64)).astype(np.float32),
            (0.1 * rs.randn(64)).astype(np.float32),
            (rs.randn(3, 3, 64, 32) / 24).astype(np.float32),
            (0.1 * rs.randn(32)).astype(np.float32))
    ct = rs.randn(2, 8, 8, 32).astype(np.float32)
    out, grads = _grads_torch(lambda *t: gn_silu_conv(*t, 32, 1e-6), args,
                              ct)

    def f(*a):
        return (fused_gn_silu_conv(*a, 32, 1e-6) * ct).sum()

    ref = jax.grad(f, argnums=tuple(range(5)))(
        *(jnp.asarray(a) for a in args))
    y32 = np.asarray(fused_gn_silu_conv(*(jnp.asarray(a) for a in args), 32,
                                        1e-6))
    assert np.abs(out - y32).max() < 3e-2 * np.abs(y32).max()
    for g, r in zip(grads, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())


def test_card_tensor_outside_kernel_raises():
    """On a tensor off the CPU (the meta device) K7 never takes the plain
    version: a batch block that does not divide B, or a form the kernel does
    not take, raises."""
    t = [torch.empty(s, device="meta") for s in
         ((6, 256, 256), (256,), (256,), (256, 768), (768,), (256, 256),
          (256,))]
    with pytest.raises(ValueError):
        attn_block_bb(*t, num_heads=1, bb=4)
    # bf16 at two heads of d = 256 (one head of d = 256 is K7's CIFAR form)
    bf = [torch.empty(s, device="meta", dtype=dt) for s, dt in
          (((6, 256, 512), torch.bfloat16), ((512,), torch.float32),
           ((512,), torch.float32), ((512, 1536), torch.bfloat16),
           ((1536,), torch.bfloat16), ((512, 512), torch.bfloat16),
           ((512,), torch.bfloat16))]
    with pytest.raises(NotImplementedError):
        attn_block_bb(*bf, num_heads=2, bb=2)
