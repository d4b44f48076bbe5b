"""K4's backward (K4-dkv, K4-dq): the port's plain version against
``jax.grad`` of the TPU kernel it replaces, ``dxmi_tpu.ops.attention.
_flash_bnsd`` (JAX's bundled Pallas flash attention with one kv block) in
TPU interpret mode on the CPU (JAX's ``mha_reference`` has no backward, so
it is no oracle here); the ``FlashAttention`` autograd function against
autograd of the plain forward; and the residuals the training forward
saves. The CUDA kernels are held against the plain version on the card
(tests/test_torch_kernels_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dxmi_tpu.ops.attention import _flash_bnsd
from dxmi_tpu_torch.ops import _lib
from dxmi_tpu_torch.ops.attention import (flash_mha, flash_mha_fwd,
                                          flash_mha_reference,
                                          flash_mha_reference_bwd, qkv_of)

SM = 0.125


def _case(B, S, nh, d, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, S, 3, nh, d).astype(np.float32),
            rs.randn(B, S, nh, d).astype(np.float32))


def _jax_grads(qkv, do, dtype):
    """jax.grad of sum(o * do) through _flash_bnsd, (B, S, 3, nh, d)."""
    qkv = jnp.asarray(qkv).astype(dtype)
    do = jnp.asarray(do).astype(dtype)

    def f(qkv):
        q, k, v = (jnp.swapaxes(qkv[:, :, i], 1, 2) for i in range(3))
        o = jnp.swapaxes(_flash_bnsd(q, k, v, SM), 1, 2)
        return jnp.sum(o.astype(jnp.float32) * do.astype(jnp.float32))

    with pltpu.force_tpu_interpret_mode():
        g = jax.grad(f)(qkv)
    return np.asarray(g.astype(jnp.float32))


def _port_grads(qkv, do, dtype):
    qkv = torch.from_numpy(qkv).to(dtype)
    do = torch.from_numpy(do).to(dtype)
    o, lse = flash_mha_fwd(qkv, SM)
    return flash_mha_reference_bwd(qkv, o, lse, do, SM).float().numpy()


@pytest.mark.parametrize("shape", [(2, 512, 2, 64), (1, 1024, 2, 64)])
def test_plain_bwd_matches_jax_grad_fp32(shape):
    """Same algorithm in fp32: the JAX package's fp32 kernel limits
    (2e-5 + 2e-5 relative; 1e-6 measured)."""
    qkv, do = _case(*shape, seed=3)
    np.testing.assert_allclose(_port_grads(qkv, do, torch.float32),
                               _jax_grads(qkv, do, jnp.float32),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 512, 2, 64), (1, 1024, 2, 64)])
def test_plain_bwd_matches_jax_grad_bf16(shape):
    """The same roundings in bf16 (p and ds cast to bf16 before their
    products, each gradient cast once): they differ where exp's last bits
    flip a bf16 rounding, by one ulp of the result or, near zero, by one
    flipped term 2^-8 |p do|. Mean relative error below 2^-8 (8.5e-6
    measured) and elementwise one bf16 ulp of the larger plus 2^-6 of the
    mean magnitude (the worst element 0.006 of the mean beyond its ulp);
    tighter than the JAX package's 3e-2 mean for its bf16 backward."""
    qkv, do = _case(*shape, seed=4)
    ours = _port_grads(qkv, do, torch.bfloat16)
    ref = _jax_grads(qkv, do, jnp.bfloat16)
    err = np.abs(ours - ref)
    assert err.mean() / np.abs(ref).mean() < 2 ** -8
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ours), np.abs(ref))
                                   + 1e-30)) - 7)
    assert (err <= ulp + 2 ** -6 * np.abs(ref).mean()).all()


def test_autograd_matches_plain_forward():
    """FlashAttention on the CPU: gradients of q, k, v (views of one qkv
    tensor) equal autograd through the plain forward to fp32 rounding."""
    qkv, do = _case(2, 256, 2, 32, seed=5)
    do = torch.from_numpy(do)
    a = torch.from_numpy(qkv).requires_grad_(True)
    o = flash_mha(*a.unbind(2), SM)
    ga, = torch.autograd.grad(o, a, do)
    b = torch.from_numpy(qkv).requires_grad_(True)
    gb, = torch.autograd.grad(flash_mha_reference(*b.unbind(2), SM), b, do)
    torch.testing.assert_close(ga, gb, rtol=1e-5, atol=1e-5)


def test_forward_residual_is_logsumexp():
    qkv, _ = _case(1, 256, 2, 32, seed=6)
    qkv = torch.from_numpy(qkv)
    o, lse = flash_mha_fwd(qkv, SM)
    q, k, v = qkv.unbind(2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * SM
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1))
    torch.testing.assert_close(o, flash_mha_reference(q, k, v, SM))


def test_qkv_of_views_share_storage():
    """q, k and v as the model makes them (views of one qkv tensor) reach
    the kernels as that tensor, without a copy; other tensors are
    stacked."""
    t = torch.randn(2, 64, 3, 2, 8)
    q, k, v = t.unbind(2)
    assert qkv_of(q, k, v).data_ptr() == t.data_ptr()
    torch.testing.assert_close(qkv_of(q, k, v), t, rtol=0, atol=0)
    q2 = q.clone()
    got = qkv_of(q2, k, v)
    assert got.data_ptr() != t.data_ptr()
    torch.testing.assert_close(got, t, rtol=0, atol=0)


def test_cpu_backward_launches_nothing():
    qkv, do = _case(1, 512, 2, 64, seed=7)
    a = torch.from_numpy(qkv).bfloat16().requires_grad_(True)
    _lib.reset_launches()
    o = flash_mha(*a.unbind(2), SM)
    o.float().mul(torch.from_numpy(do)).sum().backward()
    assert not _lib.LAUNCHES


def test_card_tensor_fp32_training_raises():
    """The backward kernels take bf16: fp32 off the CPU (here on the meta
    device) raises instead of running the plain version."""
    qkv = torch.empty(1, 512, 3, 2, 64, device="meta")
    with pytest.raises(NotImplementedError):
        flash_mha_fwd(qkv, SM)
