"""K4 (flash attention, forward): the port's plain version against the TPU
kernel it replaces, JAX's bundled Pallas flash attention as
``dxmi_tpu.ops.attention._flash_bnsd`` runs it (one kv block), in TPU
interpret mode on the CPU, and against JAX's ``mha_reference`` at fp32; the
CUDA kernel is held against the plain version on the card
(tests/test_torch_kernels_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference

from dxmi_tpu.ops.attention import _flash_bnsd
from dxmi_tpu.ops.attention import flash_available as jax_flash_available
from dxmi_tpu_torch.ops import _lib
from dxmi_tpu_torch.ops.attention import (flash_available, flash_mha,
                                          flash_mha_reference)


def _qkv(B, S, nh, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, S, nh, d).astype(np.float32) for _ in range(3)]


def test_plain_matches_tpu_kernel_interpret_bf16():
    """Same arithmetic (fp32 logits times sm_scale, normalised fp32 softmax,
    p cast to bf16, fp32 accumulation): the two differ by exp's last bits,
    which can flip a bf16 rounding of p or of the output, one bf16 ulp
    (9.8e-4 at |o| < 0.25 measured; 2^-8 relative plus 2^-10 absolute
    allowed)."""
    q, k, v = (jnp.asarray(a).astype(jnp.bfloat16)
               for a in _qkv(2, 512, 2, 64, seed=0))
    with pltpu.force_tpu_interpret_mode():
        ref = _flash_bnsd(*(jnp.swapaxes(t, 1, 2) for t in (q, k, v)), 0.125)
    ref = np.asarray(jnp.swapaxes(ref, 1, 2).astype(jnp.float32))
    ours = flash_mha_reference(*(torch.from_numpy(np.array(
        t.astype(jnp.float32))).bfloat16() for t in (q, k, v)), 0.125)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=2 ** -8,
                               atol=2 ** -10)


@pytest.mark.parametrize("B,S,nh,d", [(2, 512, 2, 64), (1, 256, 3, 32)])
def test_plain_matches_mha_reference_fp32(B, S, nh, d):
    q, k, v = _qkv(B, S, nh, d, seed=1)
    ref = mha_reference(*(jnp.swapaxes(jnp.asarray(a), 1, 2)
                          for a in (q, k, v)), None, sm_scale=d ** -0.5)
    ref = np.asarray(jnp.swapaxes(ref, 1, 2))
    ours = flash_mha_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                               d ** -0.5).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_cpu_tensor_takes_plain_version():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(1, 512, 2, 64, 2))
    _lib.reset_launches()
    torch.testing.assert_close(flash_mha(q, k, v, 0.125),
                               flash_mha_reference(q, k, v, 0.125),
                               rtol=0, atol=0)
    assert not _lib.LAUNCHES


@pytest.mark.parametrize("S,d", [(1024, 64), (512, 128), (256, 64),
                                 (576, 64), (1024, 160), (640, 36)])
def test_gate_is_the_jax_gate(monkeypatch, S, d):
    """The JAX gate without its backend test."""
    from dxmi_tpu.ops import attention

    monkeypatch.setattr(attention, "_tpu_backend", lambda: True)
    assert flash_available(S, d) is jax_flash_available(S, d)


def test_card_tensor_fp32_raises():
    """K4 takes bf16: fp32 off the CPU (here on the meta device) raises
    instead of running the plain version."""
    q = torch.empty(1, 512, 2, 64, device="meta")
    _lib.reset_launches()
    with pytest.raises(NotImplementedError):
        flash_mha(q, q, q, 0.125)
    assert not _lib.LAUNCHES
