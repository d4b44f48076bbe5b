"""The port's UNetSmall against dxmi_tpu's on the same weights: numpy-made
reference-layout weights go through ``dxmi_tpu.utils.convert`` to the JAX
model and back through ``dxmi_tpu_torch.utils.convert`` to the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dxmi_tpu.models.unet_small import UNetSmall as JaxUNetSmall
from dxmi_tpu.utils.convert import convert_unet_small
from dxmi_tpu_torch import config
from dxmi_tpu_torch.models import unet_small as port
from dxmi_tpu_torch.utils.convert import (unet_small_from_flax,
                                          var_sampler_from_flax)

SMALL = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
             resolution=16, dropout=0.1)


def _numpy_state(seed=0):
    """Reference-layout weights for SMALL from a numpy seed: GroupNorm
    scales near 1, biases ~0.1, weights ~N(0, 1/fan_in)."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, v in port.UNetSmall(**SMALL).state_dict().items():
        shape = tuple(v.shape)
        if len(shape) == 1:
            base = 1.0 if ("norm" in k and k.endswith("weight")) else 0.0
            a = base + 0.1 * rs.randn(*shape)
        else:
            a = rs.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        out[k] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def weights():
    state = _numpy_state()
    return state, convert_unet_small(state)["params"]


def _inputs(seed=1):
    rs = np.random.RandomState(seed)
    return (rs.randn(2, 16, 16, 3).astype(np.float32),
            np.array([3.5, 761.2], np.float32))


# fp32 paths at 1e-4. With fuse_gn_conv=True the port rounds the conv
# operands to bf16 (as the kernel does) while dxmi_tpu on the CPU runs its
# fp32 reference composition, so that case is held at a bf16 tolerance.
@pytest.mark.parametrize("fuse,attn_impl,tol", [(False, "einsum", 1e-4),
                                                (False, "fused", 1e-4),
                                                (True, "fused", 3e-2)])
def test_forward_matches_jax(weights, fuse, attn_impl, tol):
    state, params = weights
    x, t = _inputs()
    ref = JaxUNetSmall(**SMALL, fuse_gn_conv=fuse, attn_impl=attn_impl).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(t))
    net = port.UNetSmall(**SMALL, fuse_gn_conv=fuse, attn_impl=attn_impl)
    net.load_state_dict(unet_small_from_flax(params))
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2),
                         torch.from_numpy(t))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=tol, atol=tol)


def test_convert_roundtrip(weights):
    state, params = weights
    back = unet_small_from_flax({"params": params})
    assert set(back) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    again = convert_unet_small({k: v.numpy() for k, v in back.items()})
    sampler_state = var_sampler_from_flax(
        {"net": again["params"], "log_betas": np.zeros(10, np.float32)})
    assert set(sampler_state) == {f"net.{k}" for k in state} | {"log_betas"}


def test_full_width_launch_table(monkeypatch):
    """One forward of the full-width CIFAR-10 network calls each kernel's
    wrapper as often as chip_smoke.LAUNCHES_PER_FORWARD says."""
    calls = {k: 0 for k in chip_smoke.LAUNCHES_PER_FORWARD}
    for attr, name in (("group_norm", "gn_silu"),
                       ("gn_silu_conv", "gn_silu_conv3x3"),
                       ("attn_block", "attn_block")):
        fn = getattr(port, attr)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(port, attr, counted)
    torch.manual_seed(0)
    net = config.instantiate(chip_smoke.cifar10_t10()["sampler_net"]).eval()
    with torch.no_grad():
        out = net(torch.randn(1, 3, 32, 32), torch.tensor([500.0]))
    assert out.shape == (1, 3, 32, 32) and torch.isfinite(out).all()
    assert calls == chip_smoke.LAUNCHES_PER_FORWARD
