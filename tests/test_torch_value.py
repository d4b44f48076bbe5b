"""The value nets: the port's ``IGEBMEncoder`` and ``TimeIndependentValue``
against ``dxmi_tpu.models.igebm`` / ``value`` on the ADM fixture's
``value.pth`` (the reference ``IGEBMEncoderV2`` layout, loaded by the port
as it is and by JAX through its converter), the flax -> port converter,
class-conditional FiLM, and the spectral-norm encoder's buffers."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxmi_tpu.models.igebm import IGEBMEncoder as JaxIGEBM
from dxmi_tpu.models.value import TimeIndependentValue as JaxValue
from dxmi_tpu.utils import checkpoint as jax_ckpt
from dxmi_tpu_torch.config import instantiate, load_yaml
from dxmi_tpu_torch.models.igebm import IGEBMEncoder
from dxmi_tpu_torch.models.value import TimeIndependentValue
from dxmi_tpu_torch.utils.checkpoint import load_value_state
from dxmi_tpu_torch.utils.convert import igebm_from_flax, value_from_flax

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "torch_rundir_adm_t10")


def _fixture_value():
    cfg = load_yaml(os.path.join(FIXTURE, "config.yaml"))
    value = instantiate(cfg["value"])
    value.load_state_dict(load_value_state(os.path.join(FIXTURE,
                                                        "value.pth")))
    return cfg, value


def test_fixture_value_matches_jax():
    """The reference value.pth in both frameworks, on images and labels:
    fp32 within 1e-5 relative of the output's scale (3e-7 measured)."""
    cfg, value = _fixture_value()
    ckpt, _ = jax_ckpt.load_run_checkpoint(FIXTURE, "value", "last",
                                           torch_kind="value")
    vcfg = {k: v for k, v in cfg["value"]["net"].items() if k != "_target_"}
    jvalue = JaxValue(net=JaxIGEBM(**vcfg))
    rs = np.random.RandomState(0)
    x = rs.randn(4, 3, 16, 16).astype(np.float32)
    t = np.arange(4)
    y = rs.randint(0, 4, 4)
    ref = np.asarray(jvalue.apply({"params": jax.tree.map(
        jnp.asarray, ckpt["params"])}, jnp.asarray(x.transpose(0, 2, 3, 1)),
        jnp.asarray(t), jnp.asarray(y)))
    with torch.no_grad():
        ours = value(torch.from_numpy(x), torch.from_numpy(t),
                     torch.from_numpy(y)).numpy()
    assert ours.shape == ref.shape == (4, 1)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_flax_params_convert_to_the_reference_layout():
    """value_from_flax inverts dxmi_tpu's convert_igebm + wrap_value_params:
    the fixture's value.pth round-trips to its own keys and values."""
    ckpt, _ = jax_ckpt.load_run_checkpoint(FIXTURE, "value", "last",
                                           torch_kind="value")
    back = value_from_flax(jax.tree.map(np.asarray, ckpt["params"]))
    want = load_value_state(os.path.join(FIXTURE, "value.pth"))
    assert set(back) == set(want)
    for k in want:
        torch.testing.assert_close(back[k], want[k], rtol=0, atol=0, msg=k)


def test_class_conditional_encoder_matches_jax():
    """n_class FiLM blocks (no conv biases, embeddings), keepdim head:
    a JAX init converted with igebm_from_flax gives the same outputs."""
    jnet = JaxIGEBM(in_chan=3, out_chan=2, n_class=5, keepdim=True,
                    avg_pool_dim=2, nh=8, learn_out_scale=False)
    rs = np.random.RandomState(1)
    x = rs.randn(3, 16, 16, 3).astype(np.float32)
    y = np.array([0, 4, 2])
    params = jnet.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(y))
    # move the FiLM embeddings off their (1, 0) init so the test sees them
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 * jax.random.normal(jax.random.key(len(str(p))),
                                                 v.shape)
        if "class_embed" in str(p) else v, params)
    ref = np.asarray(jnet.apply(params, jnp.asarray(x), jnp.asarray(y)))
    net = IGEBMEncoder(in_chan=3, out_chan=2, n_class=5, keepdim=True,
                       avg_pool_dim=2, nh=8)
    net.load_state_dict(igebm_from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        ours = net(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                   torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_spectral_norm_raises():
    """A spectral-norm encoder carries its ``sn_stats`` buffers: a value.pth
    without them is refused by a strict load (the weights alone do not
    define the net's forward)."""
    cfg, value = _fixture_value()
    vcfg = {k: v for k, v in cfg["value"]["net"].items() if k != "_target_"}
    sn = TimeIndependentValue(IGEBMEncoder(**{**vcfg,
                                              "use_spectral_norm": True}))
    with pytest.raises(RuntimeError, match="Missing key"):
        sn.load_state_dict(value.state_dict())


def test_time_is_ignored():
    _, value = _fixture_value()
    x = torch.randn(2, 3, 16, 16)
    with torch.no_grad():
        torch.testing.assert_close(value(x, torch.tensor([0, 1])),
                                   value(x, torch.tensor([9, 3])))
    assert isinstance(value, TimeIndependentValue)


CIFAR_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "fixtures", "torch_rundir_t10")


def test_bf16_torso_matches_jax():
    """``IGEBMEncoder(dtype=bf16)`` (``train_cifar10 --fast_levers``' value
    net) on the CIFAR fixture's value_best.pth (nh 32) against JAX's
    ``dtype=jnp.bfloat16`` module: parameters fp32, the torso in bf16 with
    XLA's roundings (the bias added to the rounded conv, the pool summed in
    order, the slope in bf16), the head in fp32. JAX's own bf16 effect (its
    bf16 output against its fp32 one) sets the limit: the port is within
    half of it of JAX's bf16 output (0.31 of it measured: another fp32 sum
    order in a conv flips a bf16 rounding now and then), and its own bf16
    output is not its fp32 one. The gradient reaches the fp32 parameters."""
    cfg = load_yaml(os.path.join(CIFAR_FIXTURE, "config.yaml"))
    vcfg = {k: v for k, v in cfg["value"]["net"].items() if k != "_target_"}
    ckpt, _ = jax_ckpt.load_run_checkpoint(CIFAR_FIXTURE, "value", "best",
                                           torch_kind="value")
    params = {"params": jax.tree.map(jnp.asarray, ckpt["params"])["net"]}
    x = np.random.RandomState(0).randn(8, 3, 16, 16).astype(np.float32)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    ref = {dt: np.asarray(JaxIGEBM(**vcfg, dtype=dt).apply(params, xj))
           for dt in (jnp.float32, jnp.bfloat16)}
    sd = {k[4:]: v for k, v in load_value_state(
        os.path.join(CIFAR_FIXTURE, "value_best.pth")).items()}
    ours = {}
    for dt in (torch.float32, torch.bfloat16):
        net = IGEBMEncoder(**vcfg, dtype=dt)
        net.load_state_dict(sd)
        out = net(torch.from_numpy(x))
        assert out.dtype == torch.float32
        ours[dt] = out.detach().numpy()
    effect = np.abs(ref[jnp.bfloat16] - ref[jnp.float32]).max()
    assert np.abs(ours[torch.bfloat16] - ref[jnp.bfloat16]).max() \
        < 0.5 * effect
    assert np.abs(ours[torch.bfloat16] - ours[torch.float32]).max() \
        > 0.5 * effect
    np.testing.assert_allclose(ours[torch.float32], ref[jnp.float32],
                               rtol=0, atol=1e-5 * np.abs(ref[jnp.float32])
                               .max())
    out.sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in net.parameters())
