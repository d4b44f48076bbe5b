"""The port's Wide-ResNet value net (configs/lsun/T4_wide.yaml) on the CPU
against dxmi_tpu's: the forward through the converter at small depths and
widths, the full-width WRN-16-10's parameter tree, the config targets, the
TimeIndependentValue wrapper, and value checkpoints carried across (flax
msgpack and the port's own .pth)."""
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dxmi_tpu.models.value import TimeIndependentValue as JaxValue
from dxmi_tpu.models.wideresnet import WideResNet as JaxWideResNet
from dxmi_tpu_torch.config import instantiate, load_yaml
from dxmi_tpu_torch.models.value import TimeIndependentValue
from dxmi_tpu_torch.models.wideresnet import WideResNet
from dxmi_tpu_torch.utils.checkpoint import (load_value_state,
                                             save_run_checkpoint)
from dxmi_tpu_torch.utils.convert import (value_from_flax,
                                          wideresnet_from_flax,
                                          wideresnet_leaf)

# fp32 with another summation order: the fp32 kernels' limit
ATOL = RTOL = 2e-5


def _flax_params(net, size, seed):
    """The JAX net's params with every leaf moved off its init by a seeded
    normal (flax zero-initialises the biases), numpy leaves."""
    params = net.init(jax.random.key(seed), jnp.zeros((1, size, size, 3)))
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rs.randn(*a.shape).astype(np.float32),
        params["params"])


def _x(size, seed=0, n=3):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(
        np.float32)


@pytest.mark.parametrize("depth,widen", [(10, 1), (10, 2), (16, 1)])
def test_forward_matches_flax(depth, widen):
    """Through wideresnet_from_flax, on a 16x16 input: every block kind
    (the width change with its 1x1 shortcut, the stride 2 in conv2 of
    groups 2 and 3, the identity shortcut at depth 16), the fp32 GroupNorm
    of 4 groups at eps 1e-6, the mean over H and W and the Dense head."""
    jnet = JaxWideResNet(depth=depth, widen_factor=widen)
    params = _flax_params(jnet, 16, depth + widen)
    x = _x(16)
    ref = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    net = WideResNet(depth=depth, widen_factor=widen)
    net.load_state_dict(wideresnet_from_flax(params))
    with torch.no_grad():
        out = net(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert out.dtype == torch.float32 and out.shape == (3, 1)
    assert np.abs(ref).mean() > 1e-2
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_full_width_tree_matches_jax():
    """The config's WRN-16-10 (17.1 M weights) on the meta device: the same
    parameter names and shapes as JAX's tree (jax.eval_shape), through the
    converter's name map."""
    cfg = load_yaml(chip_smoke.LSUN_T4_WIDE_CONFIG)["value"]["net"]
    kw = {k: v for k, v in cfg.items() if k != "_target_"}
    shapes = jax.eval_shape(
        lambda: JaxWideResNet(**kw).init(jax.random.key(0),
                                         jnp.zeros((1, 256, 256, 3))))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            shapes["params"])[0]:
        key, axes = wideresnet_leaf([p.key for p in path], leaf.ndim)
        want[key] = tuple(np.array(leaf.shape)[list(axes)]) if axes else \
            tuple(leaf.shape)
    with torch.device("meta"):
        net = instantiate(cfg)
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert got == want
    assert sum(np.prod(s) for s in got.values()) == 17_116_481


@pytest.mark.parametrize("target", ["dxmi_tpu.models.wideresnet.WideResNet",
                                    "models.wideresnet_te.wideresnet."
                                    "Wide_ResNet"])
def test_config_targets(target):
    """Both names of the value net (the JAX package's, and the reference's
    stale path that configs/lsun resolve through the JAX alias table) build
    the port's WideResNet."""
    net = instantiate({"_target_": target, "depth": 10, "widen_factor": 1,
                       "norm": "group4", "num_classes": 1})
    assert isinstance(net, WideResNet)
    assert {"block1_0", "block2_0", "block3_0"} <= {
        n for n, _ in net.named_children()}


def test_value_wrapper_matches_jax_and_ignores_t():
    """TimeIndependentValue over the WRN: NCHW in, (B, 1) fp32 out, equal
    to JAX's wrapper (NHWC) on the same weights, the same for any t."""
    jv = JaxValue(net=JaxWideResNet(depth=10, widen_factor=1))
    x = _x(16, seed=1, n=2)
    t = jnp.zeros((2,), jnp.int32)
    variables = jv.init(jax.random.key(3), jnp.asarray(x), t)
    rs = np.random.RandomState(4)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rs.randn(*a.shape).astype(np.float32),
        variables["params"])
    ref = np.asarray(jv.apply({"params": params}, jnp.asarray(x), t))
    value = instantiate({"_target_": "dxmi_tpu.models.value."
                         "TimeIndependentValue", "net": {
                             "_target_": "dxmi_tpu.models.wideresnet."
                             "WideResNet", "depth": 10, "widen_factor": 1}})
    assert isinstance(value, TimeIndependentValue)
    value.load_state_dict(value_from_flax({"params": params}))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    with torch.no_grad():
        a = value(xt, torch.zeros(2, dtype=torch.long))
        b = value(xt, torch.full((2,), 3, dtype=torch.long))
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_dropout_only_when_not_deterministic():
    """Dropout runs as the JAX module runs it: only with
    deterministic=False, which no caller passes (train mode alone does not
    turn it on)."""
    net = WideResNet(depth=10, widen_factor=1, dropout=0.5).train()
    x = torch.randn(2, 3, 16, 16, generator=torch.Generator().manual_seed(0))
    assert torch.equal(net(x), net(x))
    assert not torch.equal(net(x, deterministic=False),
                           net(x, deterministic=False))


def test_value_checkpoints(tmp_path):
    """A WRN value carried across: a flax msgpack run-dir payload
    ({'params': {'net': ...}, 'meta': ...}) read by the port's own msgpack
    reader, and the port's value_last.pth read back, bit for bit."""
    jv = JaxValue(net=JaxWideResNet(depth=10, widen_factor=1))
    variables = jv.init(jax.random.key(5), jnp.zeros((1, 16, 16, 3)),
                        jnp.zeros((1,), jnp.int32))
    params = jax.tree.map(np.asarray, variables["params"])
    path = tmp_path / "value_last.msgpack"
    path.write_bytes(flax.serialization.msgpack_serialize(
        {"params": params, "meta": {"i_iter": 3}}))
    state = load_value_state(str(path))
    want = value_from_flax({"params": params})
    assert set(state) == set(want) and all(
        torch.equal(state[k], want[k]) for k in want)
    value = instantiate(load_yaml(chip_smoke.LSUN_T4_WIDE_CONFIG)["value"]
                        | {"net": {"_target_": "dxmi_tpu.models.wideresnet."
                                   "WideResNet", "depth": 10,
                                   "widen_factor": 1}})
    value.load_state_dict(state)

    class _Sampler(torch.nn.Module):
        pass

    save_run_checkpoint(str(tmp_path), "last", _Sampler(), value)
    back = load_value_state(os.path.join(tmp_path, "value_last.pth"))
    assert all(torch.equal(back[k], v) for k, v in value.state_dict().items())
