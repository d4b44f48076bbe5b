"""The port's ``UNetSmallEncoder`` (the anomaly entry's time-dependent
value) against ``dxmi_tpu``'s on numpy-made weights through
``module_from_flax``: the plain switches and fused attention at 1e-5, K3's
switch at its bf16-operand limit; the routes against the JAX gates,
including K3 at one channel a group; and the launch tables of
train_anomaly's nets at full width that ``chip_smoke`` (E11) checks on the
card."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "torch_fixtures"))

import chip_smoke  # noqa: E402
from trainer_cases import seeded_params  # noqa: E402

from dxmi_tpu.models.unet_small import UNetSmallEncoder as JEnc  # noqa: E402
from dxmi_tpu.ops.attn_block import fused_attn_available as jax_gate  # noqa
from dxmi_tpu_torch.models import unet_small as port  # noqa: E402
from dxmi_tpu_torch.ops.conv_fused import fused_conv_available  # noqa: E402
from dxmi_tpu_torch.utils.convert import module_from_flax  # noqa: E402
from dxmi_tpu_torch.utils.train_state import flax_tree  # noqa: E402

SMALL = dict(ch=32, out_ch=1, ch_mult=(1, 2), num_res_blocks=1,
             attn_resolutions=(16,), dropout=0.0, resolution=16)


@pytest.fixture(scope="module")
def weights():
    x = jnp.zeros((1, 16, 16, 3))
    t = jnp.zeros((1,), jnp.float32)
    return jax.tree.map(np.asarray, seeded_params(
        JEnc(**SMALL), (x, t), np.random.RandomState(0)))


def _inputs(seed=1):
    rs = np.random.RandomState(seed)
    return (rs.randn(3, 16, 16, 3).astype(np.float32),
            np.array([0, 3, 9]))


# fp32 at 1e-5 of the output's scale; with K3 the port rounds the conv
# operands to bf16 (as the kernel does) while dxmi_tpu on the CPU runs its
# fp32 composition: that case is held at the bf16 limit of UNetSmall's test
@pytest.mark.parametrize("fuse,attn_impl,tol", [(False, "einsum", 1e-5),
                                                (False, "fused", 1e-5),
                                                (True, "fused", 3e-2)])
def test_forward_matches_jax(weights, fuse, attn_impl, tol):
    x, t = _inputs()
    ref = np.asarray(JEnc(**SMALL, fuse_gn_conv=fuse,
                          attn_impl=attn_impl).apply({"params": weights},
                                                     jnp.asarray(x),
                                                     jnp.asarray(t)))
    net = port.UNetSmallEncoder(**SMALL, fuse_gn_conv=fuse,
                                attn_impl=attn_impl)
    net.load_state_dict(module_from_flax(net, weights))
    with torch.no_grad():
        out = net(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(t)).numpy()
    assert out.shape == ref.shape == (3, 1)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1.0))


def test_flax_names_both_ways(weights):
    """module_from_flax and flax_tree invert each other on the encoder's
    tree (UNetSmall's names plus ``out_norm`` and ``out_conv``)."""
    net = port.UNetSmallEncoder(**SMALL)
    net.load_state_dict(module_from_flax(net, weights))
    back = flax_tree(net)
    flat = jax.tree_util.tree_flatten_with_path(weights)[0]
    assert len(flat) == len(list(net.parameters()))
    for path, a in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, a)


def test_gradient_through_the_fused_switches(weights):
    """The value trains through K3's and K2's autograd (the plain fp32
    vjp): the input gradient within the bf16-operand limit of the plain
    switches'."""
    x, t = _inputs(2)
    grads = []
    for fuse, impl in ((False, "einsum"), (True, "fused")):
        net = port.UNetSmallEncoder(**SMALL, fuse_gn_conv=fuse,
                                    attn_impl=impl)
        net.load_state_dict(module_from_flax(net, weights))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
        net(xt, torch.from_numpy(t)).sum().backward()
        grads.append(xt.grad)
    err = (grads[0] - grads[1]).norm() / grads[0].norm()
    assert float(err) < 3e-2


def test_routes_are_the_jax_gates(monkeypatch):
    """At train_anomaly's full width every attention block of the policy
    and the value goes through K2 exactly where the JAX gate admits it, and
    every GN+conv pair through K3 (the value's 64x64 level at one channel a
    group); the calls per forward are chip_smoke's tables."""
    monkeypatch.setenv("DXMI_FUSED_ATTN_FORCE", "1")  # the gate off-TPU
    counts = chip_smoke.anomaly_shapes()
    for tag, seen in counts.items():
        for key in seen:
            if key[0] == "attn":
                assert jax_gate(key[1], key[2], 1), key
            if key[0] == "conv":
                assert fused_conv_available(key[3], key[4], key[2]), key
    by_kind = {tag: {k: sum(n for key, n in seen.items() if key[0] == k)
                     for k in ("gn", "conv", "attn")}
               for tag, seen in counts.items()}
    names = {"gn": "gn_silu", "conv": "gn_silu_conv3x3",
             "attn": "attn_block"}
    for tag, table in (("policy", chip_smoke.ANOMALY_POLICY_LAUNCHES),
                       ("value", chip_smoke.ANOMALY_VALUE_LAUNCHES)):
        got = {names[k]: n for k, n in by_kind[tag].items() if n}
        assert got == table, (tag, got)
    value = counts["value"]
    assert value[("conv", 64, 64, 32, 32)] == 2  # one channel a group
    B, S, C = chip_smoke.ANOMALY_K2["attn_block_anomaly"]
    assert value[("attn", S, C)] == 1


def test_encoder_asserts_its_resolution():
    net = port.UNetSmallEncoder(**SMALL)
    with pytest.raises(ValueError, match="resolution"):
        net(torch.zeros(1, 3, 8, 8), torch.zeros(1))
