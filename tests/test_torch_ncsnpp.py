"""The port's NCSN++ (``dxmi_tpu_torch.models.ncsnpp``) against dxmi_tpu's,
module by module and whole, on the small net of ``chip_smoke.DDGAN_SMALL``
with the numpy-made weights of ``chip_smoke.ddgan_small_state`` (conv2 and
proj_out non-zero, which flax starts at zero), eagerly on the CPU.

Limits:
- fp32: 2e-5 + 2e-5 rel per element (the fp32 kernels' limit);
- bf16, a module on JAX's own input: it repeats JAX's roundings, so its
  mean error stays within ``MODULE_BF16_SHARE`` (0.25) of JAX's own bf16
  effect (the mean distance of JAX's bf16 output from its fp32 output);
- bf16, the whole net: a bf16 net amplifies single rounding flips, so as
  tests/test_torch_unet_small_bf16.py reads it, within twice JAX's own bf16
  effect of JAX's bf16 output and 1.5 times of its fp32 output;
- static int8 with JAX's calibrated scales: fp32, the G-int8 gates on
  the whole net (a rounding flip under fp32 noise moves the outputs it
  reaches by an int8 level of a later layer) and, block by block on JAX's
  input, a nil median error; bf16 with
  quant_skip_attn, its bf16 int8 rule (2x JAX's own bf16 effect under int8
  of its bf16 int8 output, 1.5x of its fp32 int8 output).
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dxmi_tpu.models import ncsnpp as jmod
from dxmi_tpu_torch.models import ncsnpp as port
from dxmi_tpu_torch.utils.convert import (ncsnpp_from_flax,
                                          ncsnpp_quant_scales_from_flax)
from test_torch_unet_small_int8 import _rel
from torch_fixtures import rebuild_checks

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_fixtures"))
from make_ddgan_golden import ncsnpp_to_flax  # noqa: E402

ATOL = RTOL = 2e-5
MODULE_BF16_SHARE = 0.25
ARGS = jmod.NCSNppArgs(**chip_smoke.DDGAN_SMALL)


@functools.lru_cache(maxsize=None)
def _params():
    return ncsnpp_to_flax(chip_smoke.ddgan_small_state())


def _inputs(seed=1, n=4):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 16, 16, 3).astype(np.float32),
            np.array([3.0, 2.0, 1.0, 0.0], np.float32)[:n],
            rs.randn(n, ARGS.nz).astype(np.float32))


def _t(a):
    """NHWC numpy -> NCHW torch (channels_last)."""
    return torch.from_numpy(np.asarray(a, np.float32)).permute(0, 3, 1, 2)


def _np(y):
    return y.detach().float().permute(0, 2, 3, 1).numpy()


def _port_net(dtype=torch.float32, **kw):
    net = port.NCSNpp(port.NCSNppArgs(**chip_smoke.DDGAN_SMALL), dtype=dtype,
                      **kw)
    missing, unexpected = net.load_state_dict(ncsnpp_from_flax(_params()),
                                              strict=False)
    assert not unexpected and all(k.endswith("act_scale") for k in missing)
    return net.eval()


def test_flax_names_round_trip():
    """The port's parameter names are the flax tree's, at the small width
    and at the full width of NCSNppArgs (47,942,019 parameters, the size of
    the 192 MB msgpack files)."""
    state = chip_smoke.ddgan_small_state()
    back = ncsnpp_from_flax(ncsnpp_to_flax(state))
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    x, t, z = (jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,)),
               jnp.zeros((1, 100)))
    shapes = jax.eval_shape(jmod.NCSNpp().init, jax.random.key(0), x, t, z)
    full = port.NCSNpp()
    want = {k: tuple(v.shape) for k, v in full.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in ncsnpp_from_flax(jax.tree.map(
        lambda a: np.zeros(a.shape, np.float32),
        shapes["params"])).items()}
    assert got == want
    assert sum(p.numel() for p in full.parameters()) == 47_942_019


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("fn", ["fir_downsample", "fir_upsample"])
def test_fir_matches_jax(fn, dtype):
    x = np.random.RandomState(2).randn(2, 8, 8, 32).astype(np.float32)
    ref = np.asarray(getattr(jmod, fn)(jnp.asarray(x, dtype)), np.float32)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    out = _np(getattr(port, fn)(_t(x).to(tdt)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def _module_case(name):
    """(JAX module, port module, its params) for a module of the small
    net; the JAX module is built as NCSNpp builds it."""
    net = _port_net()
    mod = getattr(net, name)
    if isinstance(mod, port.AttnBlockSkip):
        jm = jmod.AttnBlockSkip(True)
    else:
        jm = jmod.ResBlockBigGAN(mod.conv1.out_channels, up=mod.up,
                                 down=mod.down)
    return jm, mod, _params()[name]


def _module_inputs(name, jm, params):
    rs = np.random.RandomState(3)
    cin = (params["norm"]["scale"].shape[0] if "norm" in params
           else params["norm1"]["film"]["kernel"].shape[1] // 2)
    hw = 8 if name.startswith(("mid", "down_1", "up_1")) else 16
    x = rs.randn(2, hw, hw, cin).astype(np.float32)
    temb = rs.randn(2, 4 * ARGS.nf).astype(np.float32)
    zemb = rs.randn(2, ARGS.z_emb_dim).astype(np.float32)
    return x, temb, zemb


def _run_module(jm, mod, params, x, temb, zemb, bf16):
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    jm = jm.clone(dtype=jdt)
    mod.dtype = tdt  # the compute dtype a block casts its shortcut input to
    with torch.no_grad():
        if isinstance(mod, port.AttnBlockSkip):
            ref = jm.apply({"params": params}, jnp.asarray(x))
            out = mod(_t(x))
        else:
            ref = jm.apply({"params": params}, jnp.asarray(x),
                           jnp.asarray(temb, jdt), jnp.asarray(zemb, jdt))
            out = mod(_t(x), torch.from_numpy(temb).to(tdt),
                      torch.from_numpy(zemb).to(tdt))
    return _np(out), np.asarray(ref, np.float32)


@pytest.mark.parametrize("name", ["mid_block_1", "down_1_block_0",
                                  "down_0_downsample", "up_1_upsample",
                                  "up_0_block_0", "mid_attn"],
                         ids=["plain", "shortcut", "down", "up", "concat",
                              "attn"])
def test_module_matches_jax(name):
    """ResBlockBigGAN plain, with a 1x1 shortcut, down, up and on a concat
    input, and AttnBlockSkip (GN through K1's plain version, then products
    and softmax): fp32 per element, bf16 against JAX's own bf16 effect."""
    jm, mod, params = _module_case(name)
    x, temb, zemb = _module_inputs(name, jm, params)
    out, ref = _run_module(jm, mod, params, x, temb, zemb, False)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    out16, ref16 = _run_module(jm, mod, params, x, temb, zemb, True)
    noise = _rel(ref16, ref)
    assert 1e-4 < noise < 5e-2, noise
    assert _rel(out16, ref16) <= MODULE_BF16_SHARE * noise, (
        _rel(out16, ref16), noise)


@pytest.mark.parametrize("affine", [True, False], ids=["GN", "AdaGN"])
def test_group_norms_match_jax(affine):
    """GN (K1's plain version, SiLU off, min(C // 4, 32) groups, eps 1e-6;
    a random affine) and AdaGN (no affine, then the FiLM from z)."""
    rs = np.random.RandomState(4)
    x = rs.randn(2, 8, 8, 96).astype(np.float32)
    if affine:
        p = {"scale": 1 + 0.1 * rs.randn(96), "bias": 0.1 * rs.randn(96)}
        jm, mod = jmod.GN(num_groups=jmod._num_groups(96)), port.GN(96)
        mod.weight.data = torch.tensor(p["scale"], dtype=torch.float32)
        mod.bias.data = torch.tensor(p["bias"], dtype=torch.float32)
        ref = jm.apply({"params": jax.tree.map(jnp.float32, p)},
                       jnp.asarray(x))
        out = mod(_t(x))
    else:
        zemb = rs.randn(2, 32).astype(np.float32)
        k, b = rs.randn(32, 192) / np.sqrt(32), 0.1 * rs.randn(192)
        jm, mod = jmod.AdaGN(), port.AdaGN(96, 32)
        mod.film.weight.data = torch.tensor(k.T, dtype=torch.float32)
        mod.film.bias.data = torch.tensor(b, dtype=torch.float32)
        ref = jm.apply({"params": {"film": {"kernel": jnp.float32(k),
                                            "bias": jnp.float32(b)}}},
                       jnp.asarray(x), jnp.asarray(zemb))
        out = mod(_t(x), torch.from_numpy(zemb))
    assert (mod if affine else mod.gn).num_groups == 24
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def _jax_net(dtype=jnp.float32, **kw):
    return jmod.NCSNpp(config=ARGS, dtype=dtype, **kw)


@functools.lru_cache(maxsize=None)
def _jax_out(dtype_name, quant_int8=False, quant_skip_attn=False):
    """(scales or None, NHWC output) of JAX's small net: with int8, its
    calibrating pass from zero scales on the same inputs, then the forward
    with them."""
    dtype = jnp.bfloat16 if dtype_name == "bf16" else jnp.float32
    net = _jax_net(dtype, quant_int8=quant_int8,
                   quant_skip_attn=quant_skip_attn)
    args = tuple(jnp.asarray(a) for a in _inputs())
    variables = {"params": _params()}
    scales = None
    if quant_int8:
        shapes = jax.eval_shape(net.init, jax.random.key(0), *args)
        zeros = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                             shapes["quant_scales"])
        _, upd = net.apply({**variables, "quant_scales": zeros}, *args,
                           mutable=["quant_scales"])
        scales = variables["quant_scales"] = upd["quant_scales"]
    return scales, np.asarray(net.apply(variables, *args), np.float32)


def _port_out(dtype=torch.float32, scales=None, **kw):
    net = _port_net(dtype, **kw)
    x, t, z = _inputs()
    if scales is not None:
        net.load_state_dict(ncsnpp_quant_scales_from_flax(
            jax.tree.map(np.asarray, scales)), strict=False)
        net.prepare_int8()
    with torch.no_grad():
        out = net(_t(x), torch.from_numpy(t), torch.from_numpy(z))
    assert out.dtype == torch.float32
    return _np(out)


def test_net_matches_jax_fp32():
    _, ref = _jax_out("fp32")
    np.testing.assert_allclose(_port_out(), ref, atol=ATOL, rtol=RTOL)


def test_net_matches_jax_bf16():
    _, ref = _jax_out("bf16")
    _, ref32 = _jax_out("fp32")
    noise = _rel(ref, ref32)
    assert 1e-3 < noise < 6e-2, noise
    out = _port_out(torch.bfloat16)
    assert _rel(out, ref) < 2 * noise
    assert _rel(out, ref32) < 1.5 * noise


def test_net_matches_jax_int8_static_fp32():
    """Static int8 on every ResBlock conv, shortcut and attention 1x1 in
    fp32: the calibrating pass records JAX's scales, and with them the
    output passes the G-int8 gates."""
    scales, ref = _jax_out("fp32", "static")
    net = _port_net(quant_int8="static")
    x, t, z = _inputs()
    with torch.no_grad():
        net.set_calibrating(True)
        net(_t(x), torch.from_numpy(t), torch.from_numpy(z))
        net.set_calibrating(False)
    want = ncsnpp_quant_scales_from_flax(jax.tree.map(np.asarray, scales))
    state = net.state_dict()
    assert set(want) == {k for k in state if k.endswith("act_scale")}
    for k, v in want.items():
        assert (state[k] - v).abs().max() <= 1e-5 * v.abs().max(), k
    out = _port_out(scales=scales, quant_int8="static")
    err, effect = np.abs(out - ref), np.abs(_jax_out("fp32")[1] - ref)
    assert err.mean() / effect.mean() <= chip_smoke.INT8_STEP_RATIO
    assert np.median(err) / np.median(effect) <= chip_smoke.INT8_MEDIAN_RATIO
    # block by block on JAX's input: the same int8 values but for a rare
    # rounding flip under fp32 noise, so each block's median error is nil
    for name, ours, theirs in _teacher_forced(scales):
        assert rebuild_checks.median_share(ours, theirs) <= 1, name


def _teacher_forced(scales):
    """Each ResBlock and attention block of the fp32 static int8 port net
    on JAX's input of that block (forward hooks keep the port's output and
    hand JAX's on); returns [(name, port, JAX)]."""
    net = _jax_net(quant_int8="static")
    _, st = net.apply({"params": _params(), "quant_scales": scales},
                      *(jnp.asarray(a) for a in _inputs()),
                      capture_intermediates=True, mutable=["intermediates"])
    inter = st["intermediates"]
    pnet = _port_net(quant_int8="static")
    pnet.load_state_dict(ncsnpp_quant_scales_from_flax(
        jax.tree.map(np.asarray, scales)), strict=False)
    pnet.prepare_int8()
    seen, hooks = [], []
    for name, mod in pnet.named_children():
        if isinstance(mod, (port.ResBlockBigGAN, port.AttnBlockSkip)):
            ref = _t(inter[name]["__call__"][0]).contiguous(
                memory_format=torch.channels_last)

            def hook(mod, inp, out, _name=name, _ref=ref):
                seen.append((_name, _np(out), _np(_ref)))
                return _ref
            hooks.append(mod.register_forward_hook(hook))
    x, t, z = _inputs()
    with torch.no_grad():
        pnet(_t(x), torch.from_numpy(t), torch.from_numpy(z))
    assert len(seen) == 14
    return seen


def test_net_matches_jax_int8_bf16_skip_attn():
    """``generate_cifar10 --int8``'s NCSN++: bf16 torso, static int8 with
    the attention 1x1s in bf16, JAX's scales loaded."""
    scales, ref = _jax_out("bf16", "static", True)
    ref32 = np.asarray(_jax_net(quant_int8="static",
                                quant_skip_attn=True).apply(
        {"params": _params(), "quant_scales": scales},
        *(jnp.asarray(a) for a in _inputs())), np.float32)
    noise = _rel(ref, ref32)
    assert noise < 6e-2, noise
    out = _port_out(torch.bfloat16, scales, quant_int8="static",
                    quant_skip_attn=True)
    assert _rel(out, ref) < 2 * noise, (_rel(out, ref), noise)
    assert _rel(out, ref32) < 1.5 * noise, (_rel(out, ref32), noise)


@pytest.mark.parametrize("path", list(chip_smoke.DDGAN_LAUNCHES_PER_FORWARD))
def test_full_width_launch_table(path):
    """E6's launches per forward at NCSNppArgs' defaults: K1 at the 56 AdaGNs
    of the 28 ResBlocks, the 6 attention GroupNorms and norm_out (63; in
    bf16 the 28 norm2s and the first block's norm1 see bf16 activations, the
    rest the fp32 residual stream); K8 under --int8 at the 56 3x3 convs and
    19 shortcuts (75), and the 24 attention 1x1s without quant_skip_attn."""
    counts = chip_smoke.ddgan_shape_counts(path)
    assert chip_smoke.launches_of(counts) == \
        chip_smoke.DDGAN_LAUNCHES_PER_FORWARD[path]
    # every GroupNorm has 32 groups of C in {128, 256, 384, 512}, 32x32 to
    # 4x4; every int8 conv takes K8's Cin % 32 == 0 and Cout % 8 == 0
    for key in counts:
        if key[0] == "gn":
            assert key[2] in (128, 256, 384, 512) and key[1] in (
                1024, 256, 64, 16), key
        else:
            assert key[3] % 32 == 0 and key[4] % 8 == 0, key
