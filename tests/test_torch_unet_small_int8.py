"""The port's UNetSmall in bf16 and int8 (and the options of bench.py's
configuration) against dxmi_tpu's on the same weights: numpy-made
reference-layout weights go through ``dxmi_tpu.utils.convert`` to the JAX
model and back through ``dxmi_tpu_torch.utils.convert`` to the port, and the
JAX net's calibrated ``quant_scales`` through
``unet_small_quant_scales_from_flax`` into the port's scale buffers. The net
is small (ch 32, ch_mult (1, 2), 16x16, one ResnetBlock a level, attention
at 8x8); the JAX side runs on the CPU, eagerly.

The tolerances, setting by setting:
- full-precision options (einsum_merged, softmax_nomax, resamp_with_conv
  False) at 1e-4, as the fp32 forward in test_torch_unet_small.py;
- static int8 in fp32 (and with quant_skip_attn, quant_skip_last_level, the
  merged int8 qkv, the int8 phase upsample): the calibrating pass records
  JAX's scales within 1e-5 of each buffer's largest, and with JAX's scales
  loaded the output is read as G2-int8 reads an int8 step
  (``_int8_net_gates``): K8's plain version is exact, so only fp32 noise in
  GroupNorm and attention moves a value across an int8 rounding boundary
  now and then, and a flip moves the outputs it reaches by up to an int8
  level of a later layer;
- static int8 in bf16 (bf16_onepass statistics, and bench.py's
  configuration): no further from JAX's fp32 int8 output than 1.5x JAX's
  own bf16 int8 output is, and within 2x that distance of JAX's bf16 output,
  as test_torch_unet_adm.py's bf16 int8 net;
- dynamic int8: a per-tensor scale is the largest |x| of the whole tensor,
  so one rounding flip upstream can move the scale and with it every
  element of a later layer, and the whole net fails the median gate above.
  Each block is therefore held with JAX's input (teacher forcing): its
  median error within 2^-16 of its largest output and its mean error
  within 1e-3 of its mean output.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dxmi_tpu.models.unet_small import UNetSmall as JaxUNetSmall
from dxmi_tpu.samplers.var import VARSampler as JaxVARSampler
from dxmi_tpu.utils.convert import convert_unet_small
from dxmi_tpu_torch import generate_cifar10
from dxmi_tpu_torch.models import unet_small as port
from dxmi_tpu_torch.ops import phase_up, quant
from dxmi_tpu_torch.samplers import sample_many
from dxmi_tpu_torch.samplers.var import VARSampler
from dxmi_tpu_torch.utils.convert import (unet_small_from_flax,
                                          unet_small_quant_scales_from_flax)
from torch_fixtures import rebuild_checks

SMALL = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
             resolution=16, dropout=0.0)
SCALE_REL = 1e-5
BENCH = dict(softmax_f32=False, quant_int8="static", quant_skip_attn=True,
             attn_impl="einsum_merged", softmax_nomax=True, up_impl="phase")
# setting -> (JAX module options, bf16, how the output is held)
SETTINGS = {
    "static_fp32": (dict(quant_int8="static"), False, "int8"),
    "static_bf16_onepass": (dict(quant_int8="static"), True, "bf16"),
    "dynamic": (dict(quant_int8=True), False, "teacher"),
    "quant_skip_attn": (dict(quant_int8="static", quant_skip_attn=True),
                        False, "int8"),
    "quant_skip_last_level": (dict(quant_int8="static",
                                   quant_skip_last_level=True), False,
                              "int8"),
    "einsum_merged": (dict(attn_impl="einsum_merged"), False, "fp"),
    "einsum_merged_static": (dict(attn_impl="einsum_merged",
                                  quant_int8="static"), False, "int8"),
    "softmax_nomax": (dict(softmax_nomax=True), False, "fp"),
    "phase_static": (dict(up_impl="phase", quant_int8="static"), False,
                     "int8"),
    "no_resamp_conv": (dict(resamp_with_conv=False), False, "fp"),
    "bench_bf16": (BENCH, True, "bf16"),
}


def _numpy_state(seed=0, **kw):
    """Reference-layout weights from a numpy seed: GroupNorm scales near 1,
    biases ~0.1, weights ~N(0, 1/fan_in)."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, v in port.UNetSmall(**SMALL, **kw).state_dict().items():
        if k.endswith("act_scale"):
            continue
        shape = tuple(v.shape)
        if len(shape) == 1:
            base = 1.0 if ("norm" in k and k.endswith("weight")) else 0.0
            a = base + 0.1 * rs.randn(*shape)
        else:
            a = rs.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        out[k] = a.astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _params(resamp_with_conv=True):
    return convert_unet_small(_numpy_state(
        resamp_with_conv=resamp_with_conv))["params"]


def _inputs(seed=1):
    rs = np.random.RandomState(seed)
    return (rs.randn(4, 16, 16, 3).astype(np.float32),
            np.array([3.5, 761.2, 100.0, 401.0], np.float32))


def _gn_env(bf16):
    """The JAX package reads its GroupNorm statistics mode from the
    environment."""
    return ({"DXMI_GN_STATS": "bf16_onepass"} if bf16
            else {"DXMI_GN_STATS": "fp32"})


def _jax(kw, jdt, params, x, t, **apply_kw):
    """JAX's calibrating pass (from zero scales) and forward; returns
    (scales or None, NHWC output, the apply's extra outputs)."""
    net = JaxUNetSmall(**SMALL, dtype=jdt, **kw)
    args = (jnp.asarray(x), jnp.asarray(t))
    shapes = jax.eval_shape(net.init, jax.random.key(0), *args)
    variables = {"params": params}
    scales = None
    if "quant_scales" in shapes:
        zeros = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                             shapes["quant_scales"])
        _, upd = net.apply({"params": params, "quant_scales": zeros}, *args,
                           mutable=["quant_scales"])
        scales = variables["quant_scales"] = upd["quant_scales"]
    out = net.apply(variables, *args, **apply_kw)
    extra = None
    if apply_kw:
        out, extra = out
    return scales, np.asarray(out, np.float32), extra


def _port_net(kw, bf16, params):
    """The port's net for JAX options ``kw`` (unfused, as JAX's defaults)
    with the carried weights."""
    kw = dict(kw)
    kw.setdefault("attn_impl", "einsum")
    net = port.UNetSmall(**SMALL, **kw, fuse_gn_conv=False,
                         dtype=torch.bfloat16 if bf16 else torch.float32,
                         gn_stats="bf16_onepass" if bf16 else "fp32")
    missing, unexpected = net.load_state_dict(unet_small_from_flax(params),
                                              strict=False)
    assert not unexpected and all(k.endswith("act_scale") for k in missing)
    return net.eval()


def _port(kw, bf16, params, x, t, scales):
    """The port's calibrating pass and, with JAX's scales loaded, its
    forward; returns (its own scales, NHWC output)."""
    net = _port_net(kw, bf16, params)
    args = (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t))
    ours = None
    with torch.no_grad():
        if scales is not None:
            net.set_calibrating(True)
            net(*args)
            net.set_calibrating(False)
            ours = {k: v.clone() for k, v in net.state_dict().items()
                    if k.endswith("act_scale")}
            want = unet_small_quant_scales_from_flax(
                jax.tree.map(np.asarray, scales))
            assert set(want) == set(ours)
            net.load_state_dict(want, strict=False)
            net.prepare_int8()
        out = net(*args).permute(0, 2, 3, 1).numpy()
    return ours, out


def _rel(a, b):
    return float(np.abs(a - b).mean() / np.abs(b).mean())


def _int8_net_gates(out, ref, fp):
    """The port's int8 output against JAX's, read as G2-int8 reads an int8
    step: against the int8 effect |JAX int8 - JAX fp32|, the mean error
    within INT8_STEP_RATIO of the mean effect and the median within
    INT8_MEDIAN_RATIO of the median; the median error within 2^-16 of the
    largest output."""
    err, effect = np.abs(out - ref), np.abs(fp - ref)
    assert err.mean() / effect.mean() <= chip_smoke.INT8_STEP_RATIO
    assert np.median(err) / np.median(effect) <= chip_smoke.INT8_MEDIAN_RATIO
    assert rebuild_checks.median_share(out, ref) <= 1


def _teacher_forced(kw, params, x, t):
    """Each top-level block of the port (ResnetBlock, AttnBlock, Downsample,
    Upsample) run on JAX's input of that block: forward hooks keep the
    port's output and hand JAX's on. Returns [(name, port, JAX)] NCHW."""
    with _env(_gn_env(False)):
        _, _, inter = _jax(kw, jnp.float32, params, x, t,
                           capture_intermediates=True,
                           mutable=["intermediates"])
    inter = inter["intermediates"]
    net = _port_net(kw, False, params)
    seen, hooks = [], []
    for name, mod in net.named_modules():
        if isinstance(mod, (port.ResnetBlock, port.AttnBlock,
                            port.Downsample, port.Upsample)):
            ref = torch.from_numpy(np.asarray(
                inter[name.replace(".", "_")]["__call__"][0])).permute(
                    0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

            def hook(mod, inp, out, _name=name, _ref=ref):
                seen.append((_name, out.numpy(), _ref.numpy()))
                return _ref
            hooks.append(mod.register_forward_hook(hook))
    with torch.no_grad():
        net(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t))
    for h in hooks:
        h.remove()
    return seen


class _env:
    def __init__(self, values):
        self.values = values

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@functools.lru_cache(maxsize=None)
def _jax_fp32_out():
    x, t = _inputs()
    with _env(_gn_env(False)):
        return _jax({}, jnp.float32, _params(), x, t)[1]


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_forward_matches_jax(setting):
    kw, bf16, how = SETTINGS[setting]
    params = _params(kw.get("resamp_with_conv", True))
    x, t = _inputs()
    if how == "teacher":
        blocks = _teacher_forced(kw, params, x, t)
        assert len(blocks) == 14
        for name, ours, ref in blocks:
            err = np.abs(ours - ref)
            assert rebuild_checks.median_share(ours, ref) <= 1, name
            assert err.mean() <= 1e-3 * np.abs(ref).mean(), name
        return
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    with _env(_gn_env(bf16)):
        scales, ref, _ = _jax(kw, jdt, params, x, t)
    ours, out = _port(kw, bf16, params, x, t, scales)
    if how == "fp":
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
        return
    if how == "int8":
        want = unet_small_quant_scales_from_flax(
            jax.tree.map(np.asarray, scales))
        for k, v in want.items():
            assert (ours[k] - v).abs().max() <= SCALE_REL * v.abs().max(), k
        _int8_net_gates(out, ref, _jax_fp32_out())
        return
    with _env(_gn_env(True)):
        ref32 = _jax(kw, jnp.float32, params, x, t)[1]
    noise = _rel(ref, ref32)
    assert noise < 6e-2, noise
    assert _rel(out, ref32) < 1.5 * noise, (_rel(out, ref32), noise)
    assert _rel(out, ref) < 2 * noise, (_rel(out, ref), noise)


def test_int8_gates_see_one_scale_doubled():
    """``_int8_net_gates`` refuse the static fp32 net with one conv's
    activation scale doubled."""
    kw = SETTINGS["static_fp32"][0]
    x, t = _inputs()
    with _env(_gn_env(False)):
        scales, ref, _ = _jax(kw, jnp.float32, _params(), x, t)
    doubled = jax.tree.map(np.array, scales)
    doubled["up_0_block_0"]["conv1"]["act_scale"] *= 2
    _, out = _port(kw, False, _params(), x, t, doubled)
    with pytest.raises(AssertionError):
        _int8_net_gates(out, ref, _jax_fp32_out())


def test_quant_scales_cover_every_placement():
    """The converter maps each placement of JAX's quant_scales onto a port
    buffer of the same size: QConvs (stride-2 Downsample convs and the
    attention 1x1s among them), the merged-qkv block and the phase
    Upsample."""
    kw = dict(quant_int8="static", attn_impl="einsum_merged",
              up_impl="phase")
    x, t = _inputs()
    with _env(_gn_env(False)):
        scales, _, _ = _jax(kw, jnp.float32, _params(), x, t)
    got = unet_small_quant_scales_from_flax(jax.tree.map(np.asarray, scales))
    state = _port_net(kw, False, _params()).state_dict()
    assert {"down.0.downsample.conv.act_scale", "mid.attn_1.act_scale",
            "up.1.upsample.act_scale", "mid.attn_1.proj_out.act_scale",
            "down.0.block.0.conv1.act_scale"} <= set(got)
    assert {k for k in state if k.endswith("act_scale")} == set(got)
    for k, v in got.items():
        assert v.shape == state[k].shape, k


def _count_launches(monkeypatch, net, batch=1):
    """Run ``net`` on the meta device (shapes only) with the kernel wrappers
    replaced by counters named as the real wrappers count their launches
    on the card (K8 by stride)."""
    counts = {}

    def gn(x, *args, **kw):
        name = "gn_silu_bf16" if x.dtype == torch.bfloat16 else "gn_silu"
        counts[name] = counts.get(name, 0) + 1
        return torch.empty_like(x)

    def int8_conv(x, q, bias, padding, out_dtype, stride=1):
        name = "int8_conv" if stride == 1 else "int8_conv_s2"
        counts[name] = counts.get(name, 0) + 1
        B, H, W, _ = x.shape
        O, kh, kw, _ = q.w_i8.shape
        Ho, Wo = quant.out_size(H, W, kh, kw, padding, stride)
        return torch.empty(B, Ho, Wo, O, dtype=out_dtype, device=x.device)

    monkeypatch.setattr(port, "group_norm", gn)
    for mod in (quant, phase_up, port):
        monkeypatch.setattr(mod, "int8_conv_apply", int8_conv)
    net.to("meta")
    with torch.no_grad():
        out = net(torch.empty(batch, 3, 32, 32, device="meta"),
                  torch.empty(batch, device="meta"))
    assert tuple(out.shape) == (batch, 3, 32, 32)
    return counts


@pytest.mark.parametrize("path", ["a_fp32", "a_bf16", "b"])
def test_full_width_int8_launch_table(monkeypatch, path):
    """The launches per forward that chip_smoke.py checks in phase E-int8,
    at the full width of configs/cifar10/T10.yaml: (a) --int8 (fp32 or bf16)
    and (b) bench.py's configuration. K1 at all 51 GroupNorms; K8 at the 57
    ResnetBlock convs, 3 stride-2 Downsample convs, and either 3 Upsample
    convs and 24 attention 1x1s (a) or the 3 phase Upsamples as 4 launches
    each with the attention 1x1s in bf16 (b)."""
    if path == "b":
        net = port.UNetSmall(**generate_cifar10.BENCH_NET)
    else:
        net = port.UNetSmall(dropout=0.1, quant_int8="static",
                             dtype=(torch.bfloat16 if path == "a_bf16"
                                    else torch.float32))
    assert sum(isinstance(m, quant.QConv) and m.stride == (2, 2)
               for m in net.modules()) == 3
    counts = _count_launches(monkeypatch, net)
    assert counts == chip_smoke.CIFAR_INT8_LAUNCHES_PER_FORWARD[path]


@pytest.mark.parametrize("kw,named", [
    (dict(), ("K3", "K2 in bf16 at a single head of d = 256")),
    (dict(fuse_gn_conv=False), ("K2 in bf16",)),
    (dict(attn_impl="einsum"), ("K3",)),
    (dict(quant_int8="static", quant_skip_last_level=True), ("K3",)),
    (dict(quant_int8="static", quant_skip_attn=True),
     ("K2 in bf16 at a single head of d = 256",))])
def test_bf16_without_kernel_forms_raises(monkeypatch, kw, named):
    """The full-width bf16 constructions that raised until K3 took bf16
    activations and K2 bf16 a single head of d = 256 now build, and their
    layers take the fused route each one names: K3 on bf16 activations,
    K2 on a bf16 (B, 256, 256) block with its bf16 weights (counted on the
    meta device); int8 still turns both fusions off where it quantises."""
    net = port.UNetSmall(dtype=torch.bfloat16, **kw)
    routes = set()

    def conv(x, gs, gb, k, b, *a):
        assert x.dtype == torch.bfloat16
        routes.add("K3")
        return torch.empty(*x.shape[:3], k.shape[-1], dtype=x.dtype,
                           device=x.device)

    def attn(x, gs, gb, w_qkv, b_qkv, w_proj, b_proj, **kwargs):
        assert x.dtype == w_qkv.dtype == w_proj.dtype == torch.bfloat16
        routes.add("K2 in bf16" + (" at a single head of d = 256" if
                                   x.shape[-1] == 256 else ""))
        return torch.empty_like(x)

    monkeypatch.setattr(port, "gn_silu_conv", conv)
    monkeypatch.setattr(port, "attn_block", attn)
    _count_launches(monkeypatch, net, batch=2)
    for name in named:
        assert any(r.startswith(name) for r in routes), (name, routes)
    assert routes <= {"K3", "K2 in bf16 at a single head of d = 256"}
    if "K3" not in named:
        assert "K3" not in routes
    if not any(n.startswith("K2") for n in named):
        assert not any(r.startswith("K2") for r in routes)


def _calib_draws(seed, rounds=2, n=4, T=10):
    rs = np.random.RandomState(seed)
    return (rs.randn(rounds, n, 16, 16, 3).astype(np.float32),
            rs.randn(rounds, T, n, 16, 16, 3).astype(np.float32))


CALIB_CASES = {"convs": dict(quant_int8="static"),
               "phase_merged": dict(quant_int8="static", up_impl="phase",
                                    attn_impl="einsum_merged")}


def jax_calibration(kw, x0, eps):
    """JAX's VARSampler calibration of the SMALL net with options ``kw`` on
    injected draws (NHWC), from zero scales, and the scales its
    ``calibrate_quant`` would start from instead: ``net.init`` on a zero
    input with the CLI's key ``fold_in(key(0 + 123), 999)``. Returns both
    as port state-dict entries."""
    params = _params()
    jnet = JaxUNetSmall(**SMALL, **kw)
    jsamp = JaxVARSampler(jnet, 10, (3, 16, 16), trainable_beta="fix_last")
    sch = jsamp.schedule
    sig = np.asarray(jsamp.sigmas_all({"log_betas": jnp.log(jnp.asarray(
        sch.init_sigma))}))
    shapes = jax.eval_shape(jnet.init, jax.random.key(0),
                            jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)))
    scales = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                          shapes["quant_scales"])
    with _env(_gn_env(False)):
        for r in range(x0.shape[0]):
            x = jnp.asarray(x0[r])
            for i in range(10):
                tau = jnp.full((x.shape[0],), sch.tau[i])
                e, upd = jnet.apply({"params": params,
                                     "quant_scales": scales}, x, tau,
                                    mutable=["quant_scales"])
                scales = upd["quant_scales"]
                x = (x * sch.x_mult[i] + sch.eps_mult[i] * e
                     + sig[i] * jnp.asarray(eps[r, i]))
        init = jnet.init(jax.random.fold_in(jax.random.key(123), 999),
                         jnp.zeros((1, 16, 16, 3)),
                         jnp.zeros((1,)))["quant_scales"]
    return tuple(unet_small_quant_scales_from_flax(
        jax.tree.map(np.asarray, t)) for t in (scales, init))


@pytest.mark.parametrize("case", list(CALIB_CASES))
def test_calibrate_quant_matches_jax(case):
    """VARSampler.calibrate_quant with injected draws records JAX's scales
    (within SCALE_REL of each buffer's largest) in every channel where
    JAX's init scales do not win. JAX's calibrate_quant seeds its running
    maxima with the scales of a threefry ``net.init`` on a zero input,
    which torch cannot reproduce, so JAX's side runs the same trajectories
    from zero scales (the port's start), and the channels where the init
    scale would win are counted (at most a tenth; tests/torch_fixtures/
    int8_cpu_report.py prints the count) and left out."""
    kw = CALIB_CASES[case]
    x0, eps = _calib_draws(7)
    want, init = jax_calibration(kw, x0, eps)
    won = {k: init[k] > v for k, v in want.items()}
    n_won = sum(int(w.sum()) for w in won.values())
    n_all = sum(v.numel() for v in want.values())
    assert n_won <= 0.1 * n_all, (n_won, n_all)

    net = _port_net(kw, False, _params())
    sampler = VARSampler(net, 10, (3, 16, 16), trainable_beta="fix_last")
    sampler.calibrate_quant(n_sample=4, n_rounds=2,
                            x0=torch.from_numpy(x0).permute(0, 1, 4, 2, 3),
                            eps=torch.from_numpy(eps).permute(0, 1, 2, 5, 3,
                                                              4))
    state = net.state_dict()
    for k, v in want.items():
        err = ((state[k] - v).abs() * ~won[k]).max() / v.abs().max()
        assert err <= SCALE_REL, (k, float(err))
    assert all(m._int8_cache is not None for m in net.modules()
               if isinstance(m, quant.Int8Layer) and m.quantise_int8()
               is not None)


def test_sample_many_stacks_whole_trajectories():
    """sample_many draws n_batches trajectories from one generator, one after
    another, and stacks their final samples: the same as calling sample in
    a loop on a generator of the same seed."""
    torch.manual_seed(0)
    net = port.UNetSmall(**SMALL, fuse_gn_conv=False, attn_impl="einsum")
    sampler = VARSampler(net, 3, (3, 16, 16), trainable_beta="fix_last")
    with torch.no_grad():
        got = sample_many(sampler, 2, 3, torch.Generator().manual_seed(5))
        gen = torch.Generator().manual_seed(5)
        want = torch.stack([sampler.sample(3, generator=gen)["sample"]
                            for _ in range(2)])
    assert got.shape == (2, 3, 3, 16, 16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_bench_sampler_is_bench_py_configuration(monkeypatch):
    """bench_sampler builds bench.py's net (its UNetSmall arguments and
    DXMI_GN_STATS, read from bench.py's source) and calibrates it with
    bench.py's 8 samples in 1 round."""
    with open(os.path.join(chip_smoke.REPO, "bench.py")) as f:
        src = f.read()
    for k, v in generate_cifar10.BENCH_NET.items():
        if k == "dtype":
            assert "dtype=jnp.bfloat16" in src
        elif k == "gn_stats":
            assert 'os.environ.setdefault("DXMI_GN_STATS", "bf16_onepass")' \
                in src
        elif k != "fuse_gn_conv":
            assert f"{k}={v!r}".replace("'", '"') in src.replace("'", '"'), k
    assert "n_sample=8, n_rounds=1" in src and "batch = 96" in src
    calls = []
    monkeypatch.setattr(VARSampler, "calibrate_quant",
                        lambda self, gen, **kw: calls.append(kw))
    monkeypatch.setattr(generate_cifar10, "BENCH_NET",
                        dict(generate_cifar10.BENCH_NET, ch=32))
    sampler = generate_cifar10.bench_sampler("cpu")
    assert calls == [generate_cifar10.BENCH_CALIB]
    assert sampler.net.dtype == torch.bfloat16
    assert sampler.trainable_beta == "fix_last"
