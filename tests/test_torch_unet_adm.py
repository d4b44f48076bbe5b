"""The ImageNet64 slice on the CPU against dxmi_tpu: UNetADM on converted
weights (every route, fp32 and bf16, both upsampling forms), the kernel
launch table of the full-width ImageNet64 net (counted on the meta device,
without computing a forward), the converter's round trip, the trained ADM
fixture's trajectory through config -> checkpoint -> EDMSampler -> UNetADM at
tests/test_golden_adm_fixture.py's limits, and the generate_large CLI."""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from dxmi_tpu.models.unet_adm import UNetADM as JaxUNetADM
from dxmi_tpu.utils.convert import convert_unet_adm
from dxmi_tpu_torch.generate_large import load_sampler
from dxmi_tpu_torch.models import unet_adm
from dxmi_tpu_torch.models.unet_adm import (AttentionBlockADM, ResBlockADM,
                                            UNetADM, create_unet_adm)
from dxmi_tpu_torch.ops import phase_up, quant
from dxmi_tpu_torch.ops.quant import QConv
from dxmi_tpu_torch.samplers.edm import EDMSampler
from dxmi_tpu_torch.utils.checkpoint import load_sampler_state
from dxmi_tpu_torch.utils.convert import (adm_quant_scales_from_flax,
                                          edm_sampler_from_flax,
                                          unet_adm_from_flax)
from torch_fixtures import rebuild_checks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_rundir_adm_t10")

# a small net (16x16: attention at 8x8, S=64) and a 32x32 one
# whose 32x32 attention (S=1024) opens the flash route
SMALL = dict(in_channels=3, model_channels=32, out_channels=3,
             num_res_blocks=1, channel_mult=(1, 2), num_heads=2,
             use_scale_shift_norm=True, resblock_updown=True, num_classes=4)
NETS = {16: dict(SMALL, image_size=16, attention_resolutions=(2,)),
        32: dict(SMALL, image_size=32, attention_resolutions=(1, 2))}


def _seeded_flax_params(cfg, seed):
    """The JAX net's params tree with every leaf drawn from a seeded normal
    (the module's own init zeroes out_layers_3, proj_out and out_2)."""
    net = JaxUNetADM(**cfg)
    R = cfg["image_size"]
    shapes = jax.eval_shape(
        lambda: net.init(jax.random.key(0), jnp.zeros((1, R, R, 3)),
                         jnp.zeros((1,)), jnp.zeros((1,), jnp.int32)))
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        z = rs.randn(*leaf.shape).astype(np.float32)
        if names[-1] == "embedding":
            return z
        if names[-1] == "kernel":
            return z / np.sqrt(np.prod(leaf.shape[:-1]))
        if names[-2:] == ["gn", "scale"]:
            return 1.0 + 0.1 * z
        return 0.1 * z

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


def _inputs(R, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 3, R, R).astype(np.float32)
    t = np.array([1095.3, -180.4], np.float32)  # rescaled EDM times
    y = np.array([1, 3], np.int32)
    return x, t, y


@pytest.fixture(scope="module", params=[16, 32])
def small(request):
    R = request.param
    params = _seeded_flax_params(NETS[R], seed=R)
    return R, params, unet_adm_from_flax(params)


def _jax_out(cfg, params, x, t, y, **kw):
    net = JaxUNetADM(**cfg, **kw)
    out = net.apply({"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1)),
                    jnp.asarray(t), jnp.asarray(y))
    return np.asarray(out).transpose(0, 3, 1, 2)


def _port_out(cfg, state, x, t, y, **kw):
    net = UNetADM(**cfg, **kw)
    net.load_state_dict(state)
    net.cast_weights()
    with torch.no_grad():
        out = net(torch.from_numpy(x), torch.from_numpy(t),
                  torch.from_numpy(y).long())
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("up_impl", ["resize", "phase"])
def test_fp32_routes_match_jax(small, up_impl):
    """Every attention route in fp32 equals the JAX einsum path at 1e-4
    (the fused route runs K2's plain version; in fp32 the flash route is
    the einsum path, K4 being bf16)."""
    R, params, state = small
    x, t, y = _inputs(R, seed=1)
    ref = _jax_out(NETS[R], params, x, t, y, up_impl=up_impl)
    assert np.abs(ref).mean() > 0.1
    for impl in ("einsum", "fused", "flash"):
        ours = _port_out(NETS[R], state, x, t, y, attn_impl=impl,
                         up_impl=up_impl)
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4,
                                   err_msg=impl)


# bf16 nets: torch and XLA round each bf16 operation to the same type, but
# their convolutions and matmuls sum in other orders and torch's conv adds
# its bias before rounding (XLA after), so single-ulp differences (2^-8
# relative) enter at every layer and grow through the depth. Measured, each
# bf16 net sits ~1.5-1.9% (mean relative error) from the fp32 net, and the
# port's and JAX's bf16 nets ~2% from each other: independent bf16 noise.
# So the port's bf16 net must be no further from the fp32 JAX net than 1.5x
# JAX's own bf16 net is, and within 2x that distance of JAX's bf16 net.
def _rel(a, b):
    return float(np.abs(a - b).mean() / np.abs(b).mean())


def _bf16_close(ours, ref_bf16, ref_fp32, name):
    noise = _rel(ref_bf16, ref_fp32)
    assert noise < 3e-2, (name, noise)
    assert _rel(ours, ref_fp32) < 1.5 * noise, (name, _rel(ours, ref_fp32))
    assert _rel(ours, ref_bf16) < 2 * noise, (name, _rel(ours, ref_bf16))


@pytest.mark.parametrize("gn_stats", ["fp32", "bf16_onepass"])
def test_bf16_einsum_matches_jax(small, monkeypatch, gn_stats):
    R, params, state = small
    x, t, y = _inputs(R, seed=2)
    ref32 = _jax_out(NETS[R], params, x, t, y)
    monkeypatch.setenv("DXMI_GN_STATS", gn_stats)
    ref = _jax_out(NETS[R], params, x, t, y, dtype=jnp.bfloat16,
                   softmax_f32=False, up_impl="phase")
    ours = _port_out(NETS[R], state, x, t, y, dtype=torch.bfloat16,
                     softmax_f32=False, attn_impl="einsum", up_impl="phase",
                     gn_stats=gn_stats)
    _bf16_close(ours, ref, ref32, gn_stats)


def test_bf16_kernel_routes_match_jax(small, monkeypatch):
    """fused (K2's bf16 plain version) and flash (K4's, at the 32x32 map)
    against the JAX einsum path with an fp32 softmax, the same arithmetic
    class."""
    R, params, state = small
    x, t, y = _inputs(R, seed=3)
    ref32 = _jax_out(NETS[R], params, x, t, y)
    monkeypatch.setenv("DXMI_GN_STATS", "bf16_onepass")
    ref = _jax_out(NETS[R], params, x, t, y, dtype=jnp.bfloat16,
                   softmax_f32=True)
    for impl in ("fused", "flash"):
        ours = _port_out(NETS[R], state, x, t, y, dtype=torch.bfloat16,
                         attn_impl=impl, gn_stats="bf16_onepass")
        _bf16_close(ours, ref, ref32, impl)


def test_bf16_fused_matches_jax_fused_kernel(monkeypatch):
    """The 16x16 net with the JAX fused attention block forced into its
    Pallas kernel (interpret mode) against the port's fused route."""
    params = _seeded_flax_params(NETS[16], seed=16)
    x, t, y = _inputs(16, seed=4)
    ref32 = _jax_out(NETS[16], params, x, t, y)
    monkeypatch.setenv("DXMI_FUSED_ATTN_FORCE", "1")
    ref = _jax_out(NETS[16], params, x, t, y, dtype=jnp.bfloat16,
                   attn_impl="fused")
    ours = _port_out(NETS[16], unet_adm_from_flax(params), x, t, y,
                     dtype=torch.bfloat16, attn_impl="fused")
    _bf16_close(ours, ref, ref32, "fused")


def _count_launches(monkeypatch, net, R):
    """Run ``net`` on the meta device (shapes only, no arithmetic) with the
    kernel wrappers replaced by counters named as the real wrappers count
    their launches on the card."""
    counts = {}

    def counter(name, out):
        def fn(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return out(args[0])
        return fn

    monkeypatch.setattr(unet_adm, "group_norm",
                        counter("gn_silu_bf16", torch.empty_like))
    monkeypatch.setattr(unet_adm, "attn_block",
                        counter("attn_block_bf16", torch.empty_like))
    monkeypatch.setattr(unet_adm, "flash_mha",
                        counter("flash_attn", torch.empty_like))
    monkeypatch.setattr(unet_adm, "attn_block_int8",
                        counter("attn_block_i8", torch.empty_like))

    def int8_conv(x, q, bias, padding, out_dtype):
        counts["int8_conv"] = counts.get("int8_conv", 0) + 1
        return torch.empty(*x.shape[:3], q.w_i8.shape[0], dtype=out_dtype,
                           device=x.device)
    monkeypatch.setattr(quant, "int8_conv_apply", int8_conv)
    monkeypatch.setattr(phase_up, "int8_conv_apply", int8_conv)
    x = torch.empty(1, 3, R, R, device="meta")
    net(x, torch.empty(1, device="meta"),
        torch.zeros(1, dtype=torch.long, device="meta"))
    return counts


@pytest.mark.parametrize("attn_impl", ["fused", "flash"])
def test_imagenet64_launch_table(monkeypatch, attn_impl):
    """The launches per forward that chip_smoke.py checks in phase E2, from
    the full-width ImageNet64 net (configs/imagenet64/T10.yaml) run on the
    meta device: 36 ResBlocks, 22 attention blocks (7 at 32x32, 7 at 16x16,
    8 at 8x8), and the gates' choices at their real shapes."""
    cfg = dict(chip_smoke.imagenet64_t10()["diffusion"])
    for k in ("sigma_min", "sigma_max", "weight_schedule", "distillation"):
        cfg.pop(k)
    with torch.device("meta"):
        net = create_unet_adm(**cfg, attn_impl=attn_impl, up_impl="phase",
                              gn_stats="bf16_onepass")
    assert net.dtype == torch.bfloat16
    assert sum(isinstance(m, ResBlockADM) for m in net.modules()) == 36
    assert sum(isinstance(m, AttentionBlockADM) for m in net.modules()) == 22
    assert sum(p.numel() for p in net.parameters()) == 295_899_267
    counts = _count_launches(monkeypatch, net.cast_weights(), 64)
    assert counts == chip_smoke.ADM_LAUNCHES_PER_FORWARD[attn_impl]


@pytest.mark.parametrize("attn_impl,want", [
    ("fused", {"attn_block_bf16": 22}), ("flash", {"flash_attn": 7})])
def test_imagenet64_fp32_routes(monkeypatch, attn_impl, want):
    """The attention routes are the JAX gates alone: the full-width net in
    fp32 sends the same maps to K2 or K4 as in bf16 (on the card a form
    the kernels do not take raises rather than falling back)."""
    cfg = dict(chip_smoke.imagenet64_t10()["diffusion"], use_fp16=False)
    for k in ("sigma_min", "sigma_max", "weight_schedule", "distillation"):
        cfg.pop(k)
    with torch.device("meta"):
        net = create_unet_adm(**cfg, attn_impl=attn_impl)
    assert net.dtype == torch.float32
    counts = _count_launches(monkeypatch, net, 64)
    assert {k: v for k, v in counts.items() if k != "gn_silu_bf16"} == want


def test_convert_roundtrip():
    """reference sampler.pth -> dxmi_tpu's convert_unet_adm -> the port's
    edm_sampler_from_flax gives back the reference keys and values."""
    state = load_sampler_state(os.path.join(FIXTURE, "sampler.pth"))
    ref = torch.load(os.path.join(FIXTURE, "sampler.pth"), map_location="cpu",
                     weights_only=True)["state_dict"]
    flax = convert_unet_adm({k: v.numpy() for k, v in ref.items()})
    back = edm_sampler_from_flax({"net": flax["params"],
                                  "log_betas": flax["log_betas"]})
    assert set(back) == set(state)
    for k in state:
        torch.testing.assert_close(back[k], state[k], rtol=0, atol=0)


@pytest.fixture(scope="module")
def adm_rundir():
    with open(os.path.join(FIXTURE, "config.yaml")) as f:
        cfg = yaml.safe_load(f)
    return (cfg, np.load(os.path.join(FIXTURE, "golden.npz")),
            load_sampler_state(os.path.join(FIXTURE, "sampler.pth")))


@pytest.mark.parametrize("attn_impl", ["einsum", "fused"])
def test_adm_fixture_replay(adm_rundir, attn_impl):
    """The trained fixture's golden trajectory (injected x, eps, labels;
    each step restarted from the golden mean) at the JAX golden test's
    limits: per-step mean 5e-3, sigma 1e-5 relative, final sample 5e-3."""
    cfg, golden, state = adm_rundir
    sampler = load_sampler(cfg, state, "cpu", attn_impl=attn_impl,
                           up_impl="resize", gn_stats="fp32")
    assert isinstance(sampler, EDMSampler)
    np.testing.assert_allclose(sampler.sigmas.numpy(),
                               golden["sigmas_grid"][:-1], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(sampler.log_betas.detach().numpy(),
                               golden["log_betas"], rtol=0, atol=1e-6)
    x = torch.from_numpy(golden["x_init"])
    y = torch.from_numpy(golden["y"]).long()
    with torch.no_grad():
        for t in range(sampler.n_timesteps):
            out = sampler.sample_step(x, t, torch.from_numpy(golden["eps"][t]),
                                      y)
            err = np.abs(out["mean"].numpy() - golden["means"][t]).max()
            assert err < 5e-3, f"step {t}: mean drift {err:.2e}"
            np.testing.assert_allclose(
                out["sigma"].numpy().reshape(-1, 1, 1, 1), golden["sigmas"][t],
                rtol=1e-5, atol=1e-6, err_msg=f"step {t} sigma")
            x = torch.from_numpy(golden["means"][t]
                                 + golden["sigmas"][t] * golden["eps"][t])
    np.testing.assert_allclose(out["sample"].numpy(), golden["final"], rtol=0,
                               atol=5e-3)


def test_adm_fixture_rollout(adm_rundir):
    """sample() on its own means with the injected x, eps and labels ends
    at the golden sample, and carries the trajectory entries."""
    cfg, golden, state = adm_rundir
    sampler = load_sampler(cfg, state, "cpu", attn_impl="fused")
    with torch.no_grad():
        out = sampler.sample(8, x0=torch.from_numpy(golden["x_init"]),
                             eps=torch.from_numpy(golden["eps"]),
                             y=torch.from_numpy(golden["y"]).long())
    assert out["l_sample"].shape == (11, 8, 3, 16, 16)
    assert out["logp"].shape == out["entropy"].shape == (10, 8)
    np.testing.assert_allclose(out["sample"].numpy(), golden["final"], rtol=0,
                               atol=5e-3)


def test_unported_options_raise():
    """int8 is ported (quant_int8 'static' and True build) and so is
    gradient checkpointing (tests/test_torch_unet_adm_train.py holds its
    gradients); an unknown int8 mode is refused, and so is
    conv_resample=False, which is not ported."""
    net = create_unet_adm(16, 32, 1, channel_mult="1,2", quant_int8="static",
                          attn_impl="fused")
    assert any(isinstance(m, QConv) for m in net.modules())
    assert create_unet_adm(16, 32, 1, channel_mult="1,2",
                           use_checkpoint=True).use_checkpoint
    with pytest.raises(ValueError):
        create_unet_adm(16, 32, 1, quant_int8="dynamic")
    with pytest.raises(NotImplementedError):
        UNetADM(16, model_channels=32, num_res_blocks=1, channel_mult=(1, 2),
                conv_resample=False)


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "dxmi_tpu_torch.generate_large", "--log_dir",
         FIXTURE, "--n_generate", "8", "--batchsize", "8", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""))


def test_generate_large_cli(tmp_path):
    out = tmp_path / "samples.npz"
    proc = _cli("--device", "cpu", "--save_npz", str(out))
    assert proc.returncode == 0, proc.stderr
    arr = np.load(out)
    assert arr["arr_0"].shape == (8, 16, 16, 3)
    assert arr["arr_0"].dtype == np.uint8
    assert arr["arr_1"].shape == (8,) and arr["arr_1"].max() < 4


@pytest.mark.parametrize("args,msg", [((), "no CUDA device")])
def test_generate_large_cli_refuses(args, msg):
    """Without --device cpu and with no card it raises instead of running
    on the CPU."""
    proc = _cli(*args)
    assert proc.returncode != 0
    assert msg in proc.stderr


def test_generate_large_cli_guided(tmp_path):
    """--guidance_scale samples through DxMITrainerCond.sample_guidance with
    the run's value (the fixture's value.pth): finite samples, labels of
    the fixture's 4 classes, and guidance that moves them."""
    outs = {}
    for extra in ((), ("--guidance_scale", "0.1")):
        out = tmp_path / f"s{len(extra)}.npz"
        proc = _cli("--device", "cpu", "--save_npz", str(out), *extra)
        assert proc.returncode == 0, proc.stderr[-3000:]
        outs[len(extra)] = np.load(out)
    assert "value-guided sampling, scale=0.1" in proc.stdout
    assert "value loaded from" in proc.stdout
    guided, plain = outs[2], outs[0]
    assert guided["arr_0"].shape == (8, 16, 16, 3)
    assert guided["arr_1"].shape == (8,) and guided["arr_1"].max() < 4
    assert np.array_equal(guided["arr_1"], plain["arr_1"])
    assert not np.array_equal(guided["arr_0"], plain["arr_0"])


@pytest.mark.parametrize("flag", ["--skip_fid", "--save_dir"])
def test_generate_large_cli_pngs(flag, tmp_path):
    """--skip_fid writes the samples as PNGs into <log_dir>/generated_best
    and computes no FID; --save_dir writes them there and, without the FID
    files, says so (the JAX entry's message). The PNGs decode to the npz."""
    run = tmp_path / "run"
    run.mkdir()
    for name in ("config.yaml", "sampler.pth"):
        (run / name).write_bytes(open(os.path.join(FIXTURE, name),
                                      "rb").read())
    out = tmp_path / "samples.npz"
    pngs = (run / "generated_best" if flag == "--skip_fid"
            else tmp_path / "pngs")
    extra = [flag] if flag == "--skip_fid" else [flag, str(pngs)]
    proc = subprocess.run(
        [sys.executable, "-m", "dxmi_tpu_torch.generate_large", "--log_dir",
         str(run), "--n_generate", "8", "--batchsize", "8", "--device",
         "cpu", "--save_npz", str(out), *extra], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert ("FID assets missing" in proc.stdout) == (flag == "--save_dir")
    assert "FID:" not in proc.stdout
    from dxmi_tpu_torch.utils.png import read_png

    arr = np.load(out)["arr_0"]
    got = np.stack([read_png(str(pngs / f"0_{i}.png")) for i in range(8)])
    np.testing.assert_array_equal(got, arr)


def test_edm_sample_step_matches_jax(adm_rundir):
    """One Euler-ancestral step on the trained fixture, port against
    dxmi_tpu's EDMSampler.sample_step with the same noise (drawn from the
    JAX key and injected): every entry of the step's dict, at the fixture
    replay's 5e-3 for the network-dependent ones and 1e-5 for sigma and
    entropy."""
    from dxmi_tpu.models.unet_adm import create_unet_adm as jax_create
    from dxmi_tpu.samplers.edm import EDMSampler as JaxEDMSampler
    from dxmi_tpu.samplers.edm import KarrasDenoiser as JaxDenoiser
    from dxmi_tpu.utils import checkpoint as ckptlib

    cfg, golden, state = adm_rundir
    dcfg = dict(cfg["diffusion"])
    smin, smax = dcfg.pop("sigma_min"), dcfg.pop("sigma_max")
    dcfg.pop("weight_schedule")
    dist = dcfg.pop("distillation")
    jsampler = JaxEDMSampler(jax_create(**dcfg),
                             JaxDenoiser(sigma_min=smin, sigma_max=smax,
                                         distillation=dist),
                             **cfg["sampler"])
    ckpt, _ = ckptlib.load_run_checkpoint(FIXTURE, "sampler", "last",
                                          torch_kind="unet_adm")
    params = jax.tree.map(jnp.asarray, ckpt["params"])
    sampler = load_sampler(cfg, state, "cpu", attn_impl="einsum",
                           up_impl="resize", gn_stats="fp32")
    x = golden["x_init"]
    y = golden["y"]
    key = jax.random.key(7)
    for t in (0, 9):
        ref = jsampler.sample_step(params, jnp.asarray(x.transpose(0, 2, 3, 1)),
                                   jnp.full((8,), t, jnp.int32), key,
                                   y=jnp.asarray(y, jnp.int32))
        noise = np.asarray(jax.random.normal(key, (8, 16, 16, 3)))
        with torch.no_grad():
            out = sampler.sample_step(
                torch.from_numpy(x), t,
                torch.from_numpy(noise.transpose(0, 3, 1, 2).copy()),
                torch.from_numpy(y).long())
        for k in ("sample", "mean", "control"):
            np.testing.assert_allclose(
                out[k].numpy(), np.asarray(ref[k]).transpose(0, 3, 1, 2),
                rtol=0, atol=5e-3, err_msg=f"step {t} {k}")
        for k, tol in (("sigma", 1e-5), ("entropy", 1e-5), ("logp", 5e-3),
                       ("logp_terminal", 0)):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-5, atol=tol,
                                       err_msg=f"step {t} {k}")
        x = out["sample"].numpy()


# ---- int8 (quant_int8, quant_attn) ------------------------------------------

def _imagenet64_net(**kw):
    cfg = dict(chip_smoke.imagenet64_t10()["diffusion"])
    for k in ("sigma_min", "sigma_max", "weight_schedule", "distillation"):
        cfg.pop(k)
    with torch.device("meta"):
        return create_unet_adm(**cfg, up_impl="phase",
                               gn_stats="bf16_onepass", **kw)


def test_imagenet64_int8_launch_table(monkeypatch):
    """The launches per forward that chip_smoke.py checks in phase E2-int8,
    at the full-width ImageNet64 net with --int8 (quant_int8='static',
    attn_impl='fused', so quant_attn='static'): K5 at all 22 attention
    blocks, K8 at the 72 ResBlock 3x3 convs with each of the 3 up-blocks'
    first conv as 4 phase convs (81), K1 73, K2 none."""
    net = _imagenet64_net(attn_impl="fused", quant_int8="static")
    assert sum(isinstance(m, QConv) for m in net.modules()) == 69
    assert sum(isinstance(m, AttentionBlockADM) and m.int8
               for m in net.modules()) == 22
    counts = _count_launches(monkeypatch, net.cast_weights(), 64)
    assert counts == chip_smoke.ADM_LAUNCHES_PER_FORWARD["int8"]


def test_cast_weights_keeps_int8_layers_fp32():
    """The int8 layers quantise from fp32 weights, as the JAX package does
    from its fp32 parameters; every other conv and linear weight is bf16."""
    net = _imagenet64_net(attn_impl="fused", quant_int8="static")
    net.cast_weights()
    for m in net.modules():
        if isinstance(m, QConv):
            assert m.weight.dtype == m.bias.dtype == torch.float32
            assert m.out_dtype == torch.bfloat16
        elif isinstance(m, AttentionBlockADM):
            assert m.qkv.weight.dtype == m.proj_out.weight.dtype \
                == torch.float32
    assert net.input_blocks[0][0].weight.dtype == torch.bfloat16
    assert net.out[2].weight.dtype == torch.bfloat16


@pytest.mark.parametrize("kw,want", [
    (dict(attn_impl="fused", quant_int8="static"), "static"),
    (dict(attn_impl="flash", quant_int8="static"), False),
    (dict(attn_impl="fused", quant_int8=True), False),
    (dict(attn_impl="fused", quant_int8="static", quant_attn=False), False)])
def test_quant_attn_default(kw, want):
    """quant_attn=None resolves as the JAX factory does: on exactly when
    quant_int8 == 'static' and attn_impl == 'fused'."""
    from dxmi_tpu.models.unet_adm import create_unet_adm as jax_create
    net = _imagenet64_net(**kw)
    on = any(isinstance(m, AttentionBlockADM) and m.int8
             for m in net.modules())
    assert on == bool(want)
    cfg = dict(chip_smoke.imagenet64_t10()["diffusion"])
    for k in ("sigma_min", "sigma_max", "weight_schedule", "distillation"):
        cfg.pop(k)
    assert jax_create(**cfg, **kw).quant_attn == want


def _jax_int8(cfg, params, x, t, y, jdt, **kw):
    """JAX's calibrate (from zero scales) and int8 apply on one batch;
    returns (scales, output NCHW)."""
    net = JaxUNetADM(**cfg, dtype=jdt, quant_int8="static", **kw)
    R = cfg["image_size"]
    shapes = jax.eval_shape(net.init, jax.random.key(0),
                            jnp.zeros((1, R, R, 3)), jnp.zeros((1,)),
                            jnp.zeros((1,), jnp.int32))["quant_scales"]
    zeros = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)
    args = (jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t),
            jnp.asarray(y))
    _, upd = net.apply({"params": params, "quant_scales": zeros}, *args,
                       mutable=["quant_scales"])
    out = net.apply({"params": params, "quant_scales": upd["quant_scales"]},
                    *args)
    return upd["quant_scales"], np.asarray(out, np.float32).transpose(0, 3,
                                                                      1, 2)


def _port_int8(cfg, state, x, t, y, tdt, jax_scales, **kw):
    """The port's calibrating pass and, with JAX's scales loaded, its int8
    forward; returns (its own scales, output)."""
    net = UNetADM(**cfg, dtype=tdt, quant_int8="static", **kw)
    net.load_state_dict(state, strict=False)
    net.cast_weights()
    args = (torch.from_numpy(x), torch.from_numpy(t),
            torch.from_numpy(y).long())
    with torch.no_grad():
        net.set_calibrating(True)
        net(*args)
        net.set_calibrating(False)
        ours = {k: v.clone() for k, v in net.state_dict().items()
                if k.endswith(("act_scale", "attn_proj_scale"))}
        net.load_state_dict(adm_quant_scales_from_flax(
            jax.tree.map(np.asarray, jax_scales)), strict=False)
        net.prepare_int8()
        out = net(*args).numpy()
    return ours, out


INT8_ROUTES = [dict(attn_impl="einsum"),
               dict(attn_impl="fused", quant_attn="static", up_impl="phase")]


@functools.lru_cache(maxsize=None)
def _int8_fp32_case(route):
    """JAX's side of the 16x16 fp32 int8 net on one route: its calibrated
    scales, its int8 output and its full-precision output."""
    kw = INT8_ROUTES[route]
    params = _seeded_flax_params(NETS[16], seed=5)
    x, t, y = _inputs(16, seed=1)
    scales, ref = _jax_int8(NETS[16], params, x, t, y, jnp.float32, **kw)
    fp = JaxUNetADM(**NETS[16]).apply(
        {"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1)),
        jnp.asarray(t), jnp.asarray(y))
    return params, (x, t, y), scales, ref, np.asarray(fp).transpose(0, 3, 1,
                                                                   2)


def _int8_net_gates(out, ref, fp):
    """The port's int8 output against JAX's, read as G2-int8 reads an int8
    step (chip_smoke.py): against the int8 effect |JAX int8 - JAX fp32|,
    the mean error within INT8_STEP_RATIO of the mean effect and the median
    within INT8_MEDIAN_RATIO of the median; and the median error within
    2^-16 of the largest output, the elements no rounding flip reached."""
    err, effect = np.abs(out - ref), np.abs(fp - ref)
    mean, median = err.mean() / effect.mean(), np.median(err) / np.median(
        effect)
    assert mean <= chip_smoke.INT8_STEP_RATIO, mean
    assert median <= chip_smoke.INT8_MEDIAN_RATIO, median
    assert rebuild_checks.median_share(out, ref) <= 1


@pytest.mark.parametrize("route", [0, 1], ids=["convs", "k5_k8_phase"])
def test_int8_fp32_net_matches_jax(monkeypatch, route):
    """The 16x16 net in fp32 with static int8: the calibrating pass records
    JAX's scales (rtol 1e-5 of each buffer's largest), and with JAX's
    scales loaded the int8 forward matches JAX's int8 apply under
    ``_int8_net_gates``. The fp32 orders of K1's statistics and of the
    attention core flip an int8 rounding now and then, and a flip moves
    many outputs: with K5, 0.021 at most and 50% of the elements beyond
    2^-16 of the largest on one host (7.8e-4 at most on another); the mean
    and median at 0.038 and 2e-4 of the int8 effect. Without K5: 1.3e-6."""
    monkeypatch.setenv("DXMI_FUSED_ATTN_FORCE", "1")
    kw = INT8_ROUTES[route]
    params, (x, t, y), scales, ref, fp = _int8_fp32_case(route)
    ours, out = _port_int8(NETS[16], unet_adm_from_flax(params), x, t, y,
                           torch.float32, scales, **kw)
    want = adm_quant_scales_from_flax(jax.tree.map(np.asarray, scales))
    assert set(ours) == set(want)
    for k, v in want.items():
        assert (ours[k] - v).abs().max() <= 1e-5 * v.abs().max(), k
    _int8_net_gates(out, ref, fp)


@pytest.mark.parametrize("route", [0, 1], ids=["convs", "k5_k8_phase"])
def test_int8_net_gates_see_one_scale_doubled(monkeypatch, route):
    """The gates refuse the port's net with one conv's activation scale
    doubled (0.17-0.18 of the effect on the median)."""
    monkeypatch.setenv("DXMI_FUSED_ATTN_FORCE", "1")
    params, (x, t, y), scales, ref, fp = _int8_fp32_case(route)
    doubled = jax.tree.map(np.array, scales)
    conv = doubled["output_blocks_0_0"]["in_layers_2"]
    conv["act_scale"] = 2 * conv["act_scale"]
    _, out = _port_int8(NETS[16], unet_adm_from_flax(params), x, t, y,
                        torch.float32, doubled, **INT8_ROUTES[route])
    with pytest.raises(AssertionError):
        _int8_net_gates(out, ref, fp)


def test_int8_bf16_net_matches_jax(monkeypatch):
    """The same net in bf16 (K5 at the 8x8 map, K8, the int8 phase
    up-block): with JAX's scales loaded, the port's int8 output is no
    further from JAX's fp32 int8 output than 1.5x JAX's own bf16 int8
    output is, and within 2x that distance of JAX's bf16 output (bf16
    rounding noise, as for the bf16 nets above; int8 rounding flips add to
    it, 3.4-4.3% between JAX's own bf16 and fp32 int8 nets, so that
    distance is capped at 6e-2 here instead of 3e-2)."""
    monkeypatch.setenv("DXMI_FUSED_ATTN_FORCE", "1")
    monkeypatch.setenv("DXMI_GN_STATS", "bf16_onepass")
    kw = INT8_ROUTES[1]
    params = _seeded_flax_params(NETS[16], seed=6)
    x, t, y = _inputs(16, seed=2)
    scales, ref = _jax_int8(NETS[16], params, x, t, y, jnp.bfloat16, **kw)
    _, ref32 = _jax_int8(NETS[16], params, x, t, y, jnp.float32, **kw)
    _, out = _port_int8(NETS[16], unet_adm_from_flax(params), x, t, y,
                        torch.bfloat16, scales, gn_stats="bf16_onepass",
                        **kw)
    noise = _rel(ref, ref32)
    assert noise < 6e-2, noise
    assert _rel(out, ref32) < 1.5 * noise, (_rel(out, ref32), noise)
    assert _rel(out, ref) < 2 * noise, (_rel(out, ref), noise)


def test_generate_large_cli_int8(tmp_path):
    """--int8 on the CPU: calibration, then the plain versions of K5 and
    K8; the npz streams samples and labels."""
    out = tmp_path / "adm8.npz"
    proc = _cli("--device", "cpu", "--int8", "--save_npz", str(out))
    assert proc.returncode == 0, proc.stderr
    assert "int8: static activation scales calibrated" in proc.stdout
    arr = np.load(out)
    assert arr["arr_0"].shape == (8, 16, 16, 3)
    assert arr["arr_0"].dtype == np.uint8
    assert arr["arr_1"].shape == (8,) and arr["arr_1"].dtype == np.int64
