"""The port's DDGAN family (``dxmi_tpu_torch.samplers.ddgan``, NCSN++, the
config aliases, the msgpack loaders, the CLIs) against dxmi_tpu's, on the
CPU: the schedule; ``sample_step`` and ``sample`` with JAX's threefry draws
replayed on the small net; the committed small golden (``ddgan_golden.npz``,
phase G6's check); the trained fixture ``tests/fixtures/
native_rundir_ddgan_t4`` at full width (fp32 within the JAX package's own
replay limits, the bf16 default within twice JAX's own bf16 effect); the
pretrained ``runs_conv/pre_ddgan800.msgpack`` bit for bit; and the entries
on ``configs/cifar10/T4_ddgan.yaml``.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dxmi_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp, NCSNppArgs
from dxmi_tpu.samplers import ddgan as jddgan
from dxmi_tpu_torch import train_cifar10
from dxmi_tpu_torch.config import instantiate, load_yaml, merge
from dxmi_tpu_torch.models.ncsnpp import NCSNpp
from dxmi_tpu_torch.samplers.ddgan import DDGANSampler, ddgan_schedule
from dxmi_tpu_torch.trainers.dxmi import DxMITrainer
from dxmi_tpu_torch.utils.checkpoint import (load_sampler_into,
                                             load_sampler_state)
from dxmi_tpu_torch.utils.convert import ddgan_sampler_from_flax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_fixtures"))
from make_ddgan_golden import ncsnpp_to_flax  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "native_rundir_ddgan_t4")
PRETRAINED = os.path.join(REPO, "runs_conv", "pre_ddgan800.msgpack")
FIXTURE_GOLDEN = os.path.join(REPO, "tests", "torch_fixtures",
                              "ddgan_fixture_golden.npz")
# the JAX package's own replay limits (test_golden_ddgan_fixture.py:53-66)
REPLAY_TOL, SIGMA_TOL = (2e-4, 2e-4), (1e-5, 1e-6)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(a, np.float32), -1, -3)))


def test_schedule_matches_jax():
    """ddgan_schedule equals JAX's to fp32 rounding (both float64 numpy,
    rounded once)."""
    for T in (1, 2, 4, 8):
        ours, ref = ddgan_schedule(T), jddgan.ddgan_schedule(T)
        for name in ours._fields:
            np.testing.assert_array_equal(getattr(ours, name),
                                          np.asarray(getattr(ref, name)))


def test_t4_ddgan_config_instantiates():
    """configs/cifar10/T4_ddgan.yaml's sampler, value and trainer build in
    the port (the NCSN++ alias raised KeyError, the trainer's
    value_resample NotImplementedError): NCSNppArgs' defaults, 47,942,019
    parameters."""
    cfg = load_yaml(chip_smoke.T4_DDGAN_CONFIG)
    net = instantiate(cfg["sampler_net"])
    assert isinstance(net, NCSNpp) and net.config.nf == 128
    sampler = instantiate(cfg["sampler"], net=net)
    assert isinstance(sampler, DDGANSampler)
    assert (sampler.n_timesteps, sampler.nz, sampler.sample_shape) == (
        4, 100, (3, 32, 32))
    assert sum(p.numel() for p in net.parameters()) == 47_942_019
    trainer = instantiate(cfg["trainer"], batchsize=8, n_timesteps=4)
    assert isinstance(trainer, DxMITrainer) and trainer.value_resample
    trainer.set_models(sampler, instantiate(cfg["value"]), 1e-7, 1e-5)
    np.testing.assert_array_equal(trainer.betas_for_q.numpy(),
                                  ddgan_schedule(4).eta)


@functools.lru_cache(maxsize=None)
def _jax_small():
    jnet = JaxNCSNpp(config=NCSNppArgs(**chip_smoke.DDGAN_SMALL))
    jsamp = jddgan.DDGANSampler(jnet, chip_smoke.DDGAN_T, (3, 16, 16))
    params = jsamp.init_params(jax.random.key(0), ncsnpp_to_flax(
        chip_smoke.ddgan_small_state()))
    # trained-looking sigmas: every step's own value
    params["log_betas"] = params["log_betas"] + jnp.asarray(
        [0.1, -0.2, 0.3, 0.4])
    return jsamp, params


def _port_small(params):
    sampler = chip_smoke.ddgan_small_sampler("cpu")
    load_sampler_into(sampler, ddgan_sampler_from_flax(
        jax.tree.map(np.asarray, params)))
    return sampler


def _step_draws(jsamp, key, shape):
    """sample_step's z and noise from its key (``ddgan.py:133-141``)."""
    k_z, k_n = jax.random.split(key)
    return (jax.random.normal(k_z, (shape[0], jsamp.nz)),
            jax.random.normal(k_n, shape))


@pytest.mark.parametrize("t", [2, "rows"])
def test_sample_step_matches_jax(t):
    """sample_step (t an int, or one step per row) with JAX's z and noise
    replayed: every entry of the d_step contract."""
    jsamp, params = _jax_small()
    rs = np.random.RandomState(3)
    x = rs.randn(4, 16, 16, 3).astype(np.float32)
    tt = jnp.asarray([0, 1, 2, 3]) if t == "rows" else t
    key = jax.random.key(9)
    ref = jsamp.sample_step(params, jnp.asarray(x), tt, key)
    z, noise = _step_draws(jsamp, key, x.shape)
    sampler = _port_small(params)
    with torch.no_grad():
        out = sampler.sample_step(
            _nchw(x), torch.as_tensor(np.asarray(tt)), _nchw(noise),
            z=torch.from_numpy(np.array(z)))
    assert set(out) == set(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        got = out[k].numpy()
        if v.ndim == 4:
            got = np.moveaxis(got, 1, -1)
        np.testing.assert_allclose(got, v, atol=2e-5, rtol=2e-5, err_msg=k)


def test_sample_matches_jax():
    """sample() with JAX's x0, z and noise replayed from ``sample``'s key
    schedule (``ddgan.py:206-238``): every entry of the d_sample
    contract."""
    jsamp, params = _jax_small()
    n, T = 4, chip_smoke.DDGAN_T
    ref = jsamp.sample(params, jax.random.key(4), n)
    key, k0 = jax.random.split(jax.random.key(4))
    x0 = jax.random.normal(k0, (n, 16, 16, 3))
    draws = [_step_draws(jsamp, k, (n, 16, 16, 3))
             for k in jax.random.split(key, T)]
    sampler = _port_small(params)
    with torch.no_grad():
        out = sampler.sample(n, x0=_nchw(x0),
                             eps=torch.stack([_nchw(e) for _, e in draws]),
                             z=torch.stack([torch.from_numpy(np.array(z))
                                            for z, _ in draws]))
    assert set(out) == set(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        got = out[k].numpy()
        if v.ndim >= 4:
            got = np.moveaxis(got, -3, -1)
        np.testing.assert_allclose(got, v, atol=2e-5, rtol=2e-5, err_msg=k)


def test_small_golden_replay():
    """Phase G6's check on the CPU (``chip_smoke.ddgan_small_replay``): fp32,
    bf16, the fp32 calibration (15 of 2720 channels, where JAX's init
    scales would win, left out) and both int8 paths against
    ddgan_golden.npz."""
    out = chip_smoke.ddgan_small_replay("cpu")
    worst, n_won, n_all = out["calib32"]
    assert n_won <= 0.01 * n_all, (n_won, n_all)
    assert out["fp32"] <= 2e-5


@functools.lru_cache(maxsize=None)
def _fixture_sampler(dtype):
    cfg = load_yaml(os.path.join(FIXTURE, "config.yaml"))
    net = instantiate(cfg["sampler_net"], dtype=dtype)
    sampler = instantiate(cfg["sampler"], net=net)
    load_sampler_into(sampler, load_sampler_state(
        os.path.join(FIXTURE, "sampler_best.msgpack"), net="ncsnpp"))
    return sampler.eval()


def test_trained_fixture_replay_fp32():
    """The trained fixture through the port's msgpack reader, fp32: its
    log_betas equal golden.npz's (rtol 1e-6), and the first 4 samples' T=4
    trajectory with JAX's recorded draws is within the JAX package's own
    replay limits of golden.npz on mean and sample (2e-4 + 2e-4 rel) and
    sigma."""
    g = np.load(os.path.join(FIXTURE, "golden.npz"))
    draws = np.load(FIXTURE_GOLDEN)
    sampler = _fixture_sampler(torch.float32)
    np.testing.assert_allclose(sampler.log_betas.detach().numpy(),
                               g["log_betas"], rtol=1e-6)
    n = draws["x0"].shape[0]
    with torch.no_grad():
        d = sampler.sample(n, x0=torch.from_numpy(draws["x0"]),
                           eps=torch.from_numpy(draws["eps"]),
                           z=torch.from_numpy(draws["z"]))
    atol, rtol = REPLAY_TOL
    np.testing.assert_allclose(np.moveaxis(d["sample"].numpy(), 1, -1),
                               g["sample"][:n], atol=atol, rtol=rtol)
    np.testing.assert_allclose(np.moveaxis(d["mean"].numpy(), 2, -1),
                               g["d_mean"][:, :n], atol=atol, rtol=rtol)
    np.testing.assert_allclose(d["sigma"].numpy(), g["d_sigma"][:, :n],
                               rtol=SIGMA_TOL[0], atol=SIGMA_TOL[1])


def test_trained_fixture_bf16_default():
    """generate_cifar10's default for NCSN++ (bf16) on the trained weights,
    each step from golden.npz's fp32 state with the recorded draws: the
    step mean's mean and largest error within twice JAX's own bf16 effect
    (JAX's bf16 step mean against golden.npz's fp32 one)."""
    g = np.load(os.path.join(FIXTURE, "golden.npz"))
    draws = np.load(FIXTURE_GOLDEN)
    sampler = _fixture_sampler(torch.bfloat16)
    n = draws["x0"].shape[0]
    for t in range(sampler.n_timesteps):
        x = _nchw(g["d_l_sample"][t, :n])
        with torch.no_grad():
            mean = sampler.sample_step(
                x, t, torch.from_numpy(draws["eps"][t]),
                z=torch.from_numpy(draws["z"][t]))["mean"].numpy()
        ref = draws["bf16/means"][t]
        eff = np.abs(ref - np.moveaxis(g["d_mean"][t, :n], -1, 1))
        err = np.abs(mean - ref)
        assert err.mean() <= chip_smoke.BF16_REPLAY_SHARE * eff.mean(), t
        assert err.max() <= chip_smoke.BF16_REPLAY_SHARE * eff.max(), t


def test_pretrained_loads_bit_for_bit():
    """runs_conv/pre_ddgan800.msgpack through the port's reader equals the
    JAX package's load_sampler_params, tensor by tensor, and loads into
    the full-width DDGANSampler with nothing missing."""
    from dxmi_tpu.utils.checkpoint import load_sampler_params

    ours = load_sampler_state(PRETRAINED, net="ncsnpp")
    ref = ddgan_sampler_from_flax(jax.tree.map(
        np.asarray, load_sampler_params(PRETRAINED)))
    assert set(ours) == set(ref) and "log_betas" in ours
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and torch.equal(ours[k], v), k
    sampler = DDGANSampler(NCSNpp(), 4, (3, 32, 32))
    sampler.load_state_dict(ours)


def _cfg(**training):
    cfg = merge(load_yaml(chip_smoke.T4_DDGAN_CONFIG),
                load_yaml(os.path.join(REPO, "configs", "cifar10",
                                       "cifar10.yaml")))
    cfg["sampler_net"]["config"].update(nf=16, ch_mult=[1, 2],
                                        num_res_blocks=1,
                                        attn_resolutions=[16])
    cfg["value"]["net"]["nh"] = 8
    cfg["training"].update({"batchsize": 8, **training})
    return cfg


def test_build_ncsnpp_checkpoints(tmp_path):
    """train_cifar10.build on NCSN++: a .msgpack sampler_ckpt loads, a .pth
    one raises (no converter, as in the JAX entry), a missing one warns and
    draws weights from the seed; --fast_levers raises."""
    small = chip_smoke.ddgan_small_sampler("cpu")
    state = {"params": {"net": ncsnpp_to_flax(
        {k[4:]: v for k, v in small.state_dict().items()
         if k.startswith("net.")}), "log_betas": np.zeros(4, np.float32)}}
    from flax import serialization
    path = tmp_path / "s.msgpack"
    path.write_bytes(serialization.msgpack_serialize(
        jax.tree.map(np.asarray, state)))
    cfg = _cfg(sampler_ckpt=str(path))
    cfg["sampler_net"]["config"] = {"_target_": cfg["sampler_net"][
        "config"]["_target_"], **chip_smoke.DDGAN_SMALL}
    cfg["sampler"]["sample_shape"] = [3, 16, 16]
    sampler, _, trainer = train_cifar10.build(cfg, torch.device("cpu"), 0)
    for k, v in small.net.state_dict().items():
        assert torch.equal(sampler.net.state_dict()[k], v), k
    assert torch.equal(sampler.log_betas.detach(), torch.zeros(4))
    pth = tmp_path / "s.pth"
    torch.save({"state_dict": {}}, pth)
    with pytest.raises(SystemExit, match="NCSN"):
        train_cifar10.build(_cfg(sampler_ckpt=str(pth)),
                            torch.device("cpu"), 0)
    with pytest.raises(ValueError, match="NCSNpp"):
        train_cifar10.build(_cfg(), torch.device("cpu"), 0, levers=True)
    _, _, trainer = train_cifar10.build(_cfg(batchsize=128),
                                        torch.device("cpu"), 0)
    assert trainer.sample_chunks == 4  # the JAX entry's 32-sample chunks


def _run(args, cwd):
    proc = subprocess.run([sys.executable, "-m", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=REPO,
                                   OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


def test_cli_train_then_generate(tmp_path):
    """train_cifar10 on T4_ddgan.yaml (small width, --fake_data, 2 steps,
    value_resample on) writes a run dir that generate_cifar10 reads in fp32,
    in its bf16 default and under --int8 (bf16, attention 1x1s in bf16)."""
    out = _run(["dxmi_tpu_torch.train_cifar10", "--config",
                chip_smoke.T4_DDGAN_CONFIG, "--dataset",
                os.path.join(REPO, "configs", "cifar10", "cifar10.yaml"),
                "--run", "cpu", "--fake_data", "--max_steps", "2",
                "--device", "cpu", "--sampler_net.config.nf", "16",
                "--sampler_net.config.ch_mult", "[1,2]",
                "--sampler_net.config.num_res_blocks", "1",
                "--sampler_net.config.attn_resolutions", "[16]",
                "--value.net.nh", "8", "--training.batchsize", "8",
                "--training.fid_epoch", "None"], tmp_path)
    assert "done: 2 iters" in out
    run = tmp_path / "results" / "cifar10" / "T4_ddgan" / "cpu"
    samples = {}
    for tag, extra in (("fp32", ["--dtype", "fp32"]), ("default", []),
                       ("int8", ["--int8"])):
        npz = tmp_path / f"{tag}.npz"
        out = _run(["dxmi_tpu_torch.generate_cifar10", "--log_dir",
                    str(run), "--sampler", "last", "--device", "cpu",
                    "--n_generate", "8", "--batchsize", "8", "--save_npz",
                    str(npz), *extra], tmp_path)
        assert ("bf16 compute torso" in out) == (tag != "fp32")
        arr = np.load(npz)["arr_0"]
        assert arr.shape == (8, 32, 32, 3) and arr.dtype == np.uint8
        samples[tag] = arr.astype(np.int64)
    # the same draws: bf16 moves few pixels by more than a few levels
    assert np.mean(np.abs(samples["default"] - samples["fp32"]) > 8) < 0.05
