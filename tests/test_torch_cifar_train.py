"""The CIFAR-10 training slice: one ``DxMITrainer`` iteration of the port on
the trained CIFAR fixture against ``dxmi_tpu``'s, with the JAX trainer's
trajectory, permutation, step noise and dropout masks replayed
(tests/torch_fixtures/make_cifar_train_golden.py); the committed golden that
chip_smoke.py (phase G4) holds the card to; ``VARSampler`` against the JAX
sampler; the data pipeline; ``sample_chunked``; E4's launch table counted
from the full-width net; E4's wiring check; and the ``train_cifar10`` CLI
followed by ``generate_cifar10`` on the run dir it writes."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_fixtures.trainer_cases import run_files
from dxmi_tpu.data import cifar10 as jax_cifar
from dxmi_tpu_torch.config import instantiate, parse_yaml
from dxmi_tpu_torch.data import cifar10 as port_cifar
from dxmi_tpu_torch.generate_cifar10 import load_sampler
from dxmi_tpu_torch.models import unet_small
from dxmi_tpu_torch.ops import _lib
from dxmi_tpu_torch.samplers import sample_chunked
from dxmi_tpu_torch.utils.checkpoint import load_sampler_state
from torch_fixtures import make_cifar_train_golden, rebuild_checks

REPO = chip_smoke.REPO


@pytest.fixture(scope="module")
def jax_run():
    return make_cifar_train_golden.build()


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(chip_smoke.CIFAR_TRAIN_GOLDEN))


def test_golden_rebuilds_from_jax(jax_run, golden):
    """The committed golden is what the JAX package computes today: inputs
    and masks bit-equal, results within ``rebuild_checks``' limits (the
    fp32 sum order of the host that runs it, held against the magnitude of
    each array's summands by family; 2^-7 of the largest for the sampler's
    RAdam update)."""
    built, _ = jax_run
    rebuild_checks.check_fp32_rebuild(built, golden)


@pytest.mark.parametrize("fam", ["metric/per_step", "value update",
                                 "l_sample"])
def test_golden_rebuild_sees_a_stale_golden(jax_run, golden, fam):
    """The rebuild's limits still see a golden whose largest array of a
    family is off by 1e-3 of its largest."""
    built, _ = jax_run
    keys = [k for k in golden if rebuild_checks.family(k) == fam]
    key = max(keys, key=lambda k: float(np.abs(golden[k]).max()))
    stale = dict(golden)
    stale[key] = golden[key] + 1e-3 * np.abs(golden[key]).max()
    with pytest.raises(AssertionError, match=key):
        rebuild_checks.check_fp32_rebuild(built, stale)


@pytest.mark.parametrize("impl,fuse,bb", [("einsum", False, None),
                                          ("fused", False, 1),
                                          ("fused", False, 2)])
def test_iteration_matches_jax(golden, impl, fuse, bb):
    """The port's iteration against the JAX package's with unfused
    convolutions: einsum attention, and fused at bb 1 (K2's plain version)
    and bb 2 (K7's), under chip_smoke's G3 gates (metrics 1e-3 of each
    vector's largest, value update 1e-3, log_betas 1e-5, each sampler tensor
    5% plus 1% of the largest; 6.9e-6, 7.1e-6 and 0.03 of the limit
    measured)."""
    port = chip_smoke.cifar_train_replay(golden, "cpu", impl, fuse, bb)
    m, v, s = chip_smoke.train_golden_check(port, golden, impl)
    assert m < chip_smoke.G3_METRIC_REL and v < chip_smoke.G3_VALUE_REL
    assert s < 1


@pytest.mark.parametrize("bb", [1, 2])
def test_iteration_with_k3_matches_jax(golden, bb):
    """With K3 (fuse_gn_conv): its forward rounds the conv operands to bf16
    where the JAX CPU run does not, which G4's K3 gates allow for (metrics
    2e-3, the sampler update's norms and projections 0.2 relative; 5.7e-4
    and 0.056 measured)."""
    port = chip_smoke.cifar_train_replay(golden, "cpu", "fused", True, bb)
    m, s = chip_smoke.k3_golden_check(port, golden, f"K3 bb {bb}")
    assert m < chip_smoke.G4_K3_METRIC_REL and s < chip_smoke.G4_K3_SAMPLER_REL


def test_dropout_masks_matter(golden):
    """The replay needs JAX's masks: the same iteration with the masks of
    another draw moves the sampler update far past G3's gate."""
    shuffled = dict(golden)
    for k in golden:
        if k.startswith("dropout/"):
            shuffled[k] = np.roll(golden[k], 1)
    port = chip_smoke.cifar_train_replay(shuffled, "cpu")
    with pytest.raises(AssertionError):
        chip_smoke.train_golden_check(port, golden, "wrong masks")


def test_iteration_launches_nothing_on_the_cpu(golden):
    _lib.reset_launches()
    chip_smoke.cifar_train_replay(golden, "cpu", "fused", True, 2)
    assert not _lib.LAUNCHES


@pytest.fixture(scope="module")
def fixture_sampler():
    cfg = chip_smoke.fixture_config()
    state = load_sampler_state(os.path.join(chip_smoke.FIXTURE_DIR,
                                            "sampler_best.pth"))
    jnet = instantiate_jax(cfg)
    from dxmi_tpu.utils import checkpoint as ckptlib
    ckpt, _ = ckptlib.load_run_checkpoint(chip_smoke.FIXTURE_DIR, "sampler",
                                          "best", torch_kind="unet_small")
    params = jax.tree.map(jnp.asarray, ckpt["params"])
    return cfg, state, jnet, params


def instantiate_jax(cfg):
    from dxmi_tpu import config as cfglib
    net = cfglib.instantiate(cfg["sampler_net"])
    return cfglib.instantiate(cfg["sampler"], net=net)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a), -1, 1)))


def test_var_sample_step_matches_jax(fixture_sampler):
    """sample_step with a per-row t (B,) and JAX's noise injected: the whole
    d_step contract (sample, mean, control, sigma, logp, logp_terminal,
    entropy) within fp32 noise (1e-4), in eval mode and, with JAX's dropout
    masks replayed, in training mode."""
    cfg, state, jsampler, params = fixture_sampler
    sampler = load_sampler(cfg, state, "cpu", fuse_gn_conv=False,
                           attn_impl="einsum")
    rs = np.random.RandomState(3)
    x = rs.randn(4, 16, 16, 3).astype(np.float32)
    t = np.array([0, 3, 7, 9])
    key = jax.random.key(11)
    noise = jax.random.normal(key, x.shape, jnp.float32)
    for train in (False, True):
        if train:
            masks, ref = make_cifar_train_golden.dropout_masks(
                jsampler, params, jnp.asarray(x), jnp.asarray(t), key,
                jax.random.key(12))
            sampler.net.inject_dropout_masks([_nchw(m) for m in masks])
        else:
            ref = jsampler.sample_step(params, jnp.asarray(x), jnp.asarray(t),
                                       key)
        with torch.no_grad():
            out = sampler.sample_step(_nchw(x), torch.from_numpy(t),
                                      noise=_nchw(noise), train=train)
        assert set(out) == set(ref)
        for k, v in ref.items():
            v = np.asarray(v)
            got = out[k].numpy()
            if got.ndim == 4:
                got = np.moveaxis(got, 1, -1)
            np.testing.assert_allclose(got, v, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{k} train={train}")


def test_var_sample_and_log_prob_match_jax(fixture_sampler):
    """sample() with JAX's x0 and per-step noise (its key schedule,
    var.py:177-190) gives JAX's d_sample (every entry); log_prob_step
    equals JAX's on the same transitions."""
    cfg, state, jsampler, params = fixture_sampler
    sampler = load_sampler(cfg, state, "cpu", fuse_gn_conv=False,
                           attn_impl="einsum")
    key = jax.random.key(21)
    ref = jsampler.sample(params, key, 4)
    k, init_key = jax.random.split(key)
    x0 = jax.random.normal(init_key, (4, 16, 16, 3), jnp.float32)
    eps = [jax.random.normal(sk, (4, 16, 16, 3), jnp.float32)
           for sk in jax.random.split(k, sampler.n_timesteps)]
    with torch.no_grad():
        out = sampler.sample(4, x0=_nchw(x0),
                             eps=torch.stack([_nchw(e) for e in eps]))
    assert set(out) == set(ref)
    for name, v in ref.items():
        got = out[name].numpy()
        if got.ndim >= 4:
            got = np.moveaxis(got, -3, -1)
        np.testing.assert_allclose(got, np.asarray(v), rtol=1e-4, atol=2e-4,
                                   err_msg=name)
    xs = np.asarray(ref["l_sample"])
    t = np.array([1, 4, 6, 8])
    xp, xn = xs[t, np.arange(4)], xs[t + 1, np.arange(4)]
    want = jsampler.log_prob_step(params, jnp.asarray(xp), jnp.asarray(xn),
                                  jnp.asarray(t))
    with torch.no_grad():
        got = sampler.log_prob_step(_nchw(xp), _nchw(xn), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_fix_last_pins_the_last_sigma(fixture_sampler):
    """trainable_beta='fix_last': the last sigma is 1e-3 and log_betas[-1]
    gets a zero gradient, as in JAX."""
    cfg, state, _, _ = fixture_sampler
    sampler = load_sampler(cfg, state, "cpu")
    sig = sampler.sigmas_all()
    assert float(sig[-1].detach()) == pytest.approx(1e-3)
    sig.sum().backward()
    assert sampler.log_betas.grad[-1] == 0
    assert (sampler.log_betas.grad[:-1] != 0).all()


def test_fake_cifar_and_epoch_loader_bit_equal_to_jax():
    ours, theirs = port_cifar.fake_cifar(300, 5), jax_cifar.fake_cifar(300, 5)
    np.testing.assert_array_equal(ours.images, theirs.images)
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    a = list(port_cifar.EpochLoader(ours, 64, seed=9).epoch(2))
    b = list(jax_cifar.EpochLoader(theirs, 64, seed=9).epoch(2))
    assert len(a) == len(b) == 4
    for (xa, ya), (xb, yb) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    noise = port_cifar.fake_cifar(16, 1, structured=False)
    np.testing.assert_array_equal(
        noise.images, jax_cifar.fake_cifar(16, 1, structured=False).images)


def test_cifar10_missing_folder_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="CIFAR-10 not found"):
        port_cifar.get_dataset("cifar10", str(tmp_path))


def test_sample_chunked_var_trajectory(fixture_sampler):
    """Chunks of a VAR trajectory merge on each entry's batch axis: sample and
    logp_terminal on axis 0, the (T, B) and (T+1, B) entries on axis 1."""
    cfg, state, _, _ = fixture_sampler
    sampler = load_sampler(cfg, state, "cpu")
    with torch.no_grad():
        got = sample_chunked(sampler, 4, 2, torch.Generator().manual_seed(3))
        gen = torch.Generator().manual_seed(3)
        parts = [sampler.sample(2, generator=gen) for _ in range(2)]
    for k, v in got.items():
        dim = 0 if k in ("sample", "logp_terminal") else 1
        torch.testing.assert_close(v, torch.cat([p[k] for p in parts], dim))
    assert got["logp"].shape == (10, 4) and got["logp_terminal"].shape == (4,)


@pytest.mark.parametrize("with_y", [False, True])
def test_sample_chunked_edm_trajectory(with_y):
    """An EDM trajectory (logp_terminal (B,), y) in two chunks, with labels
    given (split per chunk) and drawn."""
    from dxmi_tpu_torch import generate_large
    cfg = chip_smoke.adm_fixture_config()
    state = load_sampler_state(os.path.join(chip_smoke.ADM_FIXTURE_DIR,
                                            "sampler.pth"))
    sampler = generate_large.load_sampler(cfg, state, "cpu")
    y = torch.tensor([0, 1, 2, 3]) if with_y else None
    with torch.no_grad():
        got = sample_chunked(sampler, 4, 2, torch.Generator().manual_seed(2),
                             y=y)
        gen = torch.Generator().manual_seed(2)
        parts = [sampler.sample(2, generator=gen,
                                **({} if y is None else {"y": y[2 * i:
                                                            2 * i + 2]}))
                 for i in range(2)]
    assert got["y"].shape == (4,) and got["logp_terminal"].shape == (4,)
    if with_y:
        torch.testing.assert_close(got["y"], y)
    for k, v in got.items():
        dim = 0 if k in ("sample", "logp_terminal", "y") else 1
        torch.testing.assert_close(v, torch.cat([p[k] for p in parts], dim))


def test_sample_chunked_keeps_none():
    class Stub:
        def sample(self, n, generator=None):
            return {"sample": torch.zeros(n, 1), "y": None,
                    "sigma": torch.ones(3, n)}

    got = sample_chunked(Stub(), 4, 2)
    assert got["y"] is None and got["sigma"].shape == (3, 4)


def _count_launches(monkeypatch, net, train):
    """Kernel wrappers counted on the meta device for one forward."""
    counts = {}

    def counter(name, shape_of):
        def fn(*args, **kwargs):
            key = name
            if name == "attn_block":
                B, S, C = args[0].shape
                from dxmi_tpu_torch.ops.attn_block import resolve_block_b
                if resolve_block_b(B, S, C, kwargs.get("block_b")) > 1:
                    key = "attn_block_bb"
            counts[key] = counts.get(key, 0) + 1
            return torch.empty(shape_of(*args), device="meta")
        return fn

    monkeypatch.setattr(unet_small, "group_norm",
                        counter("gn_silu", lambda x, *a: x.shape))
    monkeypatch.setattr(unet_small, "gn_silu_conv", counter(
        "gn_silu_conv3x3", lambda x, s, b, k, *a: (*x.shape[:3], k.shape[-1])))
    monkeypatch.setattr(unet_small, "attn_block",
                        counter("attn_block", lambda x, *a: x.shape))
    net.train(train)
    B = 128 if train else 32
    net(torch.empty(B, 3, 32, 32, device="meta"),
        torch.empty(B, device="meta"))
    return counts


@pytest.mark.parametrize("bb", [1, 4])
def test_e4_launch_table(monkeypatch, bb):
    """chip_smoke.E4_LAUNCHES_PER_STEP from the full-width CIFAR-10 net:
    E4_SAMPLE_FORWARDS eval forwards at the sampling chunk's batch 32 and one
    training-mode forward at the minibatch's 128, under
    DXMI_FUSED_ATTN_BB=bb."""
    monkeypatch.setenv("DXMI_FUSED_ATTN_BB", str(bb))
    cfg = chip_smoke.cifar10_train_config()
    with torch.device("meta"):
        net = instantiate(cfg["sampler_net"])
    fwd = _count_launches(monkeypatch, net, train=False)
    trn = _count_launches(monkeypatch, net, train=True)
    assert cfg["training"]["batchsize"] == chip_smoke.E4_BATCH == 4 * 32
    want = {k: v * chip_smoke.E4_SAMPLE_FORWARDS + trn.get(k, 0)
            for k, v in fwd.items()}
    assert want == chip_smoke.E4_LAUNCHES_PER_STEP[bb]


def test_wiring_check_cifar(monkeypatch):
    """E4's wiring readings at a shrunken width on the CPU (fp32, K3's plain
    version, whose bf16 forward rounding differs between the paths' inputs):
    the three paths agree inside the gates, and a planted fault in the fused
    block's backward (the GroupNorm scale and bias cotangents swapped) fails
    the group gate while the whole gradient stays under its own."""
    cfg = chip_smoke.cifar10_train_config()
    cfg["sampler_net"].update(ch=32, ch_mult=[1, 2], num_res_blocks=1,
                              attn_resolutions=[16])
    cfg["value"]["net"]["nh"] = 16
    cfg["training"]["batchsize"] = 8
    grads, groups = chip_smoke.e4_grads(cfg, "cpu")
    for a, b in chip_smoke.E4_PAIRS:
        whole, worst, _ = chip_smoke.wiring_readings(grads[a], grads[b],
                                                     groups)
        print(f"{a} vs {b}: whole {whole:.4f}, worst group {worst:.4f}")
        assert whole < chip_smoke.E3_GRAD_REL
        assert worst < chip_smoke.E3_GROUP_REL
    from dxmi_tpu_torch.ops import attn_block as ops

    bwd = ops.AttnBlockFn.backward

    def swapped(ctx, ct):
        g = list(bwd(ctx, ct))
        g[1], g[2] = g[2], g[1]
        return tuple(g)

    monkeypatch.setattr(ops.AttnBlockFn, "backward", staticmethod(swapped))
    bad, groups = chip_smoke.e4_grads(cfg, "cpu")
    whole, worst, group = chip_smoke.wiring_readings(bad["fused_bb4"],
                                                     grads["einsum"], groups)
    print(f"planted: whole {whole:.4f}, worst group {worst:.4f} ({group})")
    assert worst > chip_smoke.E3_GROUP_REL, (worst, group)
    assert whole < chip_smoke.E3_GRAD_REL


def test_train_cli_then_generate(tmp_path):
    """train_cifar10 --device cpu --fake_data for 2 steps on chip_smoke's
    shrunken config, then generate_cifar10 on the run dir it wrote."""
    train, gen, log_dir = chip_smoke.cifar_train_cli_commands("cli", "cpu")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(train, cwd=tmp_path, capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert [l.split(" d_loss")[0] for l in lines if l.startswith("iter")] \
        == ["iter 0", "iter 1"]
    assert any(l.startswith("epoch 0 sample_norm_=") for l in lines)
    assert "FID skipped: no Inception weights on disk" in lines
    assert "trajectory sampling in 1 chunk(s)" in lines
    assert lines[-1] == "done: 2 iters"
    run = tmp_path / log_dir
    assert run_files(run) == ["config.yaml", "sampler_last.pth",
                              "train_state.msgpack", "value_last.pth"]
    cfg = parse_yaml((run / "config.yaml").read_text())
    assert cfg["sampler_net"]["ch"] == 32 and cfg["training"][
        "batchsize"] == 8
    sd = torch.load(run / "sampler_last.pth", weights_only=True)
    assert "log_betas" in sd["state_dict"] and sd["iter"] == 2
    proc = subprocess.run(gen, cwd=tmp_path, capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = np.load(run / "samples.npz")
    assert got["arr_0"].shape == (8, 32, 32, 3)


def test_auto_chunk_rule():
    """At the config's batch 128 the trajectory is sampled in 4 chunks of 32
    (train_cifar10.py:61-72); a config value pins it."""
    from dxmi_tpu_torch import train_cifar10

    cfg = chip_smoke.cifar10_train_config()
    cfg["sampler_net"].update(ch=32, ch_mult=[1, 2], num_res_blocks=1,
                              attn_resolutions=[16])
    cfg["value"]["net"]["nh"] = 16
    _, _, trainer = train_cifar10.build(cfg, torch.device("cpu"), 0)
    assert trainer.sample_chunks == 4
    cfg["trainer"]["sample_chunks"] = 2
    _, _, trainer = train_cifar10.build(cfg, torch.device("cpu"), 0)
    assert trainer.sample_chunks == 2


@pytest.mark.parametrize("flag", ["--resume", "--wandb", "--fast_levers"])
def test_entry_flags(flag, tmp_path):
    """One step at the shrunken config with each flag. --resume on the run
    dir of a first step starts at its iteration (JAX's line); --wandb
    without wandb installed says so and trains on (the JAX entry's
    ``init_wandb``); --fast_levers applies the JAX entry's overrides
    (train_cifar10.py:164-174) and says so (test_torch_cifar_levers.py
    holds the overrides and the iteration)."""
    train, _, _ = chip_smoke.cifar_train_cli_commands("flag", device="cpu")
    i = train.index("--max_steps")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")

    def run(*extra, steps="1"):
        proc = subprocess.run([*train[:i + 1], steps, *train[i + 2:],
                               *extra], cwd=tmp_path, capture_output=True,
                              text=True, timeout=300, env=env)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return proc.stdout

    if flag == "--resume":
        run()
        out = run(flag, steps="2")
        assert "resumed full train state at epoch 0, iter 1" in out
        assert [l.split(" d_loss")[0] for l in out.splitlines()
                if l.startswith("iter")] == ["iter 1"]
    elif flag == "--wandb":
        out = run(flag)
        assert "wandb not installed — --wandb ignored" in out
        assert out.splitlines()[-1] == "done: 1 iters"
    else:
        out = run(flag)
        assert "fast_levers: bf16 sampler and value torso" in out
        assert "trajectory sampling in 1 chunk(s)" in out


def test_train_image_large_with_sample_chunks(tmp_path):
    """train_image_large --trainer.sample_chunks 2 on the CPU: the chunked
    EDM trajectory (logp_terminal (B,), drawn labels) feeds the buffer."""
    train, _, _ = chip_smoke.train_cli_commands("chunks", device="cpu")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(train + ["--trainer.sample_chunks", "2"],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "done"
