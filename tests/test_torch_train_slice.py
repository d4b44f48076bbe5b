"""The training slice as a whole: one ``DxMITrainerCond`` iteration
(``update_f_v`` + ``update_sampler``) of the port on the trained ADM fixture
against ``dxmi_tpu``'s, from the same parameters, data batch, labels and
trajectory, with the JAX trainer's own draws replayed from its key schedule
(tests/torch_fixtures/make_adm_train_golden.py); the committed golden that
chip_smoke.py (phase G3) holds the card to; the training CLI and the
generation CLI on the run dir it writes; and the trainer's configuration
surface (config overrides, the folder loader's refusal of a missing
folder)."""
import os
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from torch_fixtures.trainer_cases import run_files
from dxmi_tpu_torch.config import (merge, parse_nested_args, parse_unknown_args,
                                   parse_yaml, to_yaml)
from dxmi_tpu_torch.trainers.dxmi import DxMITrainer
from dxmi_tpu_torch.trainers.dxmi_cond import DxMITrainerCond
from torch_fixtures import make_adm_train_golden, rebuild_checks

REPO = chip_smoke.REPO


@pytest.fixture(scope="module")
def jax_run():
    return make_adm_train_golden.build()


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(chip_smoke.TRAIN_GOLDEN))


def test_golden_rebuilds_from_jax(jax_run, golden):
    """The committed golden is what the JAX package computes today: inputs
    bit-equal, results within ``rebuild_checks``' limits (the fp32 sum
    order of the host that runs it, held against the magnitude of each
    array's summands by family; 2^-7 of the largest for the sampler's RAdam
    update)."""
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


@pytest.mark.parametrize("impl", ["einsum", "fused_train"])
def test_iteration_matches_jax(golden, impl):
    """The port's iteration against the JAX package's, einsum and fused_train
    (K6's plain version on the CPU), under chip_smoke's G3 gates: every
    metric within 1e-3 of its vector's largest, the value update within
    1e-3, log_betas within 1e-5, each sampler tensor's update within 5% plus
    1% of the largest (2.2e-5, 5e-6 and 0.23 of the limit measured)."""
    port = chip_smoke.adm_train_replay(golden, "cpu", impl)
    m, v, s = chip_smoke.train_golden_check(port, golden, impl)
    assert m < chip_smoke.G3_METRIC_REL and v < chip_smoke.G3_VALUE_REL
    assert s < 1


def test_parameters_match_jax_elementwise(jax_run):
    """The full parameter states after the iteration: the value net within
    1e-4 relative of its update's norm per tensor (fp32 Adam steps on
    near-equal gradients), the sampler net's update within 1e-2 of its norm
    over the whole net (RAdam's rectified steps turn gradients at the noise
    floor into +-lr steps; 1.2e-3 measured through the projections), and
    every update well above fp32 rounding."""
    built, full = jax_run
    from dxmi_tpu_torch import generate_large
    from dxmi_tpu_torch.config import instantiate
    from dxmi_tpu_torch.trainers.buffer import from_d_sample
    from dxmi_tpu_torch.utils.checkpoint import (load_sampler_state,
                                                 load_value_state)

    cfg = chip_smoke.adm_fixture_config()
    fixture = chip_smoke.ADM_FIXTURE_DIR
    sampler = generate_large.load_sampler(
        cfg, load_sampler_state(os.path.join(fixture, "sampler.pth")), "cpu",
        attn_impl="einsum", up_impl="resize", gn_stats="fp32")
    value = instantiate(cfg["value"])
    value.load_state_dict(load_value_state(os.path.join(fixture,
                                                        "value.pth")))
    tcfg = {k: v for k, v in cfg["trainer"].items() if k != "_target_"}
    trainer = DxMITrainerCond(**{**tcfg, "batchsize": 8})
    trainer.set_models(sampler, value, lr=float(built["case/lr"]),
                       v_lr=float(built["case/v_lr"]),
                       beta_lr=float(built["case/beta_lr"]))
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in built.items()}
    buf = from_d_sample({"l_sample": t["l_sample"],
                         "mean": torch.zeros_like(t["l_sample"][1:]),
                         "sigma": t["sigma"], "logp": t["logp"],
                         "entropy": t["entropy"], "y": t["traj_y"]})
    trainer.update_f_v(t["img"], buf, y=t["y"])
    trainer.update_sampler(buf, perm=t["perm"], noise=list(t["noise"]))

    v_after = value.state_dict()
    for k, after in full["value_after"].items():
        delta = (after - full["value_before"][k]).double()
        got = (v_after[k] - full["value_before"][k]).double()
        assert delta.norm() > 1e3 * 2 ** -24 * after.abs().max(), k
        assert (got - delta).norm() <= 1e-4 * delta.norm() + 1e-9, k
    s_after = {f"net.{k}": v for k, v in sampler.net.state_dict().items()}
    s_after["log_betas"] = sampler.log_betas.detach()
    num = den = 0.0
    for k, after in full["sampler_after"].items():
        delta = (after - full["sampler_before"][k]).double()
        got = (s_after[k] - full["sampler_before"][k]).double()
        num += float(((got - delta) ** 2).sum())
        den += float((delta ** 2).sum())
    assert np.sqrt(num / den) < 1e-2
    lb = full["sampler_after"]["log_betas"] - full["sampler_before"][
        "log_betas"]
    assert float(lb[:-1].abs().max()) > 1e-6 and float(lb[-1]) == 0.0


def test_iteration_launches_nothing_on_the_cpu(golden):
    from dxmi_tpu_torch.ops import _lib

    _lib.reset_launches()
    chip_smoke.adm_train_replay(golden, "cpu", "fused_train")
    assert not _lib.LAUNCHES


def test_train_cli_then_generate(tmp_path):
    """train_image_large --device cpu --fake_data for 2 steps on chip_smoke's
    shrunken config, then generate_large on the run dir it wrote: the JAX
    entry's log lines, no skipped update, a reference-format run dir, and
    finite samples of the run's shape."""
    train, gen, log_dir = chip_smoke.train_cli_commands("cli", device="cpu")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(train, cwd=tmp_path, capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert [l.split(" d_loss")[0] for l in lines if l.startswith("iter")] \
        == ["iter 0", "iter 1"]
    assert "nan-guard skips: 0" in lines and lines[-1] == "done"
    run = tmp_path / log_dir
    assert run_files(run) == ["config.yaml", "sampler_last.pth",
                              "train_state.msgpack", "value_last.pth"]
    cfg = parse_yaml((run / "config.yaml").read_text())
    assert cfg["diffusion"]["image_size"] == 16 and cfg["training"][
        "batchsize"] == 8
    sd = torch.load(run / "sampler_last.pth", weights_only=True)
    assert "log_betas" in sd["state_dict"] and sd["i_iter"] == 2
    proc = subprocess.run(gen, cwd=tmp_path, capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = np.load(run / "samples.npz")
    assert got["arr_0"].shape == (8, 16, 16, 3) and got["arr_0"].dtype == \
        np.uint8
    assert got["arr_1"].shape == (8,) and got["arr_1"].max() < 4


def test_overrides_merge_and_write_back():
    """The JAX entry's override surface: typed --a.b value pairs, nested and
    merged over the configs; to_yaml writes what parse_yaml reads back."""
    over = parse_nested_args(parse_unknown_args(
        ["--training.batchsize", "8", "--diffusion.use_fp16", "False",
         "--sampler.sample_shape", "[3,16,16]", "--training.lr", "1e-4",
         "--value.net.nh", "16", "--training.fid_every", "None"]))
    base = chip_smoke.imagenet64_train_config()
    cfg = merge(base, over)
    assert cfg["training"]["batchsize"] == 8 and cfg["training"]["lr"] == 1e-4
    assert cfg["diffusion"]["use_fp16"] is False
    assert cfg["sampler"]["sample_shape"] == [3, 16, 16]
    assert cfg["value"]["net"]["nh"] == 16 and cfg["training"][
        "fid_every"] is None
    assert cfg["value"]["net"]["_target_"] == base["value"]["net"]["_target_"]
    assert parse_yaml(to_yaml(cfg)) == cfg


def test_instantiates_the_configs_targets():
    from dxmi_tpu_torch.config import instantiate
    from dxmi_tpu_torch.models.igebm import IGEBMEncoder
    from dxmi_tpu_torch.models.value import TimeIndependentValue

    cfg = chip_smoke.imagenet64_train_config()
    cfg["value"]["net"]["nh"] = 8
    value = instantiate(cfg["value"])
    assert isinstance(value, TimeIndependentValue)
    assert isinstance(value.net, IGEBMEncoder)
    trainer = instantiate(cfg["trainer"], batchsize=4)
    assert isinstance(trainer, DxMITrainerCond)
    assert (trainer.beta_ordering, trainer.sampler_optimizer,
            trainer.nan_guard, trainer.sampler_grad_clip) == (
        "forward", "radam", True, None)


@pytest.mark.parametrize("kwargs", [
    {"value_update_order": "shuffle"}, {"value_update_order": "random"},
    {"value_resample": True, "repeat_value_update": 2},
    {"aug": lambda x, k: x},
    {"repeat_value_update": 2}])
def test_ported_options_run(kwargs):
    """Each option that the trainer once refused runs a whole iteration
    (``train_step``, draws from the generator) with finite metrics;
    test_torch_trainer_options.py holds each against JAX."""
    from dxmi_tpu_torch.trainers.dxmi import train_step
    from torch_fixtures import trainer_cases

    trainer = trainer_cases.port_trainer("cifar", **kwargs)
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(trainer_cases.B, 3, 16, 16, generator=gen) * 2 - 1
    m = train_step(trainer, x, None, gen)
    assert all(bool(torch.isfinite(torch.as_tensor(v)).all())
               for v in m.values())
    assert sorted(m["per_step/t"].tolist()) == list(range(trainer_cases.T))
    assert trainer.opt_v.count == 1 + trainer_cases.T * int(
        kwargs.get("repeat_value_update", 1))


def test_separate_energy_runs():
    """With a separate energy net f the contrastive step trains f, not the
    value, and the TD sweep trains the value (``dxmi.py:396-415``); the
    Adam of f takes one step an iteration."""
    from dxmi_tpu_torch.trainers.dxmi import train_step
    from torch_fixtures import trainer_cases

    trainer = trainer_cases.port_trainer("f")
    f0 = [p.detach().clone() for p in trainer.energy.parameters()]
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(trainer_cases.B, 3, 16, 16, generator=gen) * 2 - 1
    m = train_step(trainer, x, None, gen)
    assert bool(torch.isfinite(m["ebm/d_loss_"]))
    assert (trainer.opt_f.count, trainer.opt_v.count) == (1, trainer_cases.T)
    assert any(not torch.equal(a, b)
               for a, b in zip(f0, trainer.energy.parameters()))


def test_image_folder_loader_raises(tmp_path):
    """Without --fake_data the entry reads the config's ``data_dir``
    through the folder loader, which raises, naming the folder, where the
    folder does not exist (the JAX loader's ``os.listdir``)."""
    train, _, _ = chip_smoke.train_cli_commands("x", device="cpu")
    train = [a for a in train if a not in ("--fake_data",)]
    proc = subprocess.run(train, cwd=tmp_path, capture_output=True,
                          text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=REPO,
                                   OMP_NUM_THREADS="2"))
    assert proc.returncode != 0
    assert "FileNotFoundError" in proc.stderr and "imagenet" in \
        proc.stderr.lower()
