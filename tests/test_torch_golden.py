"""The whole slice on the CPU against the committed reference run dir
``tests/fixtures/torch_rundir_t10`` (trained weights, ``golden.npz`` with
x0, per-step eps, means, sigmas and the final sample): config -> checkpoint
-> VARSampler -> UNetSmall, at the tolerances of tests/test_golden_fixture.py.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from dxmi_tpu_torch.config import instantiate, load_yaml
from dxmi_tpu_torch.generate_cifar10 import load_sampler
from dxmi_tpu_torch.models.unet_small import UNetSmall
from dxmi_tpu_torch.models.value import TimeIndependentValue
from dxmi_tpu_torch.samplers import sample_chunked
from dxmi_tpu_torch.samplers.var import VARSampler
from dxmi_tpu_torch.utils.checkpoint import (load_sampler_state,
                                             load_value_state,
                                             resolve_run_checkpoint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_rundir_t10")


@pytest.fixture(scope="module")
def rundir():
    return (load_yaml(os.path.join(FIXTURE, "config.yaml")),
            np.load(os.path.join(FIXTURE, "golden.npz")),
            load_sampler_state(os.path.join(FIXTURE, "sampler_best.pth")))


def test_config_builds_port_modules(rundir):
    """The run dir's config builds the port's sampler and (since the value
    nets are ported) its value, which loads value_best.pth and gives the
    reference's v_out on the final samples (test_golden_fixture.py's
    limits)."""
    cfg, golden, _ = rundir
    sampler = instantiate(cfg["sampler"], net=instantiate(cfg["sampler_net"]))
    assert isinstance(sampler, VARSampler)
    assert isinstance(sampler.net, UNetSmall)
    value = instantiate(cfg["value"])
    assert isinstance(value, TimeIndependentValue)
    value.load_state_dict(load_value_state(os.path.join(FIXTURE,
                                                        "value_best.pth")))
    with torch.no_grad():
        out = value(torch.from_numpy(golden["final"]), torch.full((8,), 9))
    np.testing.assert_allclose(out.numpy().reshape(-1),
                               golden["v_out"].reshape(-1), rtol=1e-4,
                               atol=1e-4)


def test_log_betas_roundtrip(rundir):
    _, golden, state = rundir
    np.testing.assert_allclose(state["log_betas"].numpy(), golden["log_betas"],
                               rtol=0, atol=1e-6)


# Unfused (K1, K2 paths) at the golden test's 5e-4; fused (K3's bf16 conv
# operands) at 2e-2, about three times the 6.2e-3 this arithmetic shows.
@pytest.mark.parametrize("fuse,tol", [(False, 5e-4), (True, 2e-2)])
def test_trajectory_replay(rundir, fuse, tol):
    """Same x0, same per-step eps: per-step mean and sigma on trained
    weights, each step restarted from the golden mean."""
    cfg, golden, state = rundir
    sampler = load_sampler(cfg, state, "cpu", fuse_gn_conv=fuse)
    x = torch.from_numpy(golden["x0"])
    with torch.no_grad():
        for t in range(sampler.n_timesteps):
            out = sampler.sample_step(x, t,
                                      noise=torch.from_numpy(golden["eps"][t]))
            err = np.abs(out["mean"].numpy() - golden["means"][t]).max()
            assert err < tol, f"step {t}: mean drift {err:.2e}"
            np.testing.assert_allclose(
                out["sigma"].numpy().reshape(-1, 1, 1, 1), golden["sigmas"][t],
                rtol=1e-5, atol=1e-7, err_msg=f"step {t} sigma")
            x = torch.from_numpy(golden["means"][t]
                                 + golden["sigmas"][t] * golden["eps"][t])


def test_sample_with_injected_noise(rundir):
    """The whole T-step rollout on its own means ends at the golden sample."""
    cfg, golden, state = rundir
    sampler = load_sampler(cfg, state, "cpu", fuse_gn_conv=False)
    with torch.no_grad():
        out = sampler.sample(8, x0=torch.from_numpy(golden["x0"]),
                             eps=torch.from_numpy(golden["eps"]))
    assert out["l_sample"].shape == (11, 8, 3, 16, 16)
    np.testing.assert_allclose(out["sample"].numpy(), golden["final"],
                               rtol=0, atol=5e-4)
    np.testing.assert_allclose(out["mean"].numpy(), golden["means"],
                               rtol=0, atol=5e-4)


def test_sample_chunked_is_sequential_sampling(rundir):
    cfg, _, state = rundir
    sampler = load_sampler(cfg, state, "cpu")
    with torch.no_grad():
        chunked = sample_chunked(sampler, 4, 2,
                                 torch.Generator().manual_seed(5))
        gen = torch.Generator().manual_seed(5)
        parts = [sampler.sample(2, generator=gen) for _ in range(2)]
    torch.testing.assert_close(chunked["sample"],
                               torch.cat([p["sample"] for p in parts]))
    torch.testing.assert_close(chunked["mean"],
                               torch.cat([p["mean"] for p in parts], dim=1))
    assert chunked["sigma"].shape == (10, 4)


def test_resolve_run_checkpoint(tmp_path):
    assert resolve_run_checkpoint(FIXTURE, "sampler", "best").endswith(
        "sampler_best.pth")
    (tmp_path / "sampler.pth").write_bytes(b"")
    assert resolve_run_checkpoint(str(tmp_path), "sampler", "best").endswith(
        "sampler.pth")
    with pytest.raises(FileNotFoundError):
        resolve_run_checkpoint(str(tmp_path), "value", "best")


def test_generate_cli(tmp_path):
    out = tmp_path / "samples.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "dxmi_tpu_torch.generate_cifar10",
         "--log_dir", FIXTURE, "--n_generate", "4", "--batchsize", "2",
         "--device", "cpu", "--save_npz", str(out), "--save_dir",
         str(tmp_path / "png")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    arr = np.load(out)["arr_0"]
    assert arr.shape == (4, 16, 16, 3) and arr.dtype == np.uint8


def _cifar_cli(tmp_path, *args):
    """The CLI on the fixture, its PNGs written under ``tmp_path``."""
    return subprocess.run(
        [sys.executable, "-m", "dxmi_tpu_torch.generate_cifar10",
         "--log_dir", FIXTURE, "--n_generate", "4", "--batchsize", "2",
         "--device", "cpu", "--save_dir", str(tmp_path / "png"), *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))


def test_generate_cli_streams_the_in_process_samples(tmp_path):
    """The CLI reads config.yaml with the port's YAML reader and streams
    uint8 batches; they are the in-process samples of the same seed
    (within one uint8 level, as chip_smoke.py phase C holds them)."""
    from dxmi_tpu_torch.config import load_yaml
    from dxmi_tpu_torch.generate_cifar10 import generate, to_uint8
    from dxmi_tpu_torch.utils.checkpoint import load_sampler_state

    out = tmp_path / "samples.npz"
    proc = _cifar_cli(tmp_path, "--save_npz", str(out), "--seed", "3")
    assert proc.returncode == 0, proc.stderr
    assert "streamed" in proc.stdout
    want = to_uint8(generate(
        load_yaml(os.path.join(FIXTURE, "config.yaml")),
        load_sampler_state(os.path.join(FIXTURE, "sampler_best.pth")), 4, 2,
        "cpu", seed=3))
    got = np.load(out)["arr_0"]
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int16) - want).max() <= 1


def test_generate_cli_int8_not_ported(tmp_path):
    """--int8 is ported (tests/test_torch_cifar_int8_golden.py), and so is a
    bf16 torso without it (tests/test_torch_cifar_bf16_golden.py): both run.
    So are msgpack run dirs: a ``sampler_best.msgpack`` beside the
    ``.pth``, written as the JAX package writes one from the fixture's
    weights, is the file the CLI loads (JAX's order), and it samples what
    the ``.pth`` samples."""
    from dxmi_tpu.utils import checkpoint as jax_checkpoint
    from dxmi_tpu.utils import convert as jax_convert

    proc = _cifar_cli(tmp_path, "--dtype", "bf16")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "generated 4 samples" in proc.stdout
    shutil.copy(os.path.join(FIXTURE, "config.yaml"), tmp_path)
    shutil.copy(os.path.join(FIXTURE, "sampler_best.pth"), tmp_path)
    state = jax_checkpoint.load_torch_checkpoint(
        os.path.join(FIXTURE, "sampler_best.pth"))
    state.pop("__meta__")
    out = jax_convert.convert_unet_small(state)
    jax_checkpoint.save_checkpoint(
        str(tmp_path / "sampler_best.msgpack"),
        {"net": out["params"], "log_betas": out["log_betas"]})
    runs = []
    for log_dir, name in ((tmp_path, "msgpack"), (FIXTURE, "pth")):
        npz = tmp_path / f"{name}.npz"
        proc = subprocess.run(
            [sys.executable, "-m", "dxmi_tpu_torch.generate_cifar10",
             "--log_dir", str(log_dir), "--n_generate", "4", "--batchsize",
             "2", "--device", "cpu", "--save_npz", str(npz), "--save_dir",
             str(tmp_path / f"png_{name}")], cwd=REPO,
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=REPO))
        assert proc.returncode == 0, proc.stderr[-3000:]
        runs.append((proc.stdout, np.load(npz)["arr_0"]))
    assert "sampler_best.msgpack" in runs[0][0]
    assert np.array_equal(runs[0][1], runs[1][1])
