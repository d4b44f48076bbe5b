"""FID through the CIFAR-10 entries on the CPU at a small width, with the
proxy files (tests/torch_fixtures/fid_files.py) under the working
directory: train_cifar10 computes FID at epoch 0 and writes sampler_best
with its meta (the refusal is gone); generate_cifar10 --eval_fid on that
run writes PNGs that decode to its npz and prints FID; the standalone
command (fid.cli) saves and compares statistics."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from torch_fixtures.trainer_cases import run_files
from dxmi_tpu_torch.fid.stats import frechet_distance
from dxmi_tpu_torch.utils.png import read_png, write_png
from torch_fixtures.fid_files import write_datasets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")


def _run(cmd, cwd):
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=ENV)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout.splitlines()


def _fid(lines):
    fid = [float(l.split()[1]) for l in lines if l.startswith("FID: ")]
    assert len(fid) == 1, lines[-20:]
    assert any(l.startswith("FID time: ") for l in lines)
    return fid[0]


def test_train_then_generate_with_fid(tmp_path):
    """train_cifar10 (2 steps, FID on 6 samples at epoch 0: one chunk of 8
    trajectories of 4) writes sampler_best and value_best with fid, epoch
    and iter; generate_cifar10 --epoch best --eval_fid prints the
    checkpoint's FID and the FID of its PNG directory, which decodes to the
    npz."""
    write_datasets(str(tmp_path))
    train, _, log_dir = chip_smoke.cifar_train_cli_commands("fid", "cpu")
    lines = _run(train + ["--training.n_fid_samples", "6",
                          "--training.sampling_batchsize", "4"], tmp_path)
    fid = _fid(lines)
    assert lines[-1] == "done: 2 iters"
    run = tmp_path / log_dir
    assert run_files(run) == ["config.yaml", "sampler_best.pth",
                              "sampler_last.pth", "train_state.msgpack",
                              "value_best.pth", "value_last.pth"]
    best = torch.load(run / "sampler_best.pth", weights_only=True)
    assert {k: v for k, v in best.items() if k != "state_dict"} == {
        "fid": fid, "epoch": 0, "iter": 0}

    lines = _run([sys.executable, "-m", "dxmi_tpu_torch.generate_cifar10",
                  "--log_dir", log_dir, "--epoch", "best", "-n", "8",
                  "--batchsize", "4", "--device", "cpu", "--eval_fid",
                  "--save_npz", "s.npz"], tmp_path)
    assert f"checkpoint FID {fid} (epoch 0)" in lines
    assert np.isfinite(_fid(lines))
    arr = np.load(tmp_path / "s.npz")["arr_0"]
    pngs = run / "generated_best"
    assert np.array_equal(
        np.stack([read_png(str(pngs / f"0_{i}.png")) for i in range(8)]), arr)


@pytest.mark.parametrize("cleanup", [[], ["--cleanup"], ["-save", "False"]])
def test_generate_without_fid_files(tmp_path, cleanup):
    """Without the weights under the working directory --eval_fid says so;
    the PNGs stay unless --cleanup (or -save False) removes them, as in the
    JAX entry. Dot-key overrides merge over the run's config."""
    lines = _run([sys.executable, "-m", "dxmi_tpu_torch.generate_cifar10",
                  "--log_dir", chip_smoke.FIXTURE_DIR, "-n", "4",
                  "--batchsize", "4", "--device", "cpu", "--eval_fid",
                  "--save_dir", "pngs", "--sampler_net.dropout", "0.0",
                  *cleanup], tmp_path)
    assert ("FID skipped: Inception weights / dataset stats not on disk"
            in lines)
    assert (tmp_path / "pngs").exists() == (not cleanup)
    if not cleanup:
        assert len(os.listdir(tmp_path / "pngs")) == 4


def test_fid_cli(tmp_path):
    """python -m dxmi_tpu_torch.fid.cli --save-stats on a PNG directory
    writes mu/sigma of its pool3 activations; two statistics files give
    their Frechet distance."""
    write_datasets(str(tmp_path))
    (tmp_path / "imgs").mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        write_png(str(tmp_path / "imgs" / f"{i}.png"),
                  rng.randint(0, 256, (32, 32, 3), np.uint8))
    _run([sys.executable, "-m", "dxmi_tpu_torch.fid.cli", "--save-stats",
          "imgs", "out.npz", "--device", "cpu"], tmp_path)
    with np.load(tmp_path / "out.npz") as d:
        assert d["mu"].shape == (2048,) and d["sigma"].shape == (2048, 2048)
    a, b = (dict(mu=rng.randn(4), sigma=np.eye(4) * s) for s in (1.0, 2.0))
    np.savez(tmp_path / "a.npz", **a)
    np.savez(tmp_path / "b.npz", m2=b["mu"], s2=b["sigma"])
    lines = _run([sys.executable, "-m", "dxmi_tpu_torch.fid.cli", "a.npz",
                  "b.npz", "--device", "cpu"], tmp_path)
    want = frechet_distance(a["mu"], a["sigma"], b["mu"], b["sigma"])
    assert lines[-1] == f"FID: {want}"
    proc = subprocess.run(
        [sys.executable, "-m", "dxmi_tpu_torch.fid.cli", "a.npz", "b.npz",
         "--device", "cpu"], cwd=tmp_path / "imgs", capture_output=True,
        text=True, timeout=300, env=ENV)
    assert proc.returncode != 0
    assert "weights not found" in proc.stderr
