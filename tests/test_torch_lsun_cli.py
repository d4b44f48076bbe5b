"""The LSUN entries on the CPU: train_image_large on configs/lsun/T4.yaml
(IGEBM value), T4_wide.yaml (Wide-ResNet value) and T10.yaml (scale-shift
norm, T=10) with --fake_data at a small width for 2 steps, then
generate_large on the run dir each writes (chip_smoke.lsun_cli_commands):
no NotImplementedError or KeyError, the JAX entry's log lines, a
reference-format run dir, and finite unconditional samples of the run's
shape."""
import os
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from torch_fixtures.trainer_cases import run_files
from dxmi_tpu_torch.config import parse_yaml


@pytest.mark.parametrize("config", [chip_smoke.LSUN_T4_CONFIG,
                                    chip_smoke.LSUN_T4_WIDE_CONFIG,
                                    os.path.join(chip_smoke.REPO, "configs",
                                                 "lsun", "T10.yaml")])
def test_train_then_generate(tmp_path, config):
    train, gen, log_dir = chip_smoke.lsun_cli_commands(config, "cli", "cpu")
    env = dict(os.environ, PYTHONPATH=chip_smoke.REPO, OMP_NUM_THREADS="2",
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(train, cwd=tmp_path, capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert [l.split(" d_loss")[0] for l in lines if l.startswith("iter")] \
        == ["iter 0", "iter 1"]
    assert "nan-guard skips: 0" in lines and lines[-1] == "done"
    assert any(l.startswith("WARNING: pretrained ckpt") for l in lines)
    run = tmp_path / log_dir
    assert run_files(run) == ["config.yaml", "sampler_last.pth",
                              "train_state.msgpack", "value_last.pth"]
    cfg = parse_yaml((run / "config.yaml").read_text())
    assert cfg["diffusion"]["image_size"] == 64
    assert cfg["sampler"]["class_cond"] is False
    value = torch.load(run / "value_last.pth", weights_only=True)
    assert value["state_dict"]
    proc = subprocess.run(gen, cwd=tmp_path, capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = np.load(run / "samples.npz")
    assert got["arr_0"].shape == (8, 64, 64, 3)
    assert got["arr_0"].dtype == np.uint8 and "arr_1" not in got
