"""``generate_cifar10 --dtype bf16`` on the trained CIFAR fixture against the
JAX package's bf16 sampling (tests/torch_fixtures/cifar_bf16_golden.npz,
rebuilt by make_cifar_bf16_golden.py): each step from the golden's state,
the port's fused defaults (K3's and K2's plain versions in bf16) and its
unfused einsum net (JAX's arithmetic) at chip_smoke's G-bf16 gate
(``cifar_bf16_replay``: per step within BF16_REPLAY_SHARE times JAX's own
bf16 effect; 1.11-1.13 measured); the gate refuses a planted fault; and
the CLI on the CPU writes the in-process samples."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from dxmi_tpu_torch.generate_cifar10 import generate, to_uint8
from dxmi_tpu_torch.models import unet_small
from dxmi_tpu_torch.ops import _lib
from dxmi_tpu_torch.utils.checkpoint import load_sampler_state


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_bf16_replay_matches_jax(fuse):
    worst, used = chip_smoke.cifar_bf16_replay("cpu", fuse)
    assert max(worst) <= chip_smoke.BF16_REPLAY_SHARE
    assert not used and not _lib.LAUNCHES


def test_bf16_replay_gate_sees_a_k3_without_bias(monkeypatch):
    """K3 (plain) with its bias dropped moves the step means far past the
    gate (11.5x JAX's bf16 effect in the mean)."""
    conv = unet_small.gn_silu_conv

    def no_bias(x, gs, gb, k, b, *a):
        return conv(x, gs, gb, k, torch.zeros_like(b), *a)

    monkeypatch.setattr(unet_small, "gn_silu_conv", no_bias)
    with pytest.raises(AssertionError, match="times the bf16 effect"):
        chip_smoke.cifar_bf16_replay("cpu", True)


def test_generate_cli_bf16(tmp_path):
    """python -m dxmi_tpu_torch.generate_cifar10 --dtype bf16 --device cpu
    on the fixture streams the samples of the in-process bf16 sampler of
    the same seed (within one uint8 level)."""
    out = tmp_path / "bf16.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "dxmi_tpu_torch.generate_cifar10",
         "--log_dir", chip_smoke.FIXTURE_DIR, "--dtype", "bf16", "--device",
         "cpu", "--n_generate", "8", "--batchsize", "4", "--save_npz",
         str(out), "--save_dir", str(tmp_path / "png")],
        cwd=chip_smoke.REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=chip_smoke.REPO, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = np.load(out)["arr_0"]
    state = load_sampler_state(os.path.join(chip_smoke.FIXTURE_DIR,
                                            "sampler_best.pth"))
    want = to_uint8(generate(chip_smoke.fixture_config(), state, 8, 4, "cpu",
                             dtype="bf16"))
    assert got.shape == want.shape == (8, 16, 16, 3)
    assert np.abs(got.astype(np.int16) - want).max() <= 1
