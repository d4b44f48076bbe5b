"""The port's generate_cifar10 --int8 path on the trained CIFAR fixture
against the JAX package's int8 sampling (tests/torch_fixtures/
cifar_int8_golden.npz, built by tests/torch_fixtures/
make_cifar_int8_golden.py), read as G2-int8 reads the ADM fixture's:

- the committed golden is what the JAX package computes today (rebuilt on
  the CPU, each step with the golden's scales from the golden's state:
  scales and each step's median error within 2^-16 of the largest,
  ``torch_fixtures/rebuild_checks.py``), and a stale golden fails;
- VARSampler.calibrate_quant with the golden's injected draws records JAX's
  scales (within chip_smoke.INT8_SCALE_REL of each buffer's largest);
- with JAX's scales, each int8 step mean, restarted from the golden state,
  passes chip_smoke.check_int8_replay (the mean error at most half the int8
  effect per step, the median error on average at most 0.1 of the median
  effect);
- those gates refuse the wiring faults a partial int8 path would have: the
  attention 1x1s or the stride-2 Downsample convs left in full precision,
  one conv's scale doubled or left at zero, the whole net in full precision;
- the cached int8 weights give the same step as preparing them per call;
- the CLI samples with --int8 on the CPU.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from dxmi_tpu_torch import generate_cifar10
from dxmi_tpu_torch.models.unet_small import AttnBlock, Downsample
from dxmi_tpu_torch.ops.quant import Int8Layer, QConv
from dxmi_tpu_torch.utils.checkpoint import load_sampler_state
from torch_fixtures import make_cifar_int8_golden, rebuild_checks

FIXTURE = chip_smoke.FIXTURE_DIR


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(chip_smoke.CIFAR_INT8_GOLDEN))


@pytest.fixture(scope="module")
def gold():
    return dict(np.load(os.path.join(FIXTURE, "golden.npz")))


def _sampler(int8=True):
    """The fixture's sampler on the CPU: with ``int8`` the --int8 net
    (quant_int8='static'), its scales zero until calibrated or loaded;
    without, the unfused fp32 net (JAX's arithmetic), as G-int8's
    full-precision step."""
    cfg = chip_smoke.fixture_config()
    state = load_sampler_state(os.path.join(FIXTURE, "sampler_best.pth"))
    kw = ({"quant_int8": "static"} if int8
          else {"fuse_gn_conv": False, "attn_impl": "einsum"})
    return generate_cifar10.load_sampler(cfg, state, "cpu", **kw)


@pytest.fixture(scope="module")
def rebuilt(golden):
    return make_cifar_int8_golden.build(teacher=golden)


def test_golden_rebuilds_from_jax(golden, rebuilt):
    rebuild_checks.check_int8_rebuild(rebuilt, golden)


@pytest.mark.parametrize("fault", ["means_shifted", "one_scale_doubled"])
def test_golden_rebuild_sees_a_stale_golden(golden, rebuilt, fault):
    stale = dict(golden)
    if fault == "means_shifted":
        stale["means"] = golden["means"] + 1e-3 * np.abs(golden["means"]).max()
    else:
        key = f"scale/{ONE_CONV}.act_scale"
        stale[key] = 2 * golden[key]
    with pytest.raises(AssertionError):
        rebuild_checks.check_int8_rebuild(rebuilt, stale)


def test_calibrate_quant_matches_jax(golden):
    sampler = _sampler()
    x0, eps = chip_smoke.cifar_int8_calib_draws(int(golden["calib_seed"]))
    sampler.calibrate_quant(n_sample=x0.shape[1], n_rounds=x0.shape[0],
                            x0=torch.from_numpy(x0),
                            eps=torch.from_numpy(eps))
    state = sampler.net.state_dict()
    scales = {k[len("scale/"):]: v for k, v in golden.items()
              if k.startswith("scale/")}
    # 39 QConvs: the 7 ResnetBlocks' 21 convs (5 with a nin_shortcut), the
    # stride-2 Downsample, the Upsample and the 4 attention blocks' 1x1s
    assert len(scales) == 39
    assert {k for k in state if k.endswith("act_scale")} == set(scales)
    for k, v in scales.items():
        err = np.abs(state[k].numpy() - v).max() / np.abs(v).max()
        assert err <= chip_smoke.INT8_SCALE_REL, (k, err)


def test_int8_replay_matches_golden(golden, gold):
    sampler, fp_sampler = _sampler(), _sampler(int8=False)
    chip_smoke.load_int8_golden_scales(sampler.net, golden)
    steps, _ = chip_smoke.replay_int8(sampler, fp_sampler, golden, gold,
                                      "cpu")
    chip_smoke.check_int8_replay(steps)


def _full_precision(kind):
    def plant(net):
        for m in net.modules():
            if isinstance(m, kind):
                for c in m.modules():
                    if isinstance(c, QConv):
                        c.calibrating = True
    return plant


def _one_scale(name, factor):
    def plant(net):
        conv = net.get_submodule(name)
        conv.act_scale.mul_(factor)
        conv.prepare_int8()
    return plant


# the first conv of the decoder's first block
ONE_CONV = "up.1.block.0.conv1"
WIRING_FAULTS = {
    "attn_full_precision": _full_precision(AttnBlock),
    "downsample_full_precision": _full_precision(Downsample),
    "one_scale_zero": _one_scale(ONE_CONV, 0.0),
    "one_scale_doubled": _one_scale(ONE_CONV, 2.0),
}
# each fault must read at least this multiple of INT8_MEDIAN_RATIO on the
# median gate; on one host they read 0.68-6.6 against the port's 0.0091
# (tests/torch_fixtures/int8_cpu_report.py)
FAULT_MARGIN = 2.5


@pytest.mark.parametrize("fault", [*WIRING_FAULTS, "all_full_precision"])
def test_int8_replay_gates_catch_wiring_faults(golden, gold, fault):
    """G-int8's gates fail a partial int8 path: each planted fault reads at
    least FAULT_MARGIN x INT8_MEDIAN_RATIO on the median gate."""
    fp_sampler = _sampler(int8=False)
    if fault == "all_full_precision":
        sampler = fp_sampler
    else:
        sampler = _sampler()
        chip_smoke.load_int8_golden_scales(sampler.net, golden)
        with torch.no_grad():
            WIRING_FAULTS[fault](sampler.net)
    steps, _ = chip_smoke.replay_int8(sampler, fp_sampler, golden, gold,
                                      "cpu")
    median = np.mean([m for _, m, _ in steps])
    assert median >= FAULT_MARGIN * chip_smoke.INT8_MEDIAN_RATIO, median
    with pytest.raises(AssertionError, match="int8 step means"):
        chip_smoke.check_int8_replay(steps)


def test_cached_int8_weights_equal_per_call(golden, gold):
    sampler = _sampler()
    chip_smoke.load_int8_golden_scales(sampler.net, golden)
    args = (torch.from_numpy(gold["x0"]), 3, torch.from_numpy(gold["eps"][3]))
    with torch.no_grad():
        cached = sampler.sample_step(*args)["mean"]
        for m in sampler.net.modules():
            if isinstance(m, Int8Layer):
                m.clear_int8()
        per_call = sampler.sample_step(*args)["mean"]
    torch.testing.assert_close(cached, per_call, rtol=0, atol=0)


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "dxmi_tpu_torch.generate_cifar10", "--log_dir",
         FIXTURE, "--n_generate", "8", "--batchsize", "4", *args],
        cwd=chip_smoke.REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=chip_smoke.REPO))


def test_generate_cifar10_cli_int8(tmp_path):
    """--int8 on the CPU: calibration on 2 x 64 full-precision
    trajectories, then the plain version of K8 (its stride-2 form at the
    Downsample); the npz streams the samples."""
    out = tmp_path / "s8.npz"
    proc = _cli("--device", "cpu", "--int8", "--save_npz", str(out),
                "--save_dir", str(tmp_path / "png"))
    assert proc.returncode == 0, proc.stderr
    assert "int8: static activation scales calibrated" in proc.stdout
    arr = np.load(out)["arr_0"]
    assert arr.shape == (8, 16, 16, 3) and arr.dtype == np.uint8
