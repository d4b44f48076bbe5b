"""The port's generate_large --int8 path on the trained ADM fixture against
the JAX package's int8 sampling (tests/torch_fixtures/adm_int8_golden.npz,
built by tests/torch_fixtures/make_adm_int8_golden.py):

- the committed golden is what the JAX package computes today (rebuilt on
  the CPU, each step with the golden's scales from the golden's state, so
  that an int8 rounding flip under another host's fp32 order moves one step
  only: scales and each step's median error within 2^-16 of the largest,
  ``torch_fixtures/rebuild_checks.py``), so that the golden cannot drift
  from the reference, and a stale golden (the trajectory off by 1e-3 of its
  largest, one scale doubled) fails;
- EDMSampler.calibrate_quant with the golden's injected draws records JAX's
  scales (within 1e-4 of each buffer's largest; 5e-6 measured);
- with JAX's scales, each int8 step mean, restarted from the golden state,
  is at most half as far from JAX's (on average over its elements) as the
  port's own full-precision step is: int8 rounding flips under fp32 noise
  make the trajectory chaotic (chip_smoke.INT8_STEP_RATIO), 0.03-0.23
  measured; and the median error over the elements, averaged over the
  steps, is at most 0.1 of the median int8 effect
  (chip_smoke.INT8_MEDIAN_RATIO), 0.026 measured;
- those two gates catch the wiring faults that a partial int8 path would
  have: attention blocks or the phase up-block left in full precision
  (0.253 and 0.258 on the median gate), one conv's scale doubled (0.262)
  or left at zero (7.85), the whole net in full precision;
- the cached int8 weights (prepare_int8) give the same step as preparing
  them in every call.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from dxmi_tpu_torch import generate_large
from dxmi_tpu_torch.models.unet_adm import AttentionBlockADM, ResBlockADM
from dxmi_tpu_torch.ops.quant import Int8Layer
from dxmi_tpu_torch.utils.checkpoint import load_sampler_state
from torch_fixtures import make_adm_int8_golden, rebuild_checks

FIXTURE = chip_smoke.ADM_FIXTURE_DIR


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(chip_smoke.INT8_GOLDEN))


@pytest.fixture(scope="module")
def samplers():
    cfg = chip_smoke.adm_fixture_config()
    state = load_sampler_state(os.path.join(FIXTURE, "sampler.pth"))
    return (generate_large.load_sampler(cfg, state, "cpu", int8=True),
            generate_large.load_sampler(cfg, state, "cpu"))


@pytest.fixture(scope="module")
def rebuilt(golden):
    return make_adm_int8_golden.build(teacher=golden)


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


def test_calibrate_quant_matches_jax(golden, samplers):
    sampler, _ = samplers
    x0, eps, ys = chip_smoke.adm_int8_calib_draws(int(golden["calib_seed"]))
    sampler.calibrate_quant(n_sample=8, n_rounds=2, x0=torch.from_numpy(x0),
                            eps=torch.from_numpy(eps),
                            y=torch.from_numpy(ys))
    state = sampler.net.state_dict()
    scales = {k[len("scale/"):]: v for k, v in golden.items()
              if k.startswith("scale/")}
    assert len(scales) == 28
    assert {k for k in state if k.endswith(("act_scale", "attn_proj_scale"))
            } == set(scales)
    for k, v in scales.items():
        err = np.abs(state[k].numpy() - v).max() / np.abs(v).max()
        assert err <= chip_smoke.INT8_SCALE_REL, (k, err)


def test_int8_replay_matches_golden(golden, samplers):
    sampler, fp_sampler = samplers
    chip_smoke.load_int8_golden_scales(sampler.net, golden)
    gold = np.load(os.path.join(FIXTURE, "golden.npz"))
    steps, _ = chip_smoke.replay_int8(sampler, fp_sampler, golden, gold,
                                          "cpu")
    chip_smoke.check_int8_replay(steps)


def _attn_full_precision(net):
    for m in net.modules():
        if isinstance(m, AttentionBlockADM):
            m.int8 = False


def _phase_full_precision(net):
    for m in net.modules():
        if isinstance(m, ResBlockADM):
            m.phase_int8 = False


def _one_scale(name, factor):
    def plant(net):
        conv = net.get_submodule(name)
        conv.act_scale.mul_(factor)
        conv.prepare_int8()
    return plant


# the first conv of the decoder's first block
ONE_CONV = "output_blocks.0.0.in_layers.2"
WIRING_FAULTS = {
    "attn_full_precision": _attn_full_precision,
    "phase_up_full_precision": _phase_full_precision,
    "one_scale_zero": _one_scale(ONE_CONV, 0.0),
    "one_scale_doubled": _one_scale(ONE_CONV, 2.0),
}


@pytest.mark.parametrize("fault", [*WIRING_FAULTS, "all_full_precision"])
def test_int8_replay_gates_catch_wiring_faults(golden, fault):
    """G2-int8's gates fail a partial int8 path: each planted fault reads
    at least 2.5x INT8_MEDIAN_RATIO on the median gate."""
    cfg = chip_smoke.adm_fixture_config()
    state = load_sampler_state(os.path.join(FIXTURE, "sampler.pth"))
    fp_sampler = generate_large.load_sampler(cfg, state, "cpu")
    if fault == "all_full_precision":
        sampler = fp_sampler
    else:
        sampler = generate_large.load_sampler(cfg, state, "cpu", int8=True)
        chip_smoke.load_int8_golden_scales(sampler.net, golden)
        with torch.no_grad():
            WIRING_FAULTS[fault](sampler.net)
    gold = np.load(os.path.join(FIXTURE, "golden.npz"))
    steps, _ = chip_smoke.replay_int8(sampler, fp_sampler, golden, gold,
                                          "cpu")
    median = np.mean([m for _, m, _ in steps])
    assert median >= 2.5 * chip_smoke.INT8_MEDIAN_RATIO, median
    with pytest.raises(AssertionError, match="int8 step means"):
        chip_smoke.check_int8_replay(steps)


def test_cached_int8_weights_equal_per_call(golden, samplers):
    sampler, _ = samplers
    chip_smoke.load_int8_golden_scales(sampler.net, golden)
    gold = np.load(os.path.join(FIXTURE, "golden.npz"))
    args = (torch.from_numpy(gold["x_init"]), 3,
            torch.from_numpy(gold["eps"][3]),
            torch.from_numpy(gold["y"]).long())
    with torch.no_grad():
        cached = sampler.sample_step(*args)["mean"]
        for m in sampler.net.modules():
            if isinstance(m, Int8Layer):
                m.clear_int8()
        per_call = sampler.sample_step(*args)["mean"]
    torch.testing.assert_close(cached, per_call, rtol=0, atol=0)
