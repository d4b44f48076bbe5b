"""The LSUN-Bedroom 256 T=4 slice's trainer on the CPU against dxmi_tpu: one
unconditional ``DxMITrainerCond`` iteration of configs/lsun/T4_wide.yaml's
trainer (``sigma_scale`` 30, ``time_cost`` 0, ``value_grad_clip``) on the
small LSUN net with a small Wide-ResNet value, from the same parameters,
data batch and trajectory, with the JAX trainer's draws replayed
(tests/torch_fixtures/make_lsun_train_golden.py): against the committed
golden that chip_smoke.py (phase G8) replays on the card, and element by
element against JAX's parameter states."""
import numpy as np
import pytest
import torch

import chip_smoke
from torch_fixtures import make_lsun_train_golden, rebuild_checks


@pytest.fixture(scope="module")
def jax_run():
    return make_lsun_train_golden.build()


@pytest.fixture(scope="module")
def golden():
    return chip_smoke.lsun_train_golden()


@pytest.fixture(scope="module")
def port_run():
    """The port's iteration on the CPU: (golden arrays computed the same
    way, value state before, value state after, sampler net before and
    after)."""
    golden = chip_smoke.lsun_train_golden()
    sampler = chip_smoke.lsun_small_sampler("cpu").train()
    value = chip_smoke.lsun_small_value()
    states = [{k: v.clone() for k, v in m.state_dict().items()}
              for m in (value, sampler.net)]
    out = chip_smoke.cond_train_replay(
        sampler, value, chip_smoke.load_yaml(
            chip_smoke.LSUN_T4_WIDE_CONFIG)["trainer"], golden, "cpu")
    s_after = {f"net.{k}": v for k, v in sampler.net.state_dict().items()}
    s_after["log_betas"] = sampler.log_betas.detach()
    return out, states[0], value.state_dict(), {
        f"net.{k}": v for k, v in states[1].items()}, s_after


def test_golden_rebuilds_from_jax(jax_run, golden):
    """The committed golden is what the JAX package computes today (inputs
    bit-equal, results within rebuild_checks' limits)."""
    built, _ = jax_run
    stored = {k: v for k, v in golden.items() if k != "img"}
    rebuild_checks.check_fp32_rebuild(built, stored)


def test_iteration_metrics_match_jax(port_run, golden):
    """Every metric within G3_METRIC_REL (1e-3) of its vector's largest,
    log_betas within 1e-5 and each sampler tensor's update within G3's
    5% plus 1% of the largest (chip_smoke.train_golden_check; 9e-6 and 0.05
    of the limit measured). The value update is held element by element in
    the next test."""
    port = port_run[0]
    m, _, s = chip_smoke.train_golden_check(port, golden, "LSUN",
                                            gate_updates=False)
    assert m <= chip_smoke.G3_METRIC_REL and s <= 1


# The value's first Adam steps move each element by about v_lr times the
# sign of its gradient whatever its size, so an element whose gradient sits
# at the fp32 noise floor steps with a sign that the summation order
# decides: such an element moves by up to 2 v_lr a step from JAX's, where
# every other element agrees to fp32 rounding. Measured on this iteration:
# one element of block2_0.conv2's 9216 moved by 1.6 v_lr (its projection
# 0.47% off JAX's, the value update's norms and projections 2.2e-3 off as
# a whole, past G3's 1e-3); the ADM and CIFAR goldens show none. An element
# whose gradient changes sign between the steps is off by more than fp32
# rounding too (one bias element of 5e-4 by 2.4e-6). So at most
# VALUE_FLIP_SHARE of each tensor (and one in any tensor) may be off by more
# than v_lr / 4, and with those set aside the whole value net's update is
# held to JAX's within 1e-4 of its norm (the sampler's is held over the
# whole net too).
VALUE_FLIP_SHARE = 1e-3


def test_value_update_matches_jax_elementwise(port_run, jax_run):
    """The value net's update against JAX's under the flip allowance above;
    every tensor's update well above fp32 rounding."""
    _, full = jax_run
    _, before, after, _, _ = port_run
    v_lr = make_lsun_train_golden.V_LR
    flipped, num, den = 0, 0.0, 0.0
    for k, want_after in full["value_after"].items():
        want = (want_after - full["value_before"][k]).double()
        got = (after[k] - before[k]).double()
        assert torch.equal(before[k], full["value_before"][k]), k
        assert want.norm() > 1e3 * 2 ** -24 * want_after.abs().max(), k
        off = (got - want).abs() > v_lr / 4
        flipped += int(off.sum())
        assert int(off.sum()) <= max(1, VALUE_FLIP_SHARE * off.numel()), k
        num += float(((got - want)[~off] ** 2).sum())
        den += float((want ** 2).sum())
    assert flipped <= 2
    assert np.sqrt(num / den) <= 1e-4


def test_sampler_update_matches_jax(port_run, jax_run):
    """The sampler net's update within 1e-2 of its norm over the whole net
    (tests/test_torch_train_slice.py's limit: RAdam's rectified steps turn
    gradients at the noise floor into +-lr steps), log_betas moved but for
    the fixed last one."""
    _, full = jax_run
    _, _, _, s_before, s_after = port_run
    num = den = 0.0
    for k, want_after in full["sampler_after"].items():
        want = (want_after - full["sampler_before"][k]).double()
        got = (s_after[k] - full["sampler_before"][k]).double()
        num += float(((got - want) ** 2).sum())
        den += float((want ** 2).sum())
    assert np.sqrt(num / den) < 1e-2
    lb = full["sampler_after"]["log_betas"] - full["sampler_before"][
        "log_betas"]
    assert float(lb[:-1].abs().max()) > 1e-6 and float(lb[-1]) == 0.0


def test_unconditional_buffer_and_sigma_scale(golden):
    """The iteration is unconditional (no labels anywhere), and sigma_scale
    reaches the value targets' entropy term: T4's configs leave
    entropy_in_value off, so with it on the per-step value loss moves when
    sigma_scale does."""
    assert "y" not in golden and "traj_y" not in golden
    cfg = chip_smoke.load_yaml(chip_smoke.LSUN_T4_WIDE_CONFIG)["trainer"]
    assert cfg["sigma_scale"] == 30 and cfg["time_cost"] == 0
    outs = []
    for scale in (30, 3):
        sampler = chip_smoke.lsun_small_sampler("cpu").train()
        value = chip_smoke.lsun_small_value()
        tcfg = dict(cfg, sigma_scale=scale, entropy_in_value=1)
        outs.append(chip_smoke.cond_train_replay(sampler, value, tcfg,
                                                 golden, "cpu"))
    assert not np.allclose(outs[0]["metric/per_step/v_loss"],
                           outs[1]["metric/per_step/v_loss"])
