"""One DxMITrainer iteration with ``value_resample`` (configs/cifar10/
T4_ddgan.yaml's trainer) of the port against the JAX package's, with the
JAX trainer's draws replayed (the TD sweep's resampled policy steps, the
permutation, the policy update's z and noise): on the small NCSN++ in a
T=4 DDGANSampler against the committed golden (``ddgan_train_golden.npz``,
phase G7's check), and on a small UNetSmall (dropout 0) in a T=4
VARSampler against JAX live. Limits are G4's (``chip_smoke.
train_golden_check``): every metric within 1e-3 relative, the value
update's norms and projections within 1e-3, the sampler's each within 5% of
its own size plus 1% of the largest.
"""
import os
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from dxmi_tpu_torch.config import load_yaml
from dxmi_tpu_torch.models.unet_small import UNetSmall
from dxmi_tpu_torch.samplers.var import VARSampler
from dxmi_tpu_torch.trainers.dxmi import DxMITrainer, train_step

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_fixtures"))
import make_ddgan_train_golden  # noqa: E402


def test_value_resample_builds():
    """value_resample no longer raises (it did until the DDGAN slice)."""
    assert DxMITrainer(batchsize=4, value_resample=True).value_resample


def test_value_resample_iteration_matches_golden():
    port, golden = chip_smoke.ddgan_train_replay("cpu")
    m, v, s = chip_smoke.train_golden_check(port, golden, "G7")
    assert m <= chip_smoke.G3_METRIC_REL


def test_resampling_is_seen(monkeypatch):
    """The same iteration with the trajectory's own next states (the
    resample off) fails the gates: the golden sees value_resample."""
    init = DxMITrainer.__init__

    def off(self, *args, **kw):
        init(self, *args, **kw)
        self.value_resample = False
    monkeypatch.setattr(DxMITrainer, "__init__", off)
    port, golden = chip_smoke.ddgan_train_replay("cpu")
    with pytest.raises(AssertionError):
        chip_smoke.train_golden_check(port, golden, "G7 without resample")


def test_var_value_resample_matches_jax():
    """VARSampler with value_resample: the resampled step's noise is its
    key itself (``var.py:136``)."""
    golden, _ = make_ddgan_train_golden.build("var")
    net = UNetSmall(**make_ddgan_train_golden.VAR_SMALL, attn_impl="einsum",
                    fuse_gn_conv=False)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in
                         make_ddgan_train_golden.var_state().items()})
    sampler = VARSampler(net, chip_smoke.DDGAN_T, (3, 16, 16),
                         trainable_beta="fix_last")
    cfg = load_yaml(chip_smoke.T4_DDGAN_CONFIG)
    port = chip_smoke.dxmi_train_replay(sampler, chip_smoke.small_value(cfg),
                                        cfg, golden, "cpu")
    chip_smoke.train_golden_check(port, golden, "VAR value_resample")


def test_train_step_draws_its_resample():
    """train_step with value_resample draws the resampled steps from its
    generator: two runs from one seed agree, and the metrics are finite."""
    cfg = load_yaml(chip_smoke.T4_DDGAN_CONFIG)
    tcfg = {k: v for k, v in cfg["trainer"].items() if k != "_target_"}
    outs = []
    for _ in range(2):
        sampler = chip_smoke.ddgan_small_sampler("cpu")
        value = chip_smoke.small_value(cfg)
        trainer = DxMITrainer(**{**tcfg, "batchsize": 4})
        trainer.set_models(sampler, value, 1e-4, 1e-3, 1e-3)
        gen = torch.Generator().manual_seed(3)
        x = torch.rand(4, 3, 16, 16, generator=gen) * 2 - 1
        outs.append(train_step(trainer, x, None, gen))
    for k, v in outs[0].items():
        if not k.startswith("time/"):
            assert torch.isfinite(v).all() and torch.equal(v, outs[1][k]), k
