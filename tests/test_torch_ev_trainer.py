"""``DxMITrainerEV`` (the anomaly trainer) against ``dxmi_tpu``'s on the CPU:
one iteration of train_anomaly's nets at a small width (``chip_smoke.
EV_SMALL``) on the same weights, trajectory, data and draws, with and
without a spectral-norm energy, at G9's gates (metrics within 1e-3, f's u
and sigma within 1e-4); the committed golden (G9's reference on the card)
against a fresh JAX run and against the port; the base trainer's
spectral-norm stats (stored by the energy step and each TD step's current
value only)."""
import contextlib
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "torch_fixtures"))

import chip_smoke  # noqa: E402
from make_ev_golden import jax_ev_iteration  # noqa: E402

from dxmi_tpu_torch.models.igebm import IGEBMEncoder  # noqa: E402
from dxmi_tpu_torch.utils.train_state import sn_buffers  # noqa: E402


@pytest.mark.parametrize("spectral_norm", [False, True])
def test_ev_iteration_matches_jax(spectral_norm):
    golden = jax_ev_iteration(spectral_norm)
    port = chip_smoke.ev_replay(golden, "cpu", fuse_gn_conv=False)
    m, sn = chip_smoke.ev_golden_check(port, golden, "EV")
    for k in ("f", "v", "s"):  # each net moved as JAX's did
        np.testing.assert_allclose(port[f"update/{k}"],
                                   golden[f"update/{k}"], rtol=1e-3,
                                   err_msg=k)
    assert m < chip_smoke.G3_METRIC_REL and sn <= chip_smoke.G9_SN_ABS
    if spectral_norm:
        # the committed golden is this run: the same draws, metrics within
        # the CPU's run-to-run rounding
        committed = dict(np.load(chip_smoke.EV_GOLDEN))
        assert sorted(committed) == sorted(golden)
        for k, v in committed.items():
            if k.startswith(("metric/", "sn/", "update/")):
                np.testing.assert_allclose(golden[k], v, rtol=1e-5,
                                           atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(golden[k], v, err_msg=k)


@pytest.mark.parametrize("fuse", [False, True])
def test_committed_golden_on_the_port(fuse):
    """G9's check on the CPU with the plain versions of its kernels, and
    with K3's (whose bf16 operands G9 leaves out on the card: read here)."""
    golden = dict(np.load(chip_smoke.EV_GOLDEN))
    port = chip_smoke.ev_replay(golden, "cpu", fuse_gn_conv=fuse)
    if not fuse:
        chip_smoke.ev_golden_check(port, golden, "G9 on the CPU")
        return
    rel = max(np.abs(port[k] - golden[k]).max() / max(np.abs(golden[k])
                                                      .max(), 1e-12)
              for k in golden if k.startswith("metric/"))
    assert np.isfinite(rel) and rel < 0.05, rel


def test_ev_golden_check_sees_a_missed_store(monkeypatch):
    """An EV trainer that stores no iterated u and sigma (its forwards
    outside update_sn_stats) is refused by G9's gates."""
    golden = dict(np.load(chip_smoke.EV_GOLDEN))
    from dxmi_tpu_torch.trainers import dxmi_ev
    monkeypatch.setattr(dxmi_ev, "update_sn_stats",
                        lambda net: contextlib.nullcontext())
    port = chip_smoke.ev_replay(golden, "cpu", fuse_gn_conv=False)
    with pytest.raises(AssertionError, match="G9 (metric|sn)/"):
        chip_smoke.ev_golden_check(port, golden, "G9")


@pytest.mark.parametrize("energy", [False, True])
def test_base_trainer_stores_stats_where_jax_does(monkeypatch, energy):
    """``dxmi.py:238-270``: with a spectral-norm value the energy step and
    each TD step's forward at the current state store u and sigma (1 + T
    stores); with a spectral-norm f the energy step stores f's and the TD
    steps the value's. The TD targets and update_sampler only read."""
    from dxmi_tpu_torch.models import igebm
    from dxmi_tpu_torch.models.unet_small import UNetSmall
    from dxmi_tpu_torch.models.value import TimeIndependentValue
    from dxmi_tpu_torch.samplers.var import VARSampler
    from dxmi_tpu_torch.trainers.dxmi import DxMITrainer, train_step

    torch.manual_seed(0)
    T, B = 3, 2
    sampler = VARSampler(UNetSmall(ch=32, ch_mult=(1,), num_res_blocks=1,
                                   attn_resolutions=(), resolution=8),
                         T, (3, 8, 8))
    value = TimeIndependentValue(IGEBMEncoder(nh=8, use_spectral_norm=True))
    f = IGEBMEncoder(nh=8, use_spectral_norm=True) if energy else None
    tr = DxMITrainer(batchsize=B, n_timesteps=T, gamma=1.0)
    tr.set_models(sampler, value, lr=1e-4, v_lr=1e-4, energy=f)
    stores = {"value": 0, "f": 0}
    sn_weight = igebm.sn_weight
    stems = {id(value.net.conv1): "value"}
    if energy:
        stems[id(f.conv1)] = "f"

    def counted(conv, update):
        if update and id(conv) in stems:
            stores[stems[id(conv)]] += 1
        return sn_weight(conv, update)

    monkeypatch.setattr(igebm, "sn_weight", counted)
    u0 = value.net.conv1.u.clone()
    gen = torch.Generator().manual_seed(1)
    train_step(tr, torch.rand(B, 3, 8, 8) * 2 - 1, None, gen,
               n_generator=1)
    assert stores == ({"value": T, "f": 1} if energy
                      else {"value": 1 + T, "f": 0})
    assert not torch.equal(value.net.conv1.u, u0)
    assert all(torch.isfinite(b).all() for _, b in sn_buffers(value))
