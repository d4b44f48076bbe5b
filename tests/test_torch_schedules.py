"""The port's schedules, Cody-Waite reduction and timestep embedding against
dxmi_tpu's, on the same numpy inputs (tolerance ~1e-6)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxmi_tpu import schedules as jsched
from dxmi_tpu.models.unet_small import timestep_embedding as jax_embedding
from dxmi_tpu.ops import trig as jtrig
from dxmi_tpu_torch import schedules as tsched
from dxmi_tpu_torch.models.unet_small import timestep_embedding
from dxmi_tpu_torch.ops import trig as ttrig


@pytest.mark.parametrize("schedule", ["linear", "quad", "sigmoid", "constant"])
def test_make_beta_schedule(schedule):
    np.testing.assert_array_equal(tsched.make_beta_schedule(schedule, 50),
                                  jsched.make_beta_schedule(schedule, 50))


def test_ddpm_grid():
    a, b = tsched.ddpm_grid(), jsched.ddpm_grid()
    for f in ("beta", "alpha", "alpha_bar", "sigma"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("schedule", ["quadratic", "linear"])
@pytest.mark.parametrize("n_timesteps", [4, 10])
def test_var_schedule(n_timesteps, schedule):
    a = tsched.var_schedule(n_timesteps, schedule)
    b = jsched.var_schedule(n_timesteps, schedule)
    for f in dataclasses.fields(tsched.VarSchedule):
        np.testing.assert_allclose(getattr(a, f.name),
                                   np.asarray(getattr(b, f.name)),
                                   rtol=1e-6, atol=1e-6, err_msg=f.name)


def test_reduce_mod_2pi():
    x = np.random.RandomState(0).uniform(-1600, 1600, 4096).astype(np.float32)
    ours = ttrig.reduce_mod_2pi(torch.from_numpy(x)).numpy()
    ref = np.asarray(jtrig.reduce_mod_2pi(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dim", [32, 33, 128])
def test_timestep_embedding(dim):
    t = np.concatenate([tsched.var_schedule(10).tau,
                        np.random.RandomState(1).uniform(0, 999, 22)
                        ]).astype(np.float32)
    ours = timestep_embedding(torch.from_numpy(t), dim).numpy()
    ref = np.asarray(jax_embedding(jnp.asarray(t), dim))
    assert ours.shape == ref.shape == (32, dim)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


# ---- Karras / EDM (the ImageNet64 slice) ---------------------------------

from dxmi_tpu.models.unet_adm import adm_timestep_embedding as jax_adm_embedding
from dxmi_tpu.samplers.var import gaussian_logp_mean as jax_logp
from dxmi_tpu_torch.models.unet_adm import adm_timestep_embedding
from dxmi_tpu_torch.samplers.var import gaussian_logp_mean


@pytest.mark.parametrize("n", [4, 10])
@pytest.mark.parametrize("stochastic_last", [False, True])
def test_karras_schedule(n, stochastic_last):
    a = tsched.karras_schedule(n, stochastic_last=stochastic_last)
    b = jsched.karras_schedule(n, stochastic_last=stochastic_last)
    for f in ("sigmas", "sigma_down", "sigma_up"):
        np.testing.assert_allclose(getattr(a, f), np.asarray(getattr(b, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    assert (a.sigma_max, a.sigma_data) == (b.sigma_max, b.sigma_data)


def test_edm_scalings_and_rescaled_t():
    sig = np.concatenate([tsched.karras_schedule(10).sigmas,
                          np.random.RandomState(2).uniform(0.002, 80, 16)
                          ]).astype(np.float32)
    for ours, ref in zip(tsched.edm_scalings(torch.from_numpy(sig)),
                         jsched.edm_scalings(jnp.asarray(sig))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(
        tsched.edm_rescaled_t(torch.from_numpy(sig)).numpy(),
        np.asarray(jsched.edm_rescaled_t(jnp.asarray(sig))), rtol=1e-6,
        atol=1e-6)


def test_edm_rescaled_t_keeps_the_denormal():
    """sigma + 1e-44 is a float32 denormal at sigma = 0: torch keeps it, so
    the log is finite (XLA on the CPU flushes it to zero and gives -inf)."""
    out = tsched.edm_rescaled_t(torch.zeros(1)).item()
    assert np.isfinite(out) and abs(out - 250.0 * np.log(9.8091e-45)) < 1e-2


@pytest.mark.parametrize("dim", [32, 33, 192])
def test_adm_timestep_embedding(dim):
    """The EDM rescaled timesteps (up to ~1095 at sigma 80) and others."""
    sig = tsched.karras_schedule(10).sigmas
    t = np.concatenate([250.0 * np.log(sig),
                        np.random.RandomState(3).uniform(-1600, 1600, 22)
                        ]).astype(np.float32)
    ours = adm_timestep_embedding(torch.from_numpy(t), dim).numpy()
    ref = np.asarray(jax_adm_embedding(jnp.asarray(t), dim))
    assert ours.shape == ref.shape == (32, dim)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_gaussian_logp_mean():
    rs = np.random.RandomState(4)
    x, mean = (rs.randn(3, 2, 4, 4).astype(np.float32) for _ in range(2))
    sigma = rs.uniform(1e-4, 2.0, (3, 1, 1, 1)).astype(np.float32)
    ours = gaussian_logp_mean(*(torch.from_numpy(a) for a in (x, mean, sigma)))
    ref = jax_logp(*(jnp.asarray(a) for a in (x, mean, sigma)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-5)
