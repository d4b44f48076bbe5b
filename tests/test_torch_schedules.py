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
