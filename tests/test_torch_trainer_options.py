"""The DxMI trainer's remaining options and value-guided sampling in the
port against ``dxmi_tpu``, from the same state (written by the JAX trainer,
loaded by the port), on JAX's trajectory, with the JAX trainer's draws
injected (``tests/torch_fixtures/trainer_cases.py``):

- the value orders ``shuffle`` and ``random`` (a fresh order each repeat),
  ``repeat_value_update`` = 2 with and without ``value_resample`` (fresh
  noise each repeat): ``update_f_v``'s metrics and every leaf of the state
  after it;
- ``aug`` (an augmentation that reads its key) through a whole iteration;
- ``training.n_critic`` = 2: two value updates, then the sampler update on
  the two trajectories concatenated (``buffer.concat``);
- ``sample_guidance``, base (VARSampler, with ``t_select``) and Cond
  (EDMSampler with class labels), on injected ``x0`` and per-step noise.

The separate energy ``f`` is held through a whole resumed iteration in
``tests/test_torch_train_state.py``.
"""
import numpy as np
import pytest
import torch

from dxmi_tpu_torch.trainers.buffer import concat
from dxmi_tpu_torch.utils.train_state import trainer_slots
from torch_fixtures import trainer_cases as tc


@pytest.fixture(scope="module")
def cifar():
    return tc.JaxCase("cifar")


def _close_leaves(trainer, state, prev=None, lim=1e-3):
    """Every leaf of the port's state within rtol/atol 1e-4 of JAX's, and
    (with ``prev``, the state before) the value's change within ``lim`` of
    JAX's change over the whole net."""
    slots = trainer_slots(trainer)
    got, want = tc.port_leaves(trainer), tc.jax_leaves(state)
    assert len(got) == len(want)
    num = den = 0.0
    for i, (slot, g, w) in enumerate(zip(slots, got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, slot.name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                   err_msg=slot.name)
        if prev is not None and slot.name.startswith(".v_params"):
            p = prev[i].astype(np.float64)
            num += float(((g - w.astype(np.float64)) ** 2).sum())
            den += float(((w - p) ** 2).sum())
    if prev is not None:
        assert den > 0 and np.sqrt(num / den) < lim, (num, den)


def _close_metrics(got, want):
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


OPTIONS = {
    "shuffle": dict(value_update_order="shuffle"),
    "random": dict(value_update_order="random", repeat_value_update=2),
    "repeat": dict(repeat_value_update=2),
    "repeat_resample": dict(repeat_value_update=2, value_resample=True),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_value_update_options_match_jax(cifar, name, tmp_path):
    """update_f_v under each option from the same state and trajectory:
    the metrics (per-step ones of the last repeat, their timestep labels
    included) and the state after it."""
    opts = OPTIONS[name]
    tc.rejit(cifar, **opts)
    try:
        d, traj = cifar.trajectory(cifar.state, 0)
        img, _ = cifar.batch(0)
        _, uk, _ = cifar.keys(0)
        state, m = cifar.trainer.update_f_v(cifar.state, img, traj, uk)
    finally:
        tc.rejit(cifar, value_update_order="backward", repeat_value_update=1,
                 value_resample=False)
    trainer = tc.port_trainer("cifar", **opts)
    tc.jax_to_port(cifar, cifar.state, trainer, tmp_path)
    got = trainer.update_f_v(tc.nchw(img), tc.port_buffer(d),
                             **cifar.f_v_draws(
                                 uk, reps=opts.get("repeat_value_update", 1)))
    _close_metrics(got, m)
    _close_leaves(trainer, state, tc.jax_leaves(cifar.state))
    if name == "random":
        assert list(got["per_step/t"].numpy()) != [3, 2, 1, 0]


def test_aug_matches_jax(cifar, tmp_path):
    """A whole iteration with an augmentation that reads its key: the
    energy step's inputs, both value inputs of each sweep step and the
    sampler update's next states, each with JAX's draw injected."""
    tc.rejit(cifar, aug=tc.jax_aug)
    try:
        state, m, d = cifar.iteration(cifar.state, 0)
    finally:
        tc.rejit(cifar, aug=None)
    trainer = tc.port_trainer("cifar", aug=tc.port_aug)
    tc.jax_to_port(cifar, cifar.state, trainer, tmp_path)
    got = tc.port_iteration(cifar, trainer, d, 0, aug=True)
    _close_metrics(got, m)
    _close_leaves(trainer, state, tc.jax_leaves(cifar.state))


def test_n_critic_matches_jax(cifar, tmp_path):
    """The n_critic = 2 loop of the CIFAR entry (``train_cifar10.py:
    305-338``): update_f_v on each of two trajectories, then one sampler
    update on both, concatenated."""
    from dxmi_tpu.trainers import buffer as buflib

    state, ds, trajs = cifar.state, [], []
    for it in (0, 1):
        d, traj = cifar.trajectory(state, it)
        img, _ = cifar.batch(it)
        _, uk, _ = cifar.keys(it)
        state, _ = cifar.trainer.update_f_v(state, img, traj, uk)
        ds.append(d)
        trajs.append(traj)
    _, _, gk = cifar.keys(1)
    state, m = cifar.trainer.update_sampler(state, buflib.concat(*trajs), gk,
                                            n_generator=1)

    trainer = tc.port_trainer("cifar")
    tc.jax_to_port(cifar, cifar.state, trainer, tmp_path)
    bufs = [tc.port_buffer(d) for d in ds]
    for it, buf in enumerate(bufs):
        img, _ = cifar.batch(it)
        _, uk, _ = cifar.keys(it)
        trainer.update_f_v(tc.nchw(img), buf, **cifar.f_v_draws(uk))
    full = concat(*bufs)
    assert full.state.shape[:3] == (2, tc.T, tc.B)
    got = trainer.update_sampler(full, n_generator=1,
                                 **cifar.sampler_draws(gk, 2 * tc.T * tc.B, 1))
    _close_metrics(got, m)
    _close_leaves(trainer, state)


def _guided_jax(jc, key, x0, y, t_select):
    kw = {"i_class": y} if jc.cond else {}
    return jc.trainer.sample_guidance(jc.state, key, tc.B,
                                      guidance_scale=0.1, x0=x0,
                                      t_select=t_select, **kw)


@pytest.mark.parametrize("case", ["cifar", "cond"])
def test_sample_guidance_matches_jax(case, tmp_path):
    """Guided trajectories from the same state, prior and per-step noise:
    the samples, the guidance, logp and logp_on (and their sums) within
    rtol 1e-4 / atol 1e-4 of their scale; the Cond trainer threads JAX's
    labels through every step and returns them."""
    import jax

    jc = tc.JaxCase(case)
    key = jax.random.key(11)
    shape = (tc.B, jc.res, jc.res, 3)
    x0 = jax.random.normal(jax.random.key(12), shape) * (
        80.0 if jc.cond else 1.0)
    y = jax.numpy.array([0, 3, 1, 2]) if jc.cond else None
    t_select = None if jc.cond else (1, 2)
    want = _guided_jax(jc, key, x0, y, t_select)
    step_key = jax.random.split(key)[0] if jc.cond else key
    noise = [tc.nchw(jax.random.normal(k, shape))
             for k in jax.random.split(step_key, tc.T)]

    trainer = tc.port_trainer(case)
    tc.jax_to_port(jc, jc.state, trainer, tmp_path)
    kw = {"y": torch.from_numpy(np.asarray(y)).long()} if jc.cond else {}
    got = trainer.sample_guidance(tc.B, 0.1, x0=tc.nchw(x0),
                                  t_select=t_select, noise=noise, **kw)
    for k in ("sample", "l_sample", "guidance"):
        w = np.moveaxis(np.asarray(want[k]), -1, -3)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
    for k in ("logp", "logp_on", "logp_traj", "logp_on_traj"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert np.abs(np.asarray(want["guidance"])).max() > 0
    if jc.cond:
        assert torch.equal(got["y"], kw["y"])
    else:
        assert got["y"] is None


def test_cond_guidance_draws_labels():
    """Without labels the Cond trainer draws them from the generator over
    the sampler's classes, or takes ``i_class``, and every step sees
    them."""
    trainer = tc.port_trainer("cond")
    seen = []
    step = trainer.sampler.sample_step

    def spy(x, t, noise=None, y=None, **kw):
        seen.append(y)
        return step(x, t, noise, y, **kw)

    trainer.sampler.sample_step = spy
    gen = torch.Generator().manual_seed(0)
    out = trainer.sample_guidance(6, 0.1, generator=gen)
    assert out["y"].shape == (6,) and int(out["y"].max()) < 4
    assert len(seen) == tc.T and all(torch.equal(s, out["y"]) for s in seen)
    out = trainer.sample_guidance(3, 0.1, generator=gen, i_class=2)
    assert out["y"].tolist() == [2, 2, 2]
    assert torch.isfinite(out["sample"]).all()
