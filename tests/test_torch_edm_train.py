"""EDMSampler's training surface: ``sample_step`` with one timestep per row,
differentiable in the net and in ``log_betas`` (``trainable_beta=
'fix_last'``), against ``jax.grad`` of ``dxmi_tpu.samplers.edm.EDMSampler.
sample_step`` on the trained ADM fixture, with the JAX step's own noise
injected; ``betas_for_q_default``; and the trajectory that the buffer
consumes."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dxmi_tpu import config as jax_cfg
from dxmi_tpu.models.unet_adm import create_unet_adm as jax_create
from dxmi_tpu.samplers.edm import EDMSampler as JaxEDM
from dxmi_tpu.samplers.edm import KarrasDenoiser as JaxKarras
from dxmi_tpu.utils import checkpoint as jax_ckpt
from dxmi_tpu_torch import generate_large
from dxmi_tpu_torch.config import load_yaml
from dxmi_tpu_torch.trainers.buffer import from_d_sample
from dxmi_tpu_torch.utils.checkpoint import load_sampler_state
from dxmi_tpu_torch.utils.convert import edm_sampler_from_flax

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "torch_rundir_adm_t10")


def _jax_sampler():
    cfg = jax_cfg.load_yaml(os.path.join(FIXTURE, "config.yaml"))
    d = dict(cfg["diffusion"])
    smin, smax = d.pop("sigma_min"), d.pop("sigma_max")
    d.pop("weight_schedule")
    dist = d.pop("distillation")
    sampler = JaxEDM(jax_create(**d), JaxKarras(sigma_min=smin,
                                                sigma_max=smax,
                                                distillation=dist),
                     **cfg["sampler"])
    ckpt, _ = jax_ckpt.load_run_checkpoint(FIXTURE, "sampler", "last",
                                           torch_kind="unet_adm")
    return sampler, jax.tree.map(jnp.asarray, ckpt["params"])


def _port_sampler():
    cfg = load_yaml(os.path.join(FIXTURE, "config.yaml"))
    return generate_large.load_sampler(
        cfg, load_sampler_state(os.path.join(FIXTURE, "sampler.pth")), "cpu",
        attn_impl="einsum", up_impl="resize", gn_stats="fp32")


def _loss_weights(B, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, 16, 16, 3).astype(np.float32),
            rs.randn(B).astype(np.float32))


def test_sample_step_grads_match_jax():
    """d/d(net, log_betas) of a loss over every output of the step
    (sample, mean, logp, entropy) at mixed timesteps, including the last
    (whose sigma fix_last pins): element by element within 1e-4 relative
    plus 1e-6 of the largest gradient of all (1.4e3): a conv bias that feeds
    a GroupNorm has a gradient of nearly cancelling terms, ~1e-5, whose
    digits are fp32 noise in both frameworks (0.13 of the limit at worst
    measured)."""
    B = 6
    rs = np.random.RandomState(0)
    x = (rs.randn(B, 16, 16, 3) * 5).astype(np.float32)
    t = np.array([0, 2, 5, 7, 8, 9])
    y = rs.randint(0, 4, B)
    w, u = _loss_weights(B, 1)
    key = jax.random.key(3)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))

    jsampler, params = _jax_sampler()

    def jloss(p):
        d = jsampler.sample_step(p, jnp.asarray(x), jnp.asarray(t), key,
                                 y=jnp.asarray(y), train=True)
        return (jnp.sum(d["sample"] * w) + 0.5 * jnp.sum(d["mean"] * w)
                + jnp.sum(d["logp"] * u) + jnp.sum(d["entropy"] * u))

    jl, jg = jax.value_and_grad(jloss)(params)
    want = edm_sampler_from_flax(jax.tree.map(np.asarray, jg))

    sampler = _port_sampler()
    wt = torch.from_numpy(w.transpose(0, 3, 1, 2))
    d = sampler.sample_step(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                            torch.from_numpy(t),
                            torch.from_numpy(noise.transpose(0, 3, 1, 2)),
                            torch.from_numpy(y), train=True)
    loss = ((d["sample"] * wt).sum() + 0.5 * (d["mean"] * wt).sum()
            + (d["logp"] * torch.from_numpy(u)).sum()
            + (d["entropy"] * torch.from_numpy(u)).sum())
    names = [n for n, _ in sampler.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       sampler.named_parameters()])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert set(names) == set(want)
    G = max(float(np.abs(v.numpy()).max()) for v in want.values())
    worst = 0.0
    for n, g in zip(names, grads):
        ref = want[n].numpy()
        worst = max(worst, float((np.abs(g.numpy() - ref)
                                  / (1e-4 * np.abs(ref) + 1e-6 * G)).max()))
    assert worst <= 1
    # fix_last: the last step's sigma is the schedule's, not exp(log_betas)
    assert float(want["log_betas"][-1]) == 0.0
    assert float(np.abs(want["log_betas"][:-1]).max()) > 0


def test_betas_for_q_default_is_sigmas_squared():
    jsampler, _ = _jax_sampler()
    sampler = _port_sampler()
    np.testing.assert_allclose(sampler.betas_for_q_default.numpy(),
                               np.asarray(jsampler.betas_for_q_default),
                               rtol=1e-6)


def test_trajectory_feeds_the_buffer():
    """sample() returns the per-step trajectory; from_d_sample lays it out
    (K=1, T, B) with x_{t+1} of step t equal to x_t of step t+1."""
    sampler = _port_sampler()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        d = sampler.sample(4, generator=gen)
    buf = from_d_sample(d)
    assert buf.state.shape == (1, 10, 4, 3, 16, 16)
    torch.testing.assert_close(buf.state[0, 1:], buf.next_state[0, :-1])
    torch.testing.assert_close(buf.next_state[0, -1], d["sample"])
    flat = buf.flat()
    assert flat["state"].shape == (40, 3, 16, 16)
    assert flat["timestep"].tolist() == sum(([t] * 4 for t in range(10)), [])
    assert torch.equal(flat["y"], d["y"].repeat(10))
