"""Build ``adm_train_golden.npz``: one ``DxMITrainerCond`` iteration of the JAX
package (``update_f_v`` then ``update_sampler``) on the trained ADM fixture
(``tests/fixtures/torch_rundir_adm_t10``, fp32, einsum attention), the
reference that ``tests/test_torch_train_slice.py`` and ``chip_smoke.py``
(phase G3) hold the port's trainer to.

    python tests/torch_fixtures/make_adm_train_golden.py   # from the repo root

The case: the fixture's trainer config at batch ``B``, learning rates large
enough that one iteration moves the parameters well above fp32 rounding;
the data batch from ``structured_class_images``; a trajectory sampled by the
JAX sampler; and the JAX trainer's own draws for the sampler update (its
permutation and each minibatch's step noise, from the key schedule of
``dxmi.py:605-615`` and ``:642`` and the normal draw of ``edm.py:211``),
which the port takes injected.

Stored (NCHW where an image): ``img``, ``y``, ``l_sample``, ``sigma``,
``logp``, ``entropy``, ``traj_y`` (the policy means are left out: the
trainer reads none); ``perm`` and ``noise`` (G, B,
3, 16, 16); ``case/*`` (batch and rates); ``metric/*`` (every metric of the
two phases); ``log_betas`` after; and for every value and sampler-net
tensor (port state-dict names) the norm of its update (``vnorm/``,
``snorm/``) and the update's dot product with a fixed direction
(``vproj/``, ``sproj/``, from ``direction(name, shape)``).
"""
from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_rundir_adm_t10")
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "adm_train_golden.npz")
B, LR, BETA_LR, V_LR, SEED = 8, 1e-4, 1e-3, 1e-3, 7


def _nhwc(a):
    return jnp.asarray(np.moveaxis(np.asarray(a), -3, -1))


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3))


def build():
    """(arrays to store, full JAX results): the latter holds the value and
    sampler states before and after the iteration as the port's state
    dicts (numpy), for the CPU test's element-wise comparison."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    from dxmi_tpu import config as cfglib
    from dxmi_tpu.data.synthetic import structured_class_images
    from dxmi_tpu.models.unet_adm import create_unet_adm
    from dxmi_tpu.samplers.edm import EDMSampler, KarrasDenoiser
    from dxmi_tpu.trainers import buffer as buflib
    from dxmi_tpu.trainers.dxmi_cond import DxMITrainerCond
    from dxmi_tpu.utils import checkpoint as ckptlib
    from dxmi_tpu_torch.utils.convert import (edm_sampler_from_flax,
                                              value_from_flax)

    cfg = cfglib.load_yaml(os.path.join(FIXTURE, "config.yaml"))
    dcfg = dict(cfg["diffusion"])
    smin, smax = dcfg.pop("sigma_min"), dcfg.pop("sigma_max")
    dcfg.pop("weight_schedule")
    dist = dcfg.pop("distillation")
    net = create_unet_adm(**dcfg)
    sampler = EDMSampler(net, KarrasDenoiser(sigma_min=smin, sigma_max=smax,
                                             distillation=dist),
                         **cfg["sampler"])
    s_ckpt, _ = ckptlib.load_run_checkpoint(FIXTURE, "sampler", "last",
                                            torch_kind="unet_adm")
    v_ckpt, _ = ckptlib.load_run_checkpoint(FIXTURE, "value", "last",
                                            torch_kind="value")
    params = jax.tree.map(jnp.asarray, s_ckpt["params"])
    v_params = jax.tree.map(jnp.asarray, v_ckpt["params"])
    value = cfglib.instantiate(cfg["value"])
    tcfg = {k: v for k, v in cfg["trainer"].items() if k != "_target_"}
    trainer = DxMITrainerCond(**{**tcfg, "batchsize": B})
    trainer.set_models(sampler, value, lr=LR, v_lr=V_LR, beta_lr=BETA_LR)
    state = trainer.init_state(params, v_params)

    res = sampler.sample_shape[0]
    img, y = structured_class_images(B, res, sampler.num_classes, seed=SEED)
    key = jax.random.key(SEED)
    sk, uk, gk = jax.random.split(key, 3)
    d_sample = jax.jit(lambda p, k: sampler.sample(p, k, B))(
        state.sampler_params, sk)
    traj = buflib.from_d_sample(d_sample)
    state1, m_energy = trainer.update_f_v(state, jnp.asarray(img), traj, uk,
                                          y=jnp.asarray(y))
    state2, m_sampler = trainer.update_sampler(state1, traj, gk)

    # the update's draws, replayed from its key schedule
    N = sampler.n_timesteps * B
    G = N // B
    kk, pkey = jax.random.split(gk)
    perm = np.asarray(jax.random.permutation(pkey, N))
    noise = []
    for k in jax.random.split(kk, G):
        k_step, _ = jax.random.split(k)
        noise.append(_nchw(jax.random.normal(
            k_step, (B, res, res, 3), dtype=jnp.float32)))

    def np_tree(t):
        return jax.tree.map(np.asarray, t)

    v0, v1 = (value_from_flax(np_tree(s.v_params)) for s in (state, state2))
    s0, s1 = (edm_sampler_from_flax(np_tree(s.sampler_params))
              for s in (state, state2))
    out = {"img": _nchw(img), "y": y.astype(np.int64),
           "l_sample": _nchw(d_sample["l_sample"]),
           "sigma": np.asarray(d_sample["sigma"]),
           "logp": np.asarray(d_sample["logp"]),
           "entropy": np.asarray(d_sample["entropy"]),
           "traj_y": np.asarray(d_sample["y"]).astype(np.int64),
           "perm": perm.astype(np.int64), "noise": np.stack(noise),
           "case/batchsize": np.int64(B), "case/lr": np.float64(LR),
           "case/beta_lr": np.float64(BETA_LR), "case/v_lr": np.float64(V_LR),
           "log_betas": np.asarray(state2.sampler_params["log_betas"])}
    for k, v in {**m_energy, **m_sampler}.items():
        out[f"metric/{k}"] = np.asarray(v, dtype=np.float32)
    for tag, before, after in (("v", v0, v1), ("s", s0, s1)):
        for name in before:
            if name == "log_betas":
                continue
            delta = (after[name] - before[name]).numpy().astype(np.float64)
            out[f"{tag}norm/{name}"] = np.float64(np.linalg.norm(delta))
            out[f"{tag}proj/{name}"] = np.float64(
                (delta * chip_smoke.direction(name, delta.shape)).sum())
    full = {"value_before": v0, "value_after": v1, "sampler_before": s0,
            "sampler_after": s1}
    return out, full


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    arrays, _ = build()
    np.savez(GOLDEN, **arrays)
    print(f"wrote {GOLDEN}: {len(arrays)} arrays, "
          f"{os.path.getsize(GOLDEN)} bytes")
