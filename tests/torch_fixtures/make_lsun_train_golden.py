"""Build ``lsun_train_golden.npz``: one ``DxMITrainerCond`` iteration of the
JAX package (``update_f_v`` then ``update_sampler``) with configs/lsun/
T4_wide.yaml's trainer (unconditional, ``sigma_scale`` 30, ``time_cost`` 0,
``value_grad_clip``) on the small LSUN net (``chip_smoke.LSUN_SMALL``,
fp32, einsum attention) and a small Wide-ResNet value
(``chip_smoke.LSUN_SMALL_WRN``), both with numpy-made weights: the reference
that ``tests/test_torch_lsun.py`` and ``chip_smoke.py`` (phase G8) hold the
port's trainer to.

    python tests/torch_fixtures/make_lsun_train_golden.py   # from the repo root

The case follows ``make_adm_train_golden.py``: batch ``B``, learning rates
large enough that one iteration moves the parameters well above fp32
rounding, the data batch from ``structured_class_images``, a trajectory
sampled by the JAX sampler, and the JAX trainer's own draws for the sampler
update (its permutation and each minibatch's step noise, replayed from its
key schedule), which the port takes injected. Stored: as
``adm_train_golden.npz`` without labels, but the data batch as its seed
``data_seed`` (the port's ``structured_class_images`` is the same numpy
code) and the per-tensor update norms and projections packed by family
(``chip_smoke.pack_update_families``), so that the file stays under 1 MB.
"""
from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
B, LR, BETA_LR, V_LR, SEED = 2, 1e-4, 1e-3, 1e-3, 9


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3))


def wideresnet_to_flax(state):
    """The port's WideResNet state dict (numpy, ``net.`` prefixed or not)
    as the JAX net's params tree: OIHW -> HWIO, the Linear weight
    transposed, GroupNorm ``weight`` -> ``scale``."""
    params = {}
    for key, val in state.items():
        *mods, leaf = key.removeprefix("net.").split(".")
        node = params
        for m in mods:
            node = node.setdefault(m, {})
        if leaf == "bias":
            node["bias"] = val
        elif val.ndim == 4:
            node["kernel"] = val.transpose(2, 3, 1, 0)
        elif val.ndim == 2:
            node["kernel"] = val.T
        else:
            node["scale"] = val
    return params


def build():
    """(arrays to store, full JAX results): the latter holds the value and
    sampler states before and after the iteration as the port's state
    dicts, for the CPU test's element-wise comparison."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    from make_lsun_golden import flax_params, jax_sampler
    from dxmi_tpu import config as cfglib
    from dxmi_tpu.data.synthetic import structured_class_images
    from dxmi_tpu.trainers import buffer as buflib
    from dxmi_tpu.trainers.dxmi_cond import DxMITrainerCond
    from dxmi_tpu_torch.utils.convert import (edm_sampler_from_flax,
                                              value_from_flax)

    cfg = cfglib.load_yaml(chip_smoke.LSUN_T4_WIDE_CONFIG)
    sampler, _ = jax_sampler()
    params = {"net": flax_params(),
              "log_betas": sampler.init_params(jax.random.key(0))[
                  "log_betas"]}
    value = cfglib.instantiate({**cfg["value"], "net": {
        **cfg["value"]["net"], **chip_smoke.LSUN_SMALL_WRN}})
    v_state = {k: v.numpy() for k, v in
               chip_smoke.lsun_small_value().state_dict().items()}
    v_params = {"net": jax.tree.map(jnp.asarray,
                                    wideresnet_to_flax(v_state))}
    tcfg = {k: v for k, v in cfg["trainer"].items() if k != "_target_"}
    trainer = DxMITrainerCond(**{**tcfg, "batchsize": B})
    trainer.set_models(sampler, value, lr=LR, v_lr=V_LR, beta_lr=BETA_LR)
    state = trainer.init_state(params, v_params)

    res = sampler.sample_shape[0]
    img, _ = structured_class_images(B, res, 1, seed=SEED)
    key = jax.random.key(SEED)
    sk, uk, gk = jax.random.split(key, 3)
    d_sample = jax.jit(lambda p, k: sampler.sample(p, k, B))(
        state.sampler_params, sk)
    traj = buflib.from_d_sample(d_sample)
    state1, m_energy = trainer.update_f_v(state, jnp.asarray(img), traj, uk)
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
    out = {"data_seed": np.int64(SEED),
           "l_sample": _nchw(d_sample["l_sample"]),
           "sigma": np.asarray(d_sample["sigma"]),
           "logp": np.asarray(d_sample["logp"]),
           "entropy": np.asarray(d_sample["entropy"]),
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
    sys.path.insert(0, REPO)
    import chip_smoke

    packed = chip_smoke.pack_update_families(arrays)
    np.savez_compressed(chip_smoke.LSUN_TRAIN_GOLDEN, **packed)
    print(f"wrote {chip_smoke.LSUN_TRAIN_GOLDEN}: {len(packed)} arrays, "
          f"{os.path.getsize(chip_smoke.LSUN_TRAIN_GOLDEN)} bytes")
