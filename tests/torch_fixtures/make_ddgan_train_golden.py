"""Build ``ddgan_train_golden.npz``: one ``DxMITrainer`` iteration of the JAX
package (``update_f_v`` then ``update_sampler``) with the trainer of
``configs/cifar10/T4_ddgan.yaml`` (``value_resample: true``, adavelreg,
gamma 1, the sampler's betas), on the small NCSN++ of
``chip_smoke.DDGAN_SMALL`` in a T=4 DDGANSampler and an IGEBM value at nh 16
(``chip_smoke.small_value``), both with numpy-made weights, batch 8: the
reference that tests/test_torch_ddgan_train.py and chip_smoke.py (phase G7)
hold the port's trainer to.

    python tests/torch_fixtures/make_ddgan_train_golden.py   # repo root

The draws are the JAX trainer's own, replayed from its key schedule: the
TD sweep's resampled policy steps (``dxmi.py:441-488``: ``fold_in(k_steps,
0)`` split T ways, the step key's first split; ``ddgan.py:133-151``: its z
and noise), and ``update_sampler``'s permutation, z and noise
(``dxmi.py:605-618``). ``build('var')`` runs the same iteration with a
small UNetSmall (dropout 0) in a T=4 VARSampler instead.

Stored (NCHW where an image): ``img``, ``l_sample``, ``sigma``, ``logp``,
``entropy``; ``resample/noise`` (T, B, 3, 16, 16) and ``resample/z`` (T, B,
nz) in sweep order (timestep T-1 first); ``perm``, ``noise`` (G, B, ...),
``z`` (G, B, nz); ``case/*``; ``metric/*``; ``log_betas`` after; each value
and sampler-net tensor's update norm and its projection on
``chip_smoke.direction`` (``vnorm/``, ``vproj/``, ``snorm/``, ``sproj/``).
"""
from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "ddgan_train_golden.npz")
B, LR, BETA_LR, V_LR, SEED = 8, 1e-4, 1e-3, 1e-3, 7
VAR_SMALL = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                 attn_resolutions=(8,), resolution=16, dropout=0.0)


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(np.asarray(a, np.float32), -1,
                                            -3))


def var_state(seed=11):
    """numpy-made weights of the small UNetSmall (reference names)."""
    from dxmi_tpu_torch.models.unet_small import UNetSmall

    rs = np.random.RandomState(seed)
    out = {}
    for k, v in UNetSmall(**VAR_SMALL).state_dict().items():
        shape = tuple(v.shape)
        if len(shape) == 1:
            a = float("norm" in k and k.endswith("weight")) \
                + 0.1 * rs.randn(*shape)
        else:
            a = rs.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        out[k] = a.astype(np.float32)
    return out


def build(kind="ddgan"):
    """(arrays to store, the port state dicts before and after)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    from make_ddgan_golden import ncsnpp_to_flax
    from dxmi_tpu import config as cfglib
    from dxmi_tpu.data.synthetic import structured_class_images
    from dxmi_tpu.models.ncsnpp import NCSNpp, NCSNppArgs
    from dxmi_tpu.models.unet_small import UNetSmall
    from dxmi_tpu.samplers.ddgan import DDGANSampler
    from dxmi_tpu.samplers.var import VARSampler
    from dxmi_tpu.trainers import buffer as buflib
    from dxmi_tpu.trainers.dxmi import DxMITrainer
    from dxmi_tpu.utils.convert import (convert_igebm, convert_unet_small,
                                        wrap_value_params)
    from dxmi_tpu_torch.utils.convert import (ddgan_sampler_from_flax,
                                              value_from_flax,
                                              var_sampler_from_flax)

    cfg = cfglib.load_yaml(chip_smoke.T4_DDGAN_CONFIG)
    T = chip_smoke.DDGAN_T
    if kind == "ddgan":
        sampler = DDGANSampler(NCSNpp(config=NCSNppArgs(
            **chip_smoke.DDGAN_SMALL)), T, (3, 16, 16))
        net_params = ncsnpp_to_flax(chip_smoke.ddgan_small_state())
        to_port = ddgan_sampler_from_flax
    else:
        sampler = VARSampler(UNetSmall(**VAR_SMALL), T, (3, 16, 16),
                             trainable_beta="fix_last")
        net_params = jax.tree.map(jnp.asarray,
                                  convert_unet_small(var_state())["params"])
        to_port = var_sampler_from_flax
    params = sampler.init_params(jax.random.key(0), net_params)
    vstate = {k: v.numpy() for k, v in
              chip_smoke.small_value(cfg).state_dict().items()}
    v_params = jax.tree.map(jnp.asarray, wrap_value_params(
        convert_igebm(vstate))["params"])
    vcfg = {**cfg["value"], "net": {**cfg["value"]["net"],
                                    "nh": chip_smoke.DDGAN_VALUE_NH}}
    value = cfglib.instantiate(vcfg)
    tcfg = {k: v for k, v in cfg["trainer"].items() if k != "_target_"}
    trainer = DxMITrainer(**{**tcfg, "batchsize": B, "n_timesteps": T})
    trainer.set_models(sampler, value, lr=LR, v_lr=V_LR, beta_lr=BETA_LR)
    state = trainer.init_state(params, v_params)

    img, _ = structured_class_images(B, 16, 10, seed=SEED)
    sk, uk, gk = jax.random.split(jax.random.key(SEED), 3)
    d_sample = jax.jit(lambda p, k: sampler.sample(p, k, B))(
        state.sampler_params, sk)
    traj = buflib.from_d_sample(d_sample)
    state1, m_energy = trainer.update_f_v(state, jnp.asarray(img), traj, uk)
    state2, m_sampler = trainer.update_sampler(state1, traj, gk)

    def step_draws(k, shape):
        """(noise, z or None) of a policy step with key ``k``."""
        if kind == "var":
            return jax.random.normal(k, shape), None
        k_z, k_n = jax.random.split(k)
        return (jax.random.normal(k_n, shape),
                jax.random.normal(k_z, (shape[0], sampler.nz)))

    shape = (B, 16, 16, 3)
    _, k_steps, _ = jax.random.split(uk, 3)
    res = [step_draws(jax.random.split(k, 4)[0], shape)
           for k in jax.random.split(jax.random.fold_in(k_steps, 0), T)]
    kk, pkey = jax.random.split(gk)
    perm = np.asarray(jax.random.permutation(pkey, T * B))
    (k,) = jax.random.split(kk, 1)
    noise, z = step_draws(jax.random.split(k)[0], shape)

    def np_tree(tree):
        return jax.tree.map(np.asarray, tree)

    v0, v1 = (value_from_flax(np_tree(st.v_params)) for st in (state, state2))
    s0, s1 = (to_port(np_tree(st.sampler_params)) for st in (state, state2))
    out = {"img": _nchw(img), "l_sample": _nchw(d_sample["l_sample"]),
           "sigma": np.asarray(d_sample["sigma"]),
           "logp": np.asarray(d_sample["logp"]),
           "entropy": np.asarray(d_sample["entropy"]),
           "resample/noise": np.stack([_nchw(n) for n, _ in res]),
           "perm": perm.astype(np.int64), "noise": _nchw(noise)[None],
           "case/batchsize": np.int64(B), "case/lr": np.float64(LR),
           "case/beta_lr": np.float64(BETA_LR), "case/v_lr": np.float64(V_LR),
           "log_betas": np.asarray(state2.sampler_params["log_betas"])}
    if kind == "ddgan":
        out["resample/z"] = np.stack([np.asarray(z_) for _, z_ in res])
        out["z"] = np.asarray(z)[None]
    for key, v in {**m_energy, **m_sampler}.items():
        out[f"metric/{key}"] = np.asarray(v, dtype=np.float32)
    for tag, before, after in (("v", v0, v1), ("s", s0, s1)):
        for name in before:
            if name == "log_betas":
                continue
            delta = (after[name] - before[name]).numpy().astype(np.float64)
            out[f"{tag}norm/{name}"] = np.float64(np.linalg.norm(delta))
            out[f"{tag}proj/{name}"] = np.float64(
                (delta * chip_smoke.direction(name, delta.shape)).sum())
    return out, {"sampler_before": s0, "value_before": v0}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    arrays, _ = build()
    np.savez(GOLDEN, **arrays)
    print(f"wrote {GOLDEN}: {len(arrays)} arrays, "
          f"{os.path.getsize(GOLDEN)} bytes")
