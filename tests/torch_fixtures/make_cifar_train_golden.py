"""Build ``cifar_train_golden.npz``: one ``DxMITrainer`` iteration of the JAX
package (``update_f_v`` then ``update_sampler``) on the trained CIFAR fixture
(``tests/fixtures/torch_rundir_t10``: UNetSmall + VARSampler + IGEBM value,
fp32, einsum attention, dropout 0.1), the reference that
``tests/test_torch_cifar_train.py`` and ``chip_smoke.py`` (phase G4) hold the
port's trainer to.

    python tests/torch_fixtures/make_cifar_train_golden.py   # from the repo root

The case: the fixture's trainer config at batch ``B``, learning rates large
enough that one iteration moves the parameters well above fp32 rounding; the
data batch from ``structured_class_images``; a trajectory sampled by the JAX
sampler; and the JAX trainer's own draws for the sampler update, replayed
from its key schedule (``dxmi.py:605-615``, ``:642``): its permutation, the
minibatch's step noise (``var.py:131``) and the dropout keep masks of the
minibatch's training-mode forward, one per ResnetBlock in call order,
captured with ``flax.linen.intercept_methods`` around ``nn.Dropout``.

Stored (NCHW where an image): ``img``, ``l_sample``, ``sigma``, ``logp``,
``entropy`` (the policy means are left out: the trainer reads none);
``perm``, ``noise`` (G, B, 3, 16, 16), ``dropout/NN`` (each mask's bits,
``np.packbits`` of the NCHW bool mask) with ``dropout_shape/NN``; ``case/*``
(batch and rates); ``metric/*`` (every metric of the two phases);
``log_betas`` after; and for every value and sampler-net tensor (port
state-dict names) the norm of its update (``vnorm/``, ``snorm/``) and the
update's dot product with a fixed direction (``vproj/``, ``sproj/``, from
``chip_smoke.direction``).
"""
from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_rundir_t10")
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "cifar_train_golden.npz")
B, LR, BETA_LR, V_LR, SEED = 8, 1e-4, 1e-3, 1e-3, 7


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3))


def dropout_masks(sampler, params, s, t, k_step, k_drop):
    """The keep masks (NHWC bool) of one training-mode ``sample_step``, in
    call order, and the step's output (unchanged by the capture: the
    interceptor draws each mask from the same rng as the layer would and
    applies it as flax does)."""
    import flax.linen as nn

    masks = []

    def interceptor(next_fun, args, kwargs, context):
        if not (isinstance(context.module, nn.Dropout)
                and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        x = args[0]
        keep = jnp.asarray(next_fun(jnp.ones_like(x), *args[1:], **kwargs)) > 0
        masks.append(np.asarray(keep))
        return jax.lax.select(keep, x / (1.0 - context.module.rate),
                              jnp.zeros_like(x))

    with nn.intercept_methods(interceptor):
        out = sampler.sample_step(params, s, t, k_step, train=True,
                                  dropout_rng=k_drop)
    return masks, out


def build(net_overrides=None, value_net_overrides=None):
    """(arrays to store, full JAX results): the latter holds the value and
    sampler states before and after the iteration as the port's state dicts
    (numpy), and the masks (NHWC). ``net_overrides`` and
    ``value_net_overrides`` go to the sampler net's and the value net's
    constructors, as the JAX entry's ``build`` passes them
    (``train_cifar10.py:47-53``)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    from dxmi_tpu import config as cfglib
    from dxmi_tpu.data.synthetic import structured_class_images
    from dxmi_tpu.trainers import buffer as buflib
    from dxmi_tpu.trainers.dxmi import DxMITrainer
    from dxmi_tpu.utils import checkpoint as ckptlib
    from dxmi_tpu_torch.utils.convert import (value_from_flax,
                                              var_sampler_from_flax)

    cfg = cfglib.load_yaml(os.path.join(FIXTURE, "config.yaml"))
    net = cfglib.instantiate(cfg["sampler_net"], **(net_overrides or {}))
    sampler = cfglib.instantiate(cfg["sampler"], net=net)
    s_ckpt, _ = ckptlib.load_run_checkpoint(FIXTURE, "sampler", "best",
                                            torch_kind="unet_small")
    v_ckpt, _ = ckptlib.load_run_checkpoint(FIXTURE, "value", "best",
                                            torch_kind="value")
    params = jax.tree.map(jnp.asarray, s_ckpt["params"])
    v_params = jax.tree.map(jnp.asarray, v_ckpt["params"])
    vcfg = cfg["value"]
    if value_net_overrides:
        vcfg = {**vcfg, "net": {**vcfg["net"], **value_net_overrides}}
    value = cfglib.instantiate(vcfg)
    tcfg = {k: v for k, v in cfg["trainer"].items() if k != "_target_"}
    T = int(cfg["sampler"]["n_timesteps"])
    trainer = DxMITrainer(**{**tcfg, "batchsize": B, "n_timesteps": T})
    trainer.set_models(sampler, value, lr=LR, v_lr=V_LR, beta_lr=BETA_LR)
    state = trainer.init_state(params, v_params)

    res = sampler.sample_shape[0]
    img, _ = structured_class_images(B, res, 10, seed=SEED)
    sk, uk, gk = jax.random.split(jax.random.key(SEED), 3)
    d_sample = jax.jit(lambda p, k: sampler.sample(p, k, B))(
        state.sampler_params, sk)
    traj = buflib.from_d_sample(d_sample)
    state1, m_energy = trainer.update_f_v(state, jnp.asarray(img), traj, uk)
    state2, m_sampler = trainer.update_sampler(state1, traj, gk)

    # the update's draws, replayed from its key schedule (one minibatch)
    flat = traj.flat()
    N = T * B
    kk, pkey = jax.random.split(gk)
    perm = np.asarray(jax.random.permutation(pkey, N))
    (k,) = jax.random.split(kk, 1)
    k_step, k_drop = jax.random.split(k)
    idx = jnp.asarray(perm[:B])
    s = jnp.take(flat["state"], idx, axis=0)
    t = jnp.take(flat["timestep"], idx, axis=0)
    noise = jax.random.normal(k_step, s.shape, dtype=s.dtype)
    masks, step = dropout_masks(sampler, state1.sampler_params, s, t, k_step,
                                k_drop)
    plain = sampler.sample_step(state1.sampler_params, s, t, k_step,
                                train=True, dropout_rng=k_drop)
    np.testing.assert_array_equal(np.asarray(step["sample"]),
                                  np.asarray(plain["sample"]))

    def np_tree(tree):
        return jax.tree.map(np.asarray, tree)

    v0, v1 = (value_from_flax(np_tree(st.v_params)) for st in (state, state2))
    s0, s1 = (var_sampler_from_flax(np_tree(st.sampler_params))
              for st in (state, state2))
    out = {"img": _nchw(img),
           "l_sample": _nchw(d_sample["l_sample"]),
           "sigma": np.asarray(d_sample["sigma"]),
           "logp": np.asarray(d_sample["logp"]),
           "entropy": np.asarray(d_sample["entropy"]),
           "perm": perm.astype(np.int64), "noise": _nchw(noise)[None],
           "case/batchsize": np.int64(B), "case/lr": np.float64(LR),
           "case/beta_lr": np.float64(BETA_LR), "case/v_lr": np.float64(V_LR),
           "log_betas": np.asarray(state2.sampler_params["log_betas"])}
    for i, m in enumerate(masks):
        m = _nchw(m)
        out[f"dropout/{i:02d}"] = np.packbits(m.reshape(-1))
        out[f"dropout_shape/{i:02d}"] = np.asarray(m.shape, np.int64)
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
    full = {"value_before": v0, "value_after": v1, "sampler_before": s0,
            "sampler_after": s1}
    return out, full


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    arrays, _ = build()
    np.savez(GOLDEN, **arrays)
    print(f"wrote {GOLDEN}: {len(arrays)} arrays, "
          f"{os.path.getsize(GOLDEN)} bytes")
