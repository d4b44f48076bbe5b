"""Build ``ev_golden.npz``, G9's reference: one ``DxMITrainerEV`` iteration
of ``dxmi_tpu`` at ``chip_smoke.EV_SMALL`` (train_anomaly's nets at image
16, T = 4, batch 4) with a spectral-norm energy, on the numpy-made weights
of ``chip_smoke.ev_small_trainer`` carried to flax by the port's
``flax_tree``.

    python tests/torch_fixtures/make_ev_golden.py   # ~30 s on the CPU

The golden keeps the case, the data batch, JAX's trajectory (NCHW), the
draws of its keys (each TD step's policy noise in sweep order;
update_sampler's permutation and noise), the metrics, f's ``sn_stats``
after the iteration under the port's buffer names, and the norm of each
net's update. ``jax_ev_iteration`` is also the live reference of
``tests/test_torch_ev_trainer.py``.
"""
from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

OUT = os.path.join(HERE, "ev_golden.npz")


def _nchw(a) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3))


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _norm(a, b) -> np.float64:
    return np.float64(np.sqrt(sum(
        float(((np.asarray(x, np.float64) - np.asarray(y, np.float64)) ** 2
               ).sum()) for x, y in zip(jax.tree.leaves(a),
                                        jax.tree.leaves(b)))))


def jax_ev_iteration(spectral_norm: bool):
    """One JAX EV iteration on ``ev_small_trainer``'s weights; returns the
    golden's arrays."""
    import chip_smoke as cs
    from dxmi_tpu.models.igebm import IGEBMEncoder
    from dxmi_tpu.models.unet_small import UNetSmall, UNetSmallEncoder
    from dxmi_tpu.samplers.var import VARSampler
    from dxmi_tpu.trainers import buffer as buflib
    from dxmi_tpu.trainers.dxmi_ev import DxMITrainerEV
    from dxmi_tpu_torch.utils.convert import module_from_flax
    from dxmi_tpu_torch.utils.train_state import flax_tree

    size, T, nh, ch = (cs.EV_SMALL[k] for k in ("image_size", "n_timesteps",
                                                 "nh", "ch"))
    B = cs.EV_BATCH
    port = cs.ev_small_trainer(spectral_norm, "cpu")
    net = UNetSmall(ch=ch, out_ch=3, ch_mult=(1, 2, 2), num_res_blocks=1,
                    attn_resolutions=(size // 4,), dropout=0.0,
                    in_channels=3, resolution=size)
    sampler = VARSampler(net, n_timesteps=T, sample_shape=(3, size, size),
                         trainable_beta=True)
    value = UNetSmallEncoder(ch=ch // 2, out_ch=1, ch_mult=(1, 2),
                             num_res_blocks=1, attn_resolutions=(),
                             dropout=0.0, in_channels=3, resolution=size)
    energy = IGEBMEncoder(in_chan=3, out_chan=1, keepdim=False,
                          learn_out_scale=True, nh=nh,
                          use_spectral_norm=spectral_norm)
    tr = DxMITrainerEV(batchsize=B, tau1=cs.EV_HP["tau1"],
                       tau2=cs.EV_HP["tau2"], n_timesteps=T,
                       use_sampler_beta=True, adavelreg=0.99)
    tr.set_models(sampler, value, energy, lr=cs.EV_HP["lr"],
                  v_lr=cs.EV_HP["v_lr"], f_lr=cs.EV_HP["f_lr"])
    sp = {"net": _jnp(flax_tree(port.sampler.net)),
          "log_betas": jnp.asarray(port.sampler.log_betas.detach().numpy())}
    f_stats = (_jnp(flax_tree(port.energy, stats=True)) if spectral_norm
               else None)
    state = tr.init_state_ev(sp, _jnp(flax_tree(port.value)),
                             _jnp(flax_tree(port.energy)), f_stats=f_stats)

    rs = np.random.RandomState(cs.EV_SEED)
    img = (rs.rand(B, size, size, 3) * 2 - 1).astype(np.float32)
    sk, uk, gk = jax.random.split(jax.random.key(cs.EV_SEED), 3)
    d = sampler.sample(state.sampler_params, sk, B)
    traj = buflib.from_d_sample(d)
    s1, m1 = tr.update_f_v(state, jnp.asarray(img), traj, uk)
    s2, m2 = tr.update_sampler(s1, traj, gk, n_generator=1)

    keys = jax.random.split(uk, T)
    shape = (B, size, size, 3)
    td_noise = np.stack([_nchw(jax.random.normal(keys[T - 1 - i], shape))
                         for i in range(T)])
    kk, pkey = jax.random.split(gk)
    k_step, _ = jax.random.split(jax.random.split(kk, 1)[0])
    out = {"case/spectral_norm": np.asarray(spectral_norm),
           "img": _nchw(img), "l_sample": _nchw(d["l_sample"]),
           **{k: np.asarray(d[k]) for k in ("sigma", "logp", "entropy")},
           "td_noise": td_noise,
           "perm": np.asarray(jax.random.permutation(pkey, T * B)),
           "noise": _nchw(jax.random.normal(k_step, shape))[None]}
    out.update({f"metric/{k}": np.asarray(v) for k, v in {**m1, **m2}.items()})
    if spectral_norm:
        after = module_from_flax(port.energy, jax.tree.map(
            np.asarray, s2.f_params), jax.tree.map(np.asarray, s2.f_stats))
        out.update({f"sn/{k}": v.numpy() for k, v in after.items()
                    if k.endswith((".u", ".sigma"))})
    out["update/f"] = _norm(s2.f_params, state.f_params)
    out["update/v"] = _norm(s2.v_params, state.v_params)
    out["update/s"] = _norm(s2.sampler_params["net"],
                            state.sampler_params["net"])
    return out


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    golden = jax_ev_iteration(True)
    np.savez_compressed(OUT, **golden)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes, {len(golden)} "
          "arrays)")


if __name__ == "__main__":
    main()
