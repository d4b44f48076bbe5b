"""Build ``adm_int8_golden.npz``: the JAX package's int8 (W8A8, static)
sampling of the trained ADM fixture (``tests/fixtures/torch_rundir_adm_t10``),
the reference that ``tests/test_torch_adm_int8_golden.py`` and
``chip_smoke.py`` (phase G2-int8) hold the port's ``generate_large --int8``
path to.

    python tests/torch_fixtures/make_adm_int8_golden.py   # from the repo root

The net is the JAX entry's ``--int8`` net: ``quant_int8='static'``,
``attn_impl='fused'`` (so ``quant_attn='static'``), ``up_impl='phase'``,
GroupNorm statistics ``bf16_onepass``, with ``DXMI_FUSED_ATTN_FORCE=1`` so
that the int8 attention kernel ``_kernel_i8`` runs (in interpret mode on the
CPU) and ``DXMI_FUSED_NOMAX=0`` (the port's softmax subtracts the max).

Calibration follows ``EDMSampler.calibrate_quant`` (two rounds of ten
full-precision steps at eight samples) from zero scales, with its draws
injected from ``chip_smoke.adm_int8_calib_draws(CALIB_SEED)``; the int8
trajectory restarts every step from the golden state, with the fixture's own
``x_init``, ``eps`` and ``y`` from ``golden.npz``.

Stored: ``calib_seed``; ``scale/<port buffer name>`` for every calibrated
scale, keyed by the port's state-dict names; ``means`` (T, 8, 3, 16, 16),
the int8 step means; ``final``, the last step's sample.
"""
from __future__ import annotations

import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_rundir_adm_t10")
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "adm_int8_golden.npz")
CALIB_SEED = 2024
ENV = {"DXMI_FUSED_ATTN_FORCE": "1", "DXMI_GN_STATS": "bf16_onepass",
       "DXMI_FUSED_NOMAX": "0"}


@contextlib.contextmanager
def _env(values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _nhwc(a):
    return jnp.asarray(np.moveaxis(np.asarray(a), -3, -1))


def _nchw(a):
    return np.moveaxis(np.asarray(a), -1, -3)


def build(teacher: dict | None = None) -> dict:
    """The golden arrays (see the module docstring), computed with JAX on
    the CPU. With ``teacher`` (a golden), step i starts from the teacher's
    state ``teacher["means"][i - 1] + sigma_i eps_i`` instead of this
    build's own, so that a rounding flip in one step does not carry into
    the next (on the host that wrote the golden the two are the same)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from chip_smoke import adm_int8_calib_draws
    from dxmi_tpu import config as cfglib
    from dxmi_tpu.models.unet_adm import create_unet_adm
    from dxmi_tpu.samplers.edm import EDMSampler, KarrasDenoiser
    from dxmi_tpu.utils import checkpoint as ckptlib
    from dxmi_tpu_torch.utils.convert import (_adm_module_path,
                                              adm_quant_scales_from_flax)

    with _env(ENV):
        cfg = cfglib.load_yaml(os.path.join(FIXTURE, "config.yaml"))
        golden = np.load(os.path.join(FIXTURE, "golden.npz"))
        dcfg = dict(cfg["diffusion"])
        smin, smax = dcfg.pop("sigma_min"), dcfg.pop("sigma_max")
        dcfg.pop("weight_schedule")
        dist = dcfg.pop("distillation")
        net = create_unet_adm(**dcfg, quant_int8="static", attn_impl="fused",
                              up_impl="phase")
        assert net.quant_attn == "static"
        sampler = EDMSampler(net, KarrasDenoiser(sigma_min=smin,
                                                 sigma_max=smax,
                                                 distillation=dist),
                             **cfg["sampler"])
        ckpt, _ = ckptlib.load_run_checkpoint(FIXTURE, "sampler", "last",
                                              torch_kind="unet_adm")
        params = jax.tree.map(jnp.asarray, ckpt["params"])
        R = sampler.sample_shape[0]
        shapes = jax.eval_shape(net.init, jax.random.key(0),
                                jnp.zeros((1, R, R, 3)), jnp.zeros((1,)),
                                jnp.zeros((1,), jnp.int32))["quant_scales"]
        scales = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
        sch = sampler.schedule
        sig_up = sampler.sigmas_up_all(params)

        @jax.jit
        def calib_step(net_params, scales, x, t, y, noise):
            sigma = jnp.take(sch.sigmas, t)
            _, denoised, upd = sampler.diffusion.denoise(
                net, net_params, x, sigma, y=y,
                extra_vars={"quant_scales": scales}, mutable=["quant_scales"])
            d = (x - denoised) / sigma[:, None, None, None]
            dt = (jnp.take(sch.sigma_down, t) - sigma)[:, None, None, None]
            return (x + d * dt + noise
                    * jnp.take(sig_up, t)[:, None, None, None],
                    upd["quant_scales"])

        x0, eps, ys = adm_int8_calib_draws(CALIB_SEED)
        n = x0.shape[1]
        for r in range(x0.shape[0]):
            x = _nhwc(x0[r])
            y = jnp.asarray(ys[r], jnp.int32)
            for i in range(sampler.n_timesteps):
                x, scales = calib_step(params["net"], scales, x,
                                       jnp.full((n,), i, jnp.int32), y,
                                       _nhwc(eps[r, i]))

        def teacher_scale(path, leaf):
            *mods, name = [p.key for p in path]
            key = ".".join([*(_adm_module_path(m) for m in mods), name])
            return jnp.asarray(teacher[f"scale/{key}"],
                               leaf.dtype).reshape(leaf.shape)

        qparams = dict(params, quant_scales=scales if teacher is None else
                       jax.tree_util.tree_map_with_path(teacher_scale,
                                                        scales))
        step = jax.jit(lambda p, x, t, y: sampler.sample_step(
            p, x, t, jax.random.key(0), y=y)["mean"])
        y = jnp.asarray(golden["y"], jnp.int32)
        x = golden["x_init"]
        means = []
        for i in range(sampler.n_timesteps):
            mean = _nchw(step(qparams, _nhwc(x),
                              jnp.full((len(y),), i, jnp.int32), y))
            means.append(mean.astype(np.float32))
            state = means[-1] if teacher is None else teacher["means"][i]
            x = state + golden["sigmas"][i] * golden["eps"][i]
        final = means[-1] + golden["sigmas"][-1] * golden["eps"][-1]
        out = {"calib_seed": np.int64(CALIB_SEED),
               "means": np.stack(means), "final": final.astype(np.float32)}
        for k, v in adm_quant_scales_from_flax(
                jax.tree.map(np.asarray, scales)).items():
            out[f"scale/{k}"] = v.numpy()
        return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    arrays = build()
    np.savez(GOLDEN, **arrays)
    print(f"wrote {GOLDEN}: {len(arrays)} arrays, "
          f"{os.path.getsize(GOLDEN)} bytes")
