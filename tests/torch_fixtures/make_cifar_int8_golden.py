"""Build ``cifar_int8_golden.npz``: the JAX package's int8 (W8A8, static)
sampling of the trained CIFAR fixture (``tests/fixtures/torch_rundir_t10``),
the reference that ``tests/test_torch_cifar_int8_golden.py`` and
``chip_smoke.py`` (phase G-int8) hold the port's ``generate_cifar10 --int8``
path to.

    python tests/torch_fixtures/make_cifar_int8_golden.py   # from the repo root

The net is the JAX entry's ``--int8`` net (``generate_cifar10.py:149-163``):
the fixture's UNetSmall with ``quant_int8='static'`` and UNetSmall's other
defaults (fp32, einsum attention with int8 1x1s, int8 stride-2 Downsample and
resize Upsample convs), GroupNorm statistics ``fp32``.

Calibration follows ``VARSampler.calibrate_quant`` (two rounds of ten
full-precision steps) from zero scales, with its draws injected from
``chip_smoke.cifar_int8_calib_draws(CALIB_SEED)``; the int8 trajectory
restarts every step from the golden state, with the fixture's own ``x0`` and
``eps`` from ``golden.npz``.

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
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_rundir_t10")
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "cifar_int8_golden.npz")
CALIB_SEED = 2025
ENV = {"DXMI_GN_STATS": "fp32"}


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
    the CPU. With ``teacher`` (a golden), the int8 steps use the teacher's
    scales and step i starts from the teacher's state ``teacher["means"][i
    - 1] + sigma_i eps_i`` instead of this build's own, so that a rounding
    flip in one step does not carry into the next (on the host that wrote
    the golden the two are the same)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from chip_smoke import cifar_int8_calib_draws
    from dxmi_tpu import config as cfglib
    from dxmi_tpu.config import instantiate
    from dxmi_tpu.utils import checkpoint as ckptlib
    from dxmi_tpu_torch.utils.convert import (
        _unet_small_path, unet_small_quant_scales_from_flax)

    with _env(ENV):
        cfg = cfglib.load_yaml(os.path.join(FIXTURE, "config.yaml"))
        golden = np.load(os.path.join(FIXTURE, "golden.npz"))
        net = instantiate(cfg["sampler_net"], quant_int8="static")
        sampler = instantiate(cfg["sampler"], net=net)
        ckpt, _ = ckptlib.load_run_checkpoint(FIXTURE, "sampler", "best",
                                              torch_kind="unet_small")
        params = jax.tree.map(jnp.asarray, ckpt["params"])
        if "log_betas" not in params:
            params = {**sampler.init_params(jax.random.key(0),
                                            params["net"]), **params}
        R = sampler.sample_shape[0]
        shapes = jax.eval_shape(net.init, jax.random.key(0),
                                jnp.zeros((1, R, R, 3)), jnp.zeros((1,)))
        scales = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                              shapes["quant_scales"])
        sch = sampler.schedule
        sigmas = sampler.sigmas_all(params)

        @jax.jit
        def calib_step(scales, x, i, noise):
            tau = jnp.full((x.shape[0],), jnp.take(sch.tau, i))
            eps, upd = net.apply({"params": params["net"],
                                  "quant_scales": scales}, x, tau,
                                 mutable=["quant_scales"])
            mean = (x * jnp.take(sch.x_mult, i)
                    + jnp.take(sch.eps_mult, i) * eps)
            return mean + jnp.take(sigmas, i) * noise, upd["quant_scales"]

        x0, eps = cifar_int8_calib_draws(CALIB_SEED)
        for r in range(x0.shape[0]):
            x = _nhwc(x0[r])
            for i in range(sampler.n_timesteps):
                x, scales = calib_step(scales, x, i, _nhwc(eps[r, i]))

        def teacher_scale(path, leaf):
            *mods, name = [p.key for p in path]
            key = f"{_unet_small_path(mods)}.{name}"
            return jnp.asarray(teacher[f"scale/{key}"],
                               leaf.dtype).reshape(leaf.shape)

        qparams = dict(params, quant_scales=scales if teacher is None else
                       jax.tree_util.tree_map_with_path(teacher_scale,
                                                        scales))
        step = jax.jit(lambda p, x, t: sampler.sample_step(
            p, x, t, jax.random.key(0))["mean"])
        x = golden["x0"]
        means = []
        for i in range(sampler.n_timesteps):
            mean = _nchw(step(qparams, _nhwc(x),
                              jnp.full((x.shape[0],), i, jnp.int32)))
            means.append(mean.astype(np.float32))
            state = means[-1] if teacher is None else teacher["means"][i]
            x = state + golden["sigmas"][i] * golden["eps"][i]
        final = means[-1] + golden["sigmas"][-1] * golden["eps"][-1]
        out = {"calib_seed": np.int64(CALIB_SEED),
               "means": np.stack(means), "final": final.astype(np.float32)}
        for k, v in unet_small_quant_scales_from_flax(
                jax.tree.map(np.asarray, scales)).items():
            out[f"scale/{k}"] = v.numpy()
        return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    arrays = build()
    np.savez(GOLDEN, **arrays)
    print(f"wrote {GOLDEN}: {len(arrays)} arrays, "
          f"{os.path.getsize(GOLDEN)} bytes")
