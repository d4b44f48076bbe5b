"""Build ``edm16_golden.npz``: the JAX package's EDMSampler from
``runs_conv/pre_edm16.msgpack`` (the pretrained net of
``configs/imagenet64/conv16.yaml``) on one injected trajectory, the reference
that ``tests/test_torch_msgpack.py`` and ``chip_smoke.py`` (phase G5) hold
the port's sampler to after it loads the same file with its own msgpack
reader.

    python tests/torch_fixtures/make_edm16_golden.py   # from the repo root

The net is the JAX training entry's (``train_image_large.py``
``build_sampler``): the config's ``diffusion:`` section in fp32 with its
default attention (einsum), the weights loaded by ``load_sampler_params``.
Batch 4, T = 10, labels 0-3; ``x_init`` and the per-step noise come from
``chip_smoke.edm16_draws(SEED)``, and step i + 1 starts from
``mean_i + sigma_i eps_i``.

Stored: ``seed``; ``means`` (T, 4, 3, 16, 16) and ``sigmas`` (T, 4, 1, 1, 1),
each step's mean and (clamped) sigma; ``final``, the last state.
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
                      "edm16_golden.npz")
SEED = 16


def _nhwc(a):
    return jnp.asarray(np.moveaxis(np.asarray(a), -3, -1))


def _nchw(a):
    return np.moveaxis(np.asarray(a), -1, -3)


def build() -> dict:
    """The golden arrays (see the module docstring), computed with JAX on
    the CPU."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from chip_smoke import CONV16_CKPT, CONV16_CONFIG, edm16_draws
    from dxmi_tpu import config as cfglib
    from dxmi_tpu.models.unet_adm import create_unet_adm
    from dxmi_tpu.samplers.edm import EDMSampler, KarrasDenoiser
    from dxmi_tpu.utils import checkpoint as ckptlib

    cfg = cfglib.load_yaml(CONV16_CONFIG)
    dcfg = dict(cfg["diffusion"])
    smin, smax = dcfg.pop("sigma_min"), dcfg.pop("sigma_max")
    dcfg.pop("weight_schedule")
    dist = dcfg.pop("distillation")
    sampler = EDMSampler(create_unet_adm(**dcfg),
                         KarrasDenoiser(sigma_min=smin, sigma_max=smax,
                                        distillation=dist),
                         **cfg["sampler"])
    params = ckptlib.load_sampler_params(
        CONV16_CKPT, current=sampler.init_params(jax.random.key(0)))
    x, eps, y = edm16_draws(SEED)
    y = jnp.asarray(y, jnp.int32)
    step = jax.jit(lambda p, x, t, y: sampler.sample_step(
        p, x, t, jax.random.key(0), y=y))
    means, sigmas = [], []
    for i in range(sampler.n_timesteps):
        out = step(params, _nhwc(x), jnp.full((len(y),), i, jnp.int32), y)
        means.append(_nchw(out["mean"]).astype(np.float32))
        sigmas.append(np.asarray(out["sigma"], np.float32).reshape(-1, 1, 1,
                                                                   1))
        x = means[-1] + sigmas[-1] * eps[i]
    return {"seed": np.int64(SEED), "means": np.stack(means),
            "sigmas": np.stack(sigmas), "final": x.astype(np.float32)}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    arrays = build()
    np.savez(GOLDEN, **arrays)
    print(f"wrote {GOLDEN}: {len(arrays)} arrays, "
          f"{os.path.getsize(GOLDEN)} bytes")
