"""Build ``cifar_bf16_golden.npz``: the JAX package's bf16 sampling of the
trained CIFAR fixture (``tests/fixtures/torch_rundir_t10``), the reference
that ``tests/test_torch_cifar_bf16_golden.py`` and ``chip_smoke.py`` (phase
G-bf16) hold the port's ``generate_cifar10 --dtype bf16`` path to.

    python tests/torch_fixtures/make_cifar_bf16_golden.py   # from the repo root

The net is the JAX entry's ``--dtype bf16`` net (``generate_cifar10.py:
149-156``): the fixture's UNetSmall with ``dtype=bfloat16`` (parameters
fp32) and its other defaults (unfused, einsum attention), GroupNorm
statistics ``fp32``. The trajectory starts from the fixture's own ``x0``
with its ``eps`` (``golden.npz``) and runs its own states.

Stored: ``means`` (T, 8, 3, 16, 16), the bf16 net's step means;
``means_fp32``, the fp32 net's means from the same states (the bf16 effect
that the limits read); ``final``, the last step's sample.
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
                      "cifar_bf16_golden.npz")


def _nhwc(a):
    return jnp.asarray(np.moveaxis(np.asarray(a), -3, -1))


def _nchw(a):
    return np.moveaxis(np.asarray(a), -1, -3)


def build() -> dict:
    """The golden arrays (see the module docstring), computed with JAX on
    the CPU."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from dxmi_tpu import config as cfglib
    from dxmi_tpu.utils import checkpoint as ckptlib

    old = os.environ.get("DXMI_GN_STATS")
    os.environ["DXMI_GN_STATS"] = "fp32"
    try:
        cfg = cfglib.load_yaml(os.path.join(FIXTURE, "config.yaml"))
        golden = np.load(os.path.join(FIXTURE, "golden.npz"))
        ckpt, _ = ckptlib.load_run_checkpoint(FIXTURE, "sampler", "best",
                                              torch_kind="unet_small")
        params = jax.tree.map(jnp.asarray, ckpt["params"])
        steps = {}
        for name, dt in (("bf16", jnp.bfloat16), ("fp32", jnp.float32)):
            net = cfglib.instantiate(cfg["sampler_net"], dtype=dt)
            sampler = cfglib.instantiate(cfg["sampler"], net=net)
            if "log_betas" not in params:
                params = {**sampler.init_params(jax.random.key(0),
                                                params["net"]), **params}
            steps[name] = jax.jit(lambda p, x, t, s=sampler: s.sample_step(
                p, x, t, jax.random.key(0))["mean"])
        x = golden["x0"]
        means, means32 = [], []
        for i in range(len(golden["eps"])):
            t = jnp.full((x.shape[0],), i, jnp.int32)
            means.append(_nchw(steps["bf16"](params, _nhwc(x), t))
                         .astype(np.float32))
            means32.append(_nchw(steps["fp32"](params, _nhwc(x), t))
                           .astype(np.float32))
            x = means[-1] + golden["sigmas"][i] * golden["eps"][i]
    finally:
        if old is None:
            del os.environ["DXMI_GN_STATS"]
        else:
            os.environ["DXMI_GN_STATS"] = old
    return {"means": np.stack(means), "means_fp32": np.stack(means32),
            "final": x.astype(np.float32)}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    arrays = build()
    np.savez(GOLDEN, **arrays)
    print(f"wrote {GOLDEN}: {len(arrays)} arrays, "
          f"{os.path.getsize(GOLDEN)} bytes")
