"""Build ``ddgan_fixture_golden.npz``: the draws behind the trained DDGAN
fixture's committed replay (``tests/fixtures/native_rundir_ddgan_t4/
golden.npz``, the JAX package's ``DDGANSampler.sample`` on
``sampler_best.msgpack`` with ``key(seed)``), which that file does not keep,
and the JAX package's bf16 step means on those weights: the reference that
tests/test_torch_ddgan.py holds the port's NCSN++ and DDGANSampler to at
full width (``generate_cifar10``'s default compute dtype for NCSN++ is bf16).

    python tests/torch_fixtures/make_ddgan_fixture_golden.py   # repo root

The draws replay ``sample``'s key schedule (``ddgan.py:206-238``, ``:133-
151``): x0 from the first split of ``key(seed)``, then per step the z and
the noise of ``split(step_key)``. The script checks that the JAX sampler
with them reproduces golden.npz's trajectory. Stored (NCHW), for the first
``N_KEEP`` of its samples: ``x0``, ``z`` (T, N, nz), ``eps`` (T, N, 3, 32,
32), and ``bf16/means`` (T, N, 3, 32, 32): the bf16 net's step means, each
step from golden.npz's fp32 state (teacher forcing, so the bf16 effect is
read against golden.npz's fp32 means at the same states).
"""
from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "native_rundir_ddgan_t4")
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "ddgan_fixture_golden.npz")
N_KEEP = 4


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(np.asarray(a, np.float32), -1,
                                            -3))


def build():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from dxmi_tpu import config as cfglib
    from dxmi_tpu.utils import checkpoint as ckptlib

    g = np.load(os.path.join(FIXTURE, "golden.npz"))
    cfg = cfglib.load_yaml(os.path.join(FIXTURE, "config.yaml"))
    out = {}
    for name, dtype in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        net = cfglib.instantiate(cfg["sampler_net"], dtype=dtype)
        sampler = cfglib.instantiate(cfg["sampler"], net=net)
        params = ckptlib.load_sampler_params(
            os.path.join(FIXTURE, "sampler_best.msgpack"),
            current=sampler.init_params(jax.random.key(0)))
        n, T, sch = int(g["n"]), sampler.n_timesteps, sampler.schedule
        key, k0 = jax.random.split(jax.random.key(int(g["seed"])))
        x0 = jax.random.normal(k0, (n, *sampler.sample_shape), jnp.float32)
        zs, epss = [], []
        for k in jax.random.split(key, T):
            k_z, k_n = jax.random.split(k)
            zs.append(jax.random.normal(k_z, (n, sampler.nz), jnp.float32))
            epss.append(jax.random.normal(k_n, x0.shape, jnp.float32))
        apply = jax.jit(lambda x, t, z: net.apply({"params": params["net"]},
                                                  x, t, z))
        sig = np.asarray(sampler.sigmas_all(params))
        x, means = x0, []
        for i in range(T):
            t = jnp.full((n,), T - 1 - i, jnp.float32)
            state = x if name == "fp32" else jnp.asarray(g["d_l_sample"][i])
            means.append(sch.x0_coef[i] * apply(state, t, zs[i])
                         + sch.xt_coef[i] * state)
            x = means[-1] + sig[i] * epss[i]
        if name == "fp32":
            np.testing.assert_allclose(np.asarray(x), g["sample"], rtol=2e-4,
                                       atol=2e-4)
            out.update(x0=_nchw(x0[:N_KEEP]),
                       z=np.stack([np.asarray(a[:N_KEEP]) for a in zs]),
                       eps=np.stack([_nchw(a[:N_KEEP]) for a in epss]))
        else:
            out["bf16/means"] = np.stack([_nchw(m[:N_KEEP]) for m in means])
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    arrays = build()
    np.savez(GOLDEN, **arrays)
    print(f"wrote {GOLDEN}: {len(arrays)} arrays, "
          f"{os.path.getsize(GOLDEN)} bytes")
