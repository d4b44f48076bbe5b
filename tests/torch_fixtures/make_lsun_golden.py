"""Build ``lsun_golden.npz`` and ``lsun_int8_golden.npz``: the JAX package's
EDMSampler (configs/lsun/T4.yaml's sampler: T=4, stochastic_last, rho 4)
over a small UNetADM of LSUN's structure (``chip_smoke.LSUN_SMALL``: six
levels, resblock_updown, no scale-shift, unconditional, attention at three
maps by num_head_channels) with numpy-made weights
(``chip_smoke.lsun_small_state``), the reference that
``tests/test_torch_lsun.py`` and ``chip_smoke.py`` (phase G8) hold the port
to.

    python tests/torch_fixtures/make_lsun_golden.py   # from the repo root

Draws come from ``chip_smoke.lsun_draws(SEED)``; step i + 1 starts from the
fp32 trajectory's ``mean_i + sigma_i eps_i``, and every path restarts each
step from those states, so each path's step means compare on the same
inputs. The paths (``chip_smoke.LSUN_SMALL_PATHS``): fp32 (einsum attention,
fp32 GroupNorm statistics, resize upsampling); bf16 as the generation entry
runs it (bf16 softmax, the fused attention block forced into its Pallas
kernel in interpret mode, phase upsampling, bf16_onepass statistics); and
fp32 static int8 (the fused int8 attention block forced the same way),
calibrated from zero scales on two rounds of T steps at the golden's batch
with draws from ``lsun_draws(CALIB_SEED, rounds=2)``, as the ADM fixture's
int8 golden.

Stored in ``lsun_golden.npz``: ``seed``; ``sigmas`` (T, B, 1, 1, 1);
``fp32/means`` and ``bf16/means`` (T, B, 3, 64, 64). In
``lsun_int8_golden.npz``: ``calib_seed``; ``int8/means``; ``scale/<port
buffer name>`` for every calibrated scale.
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
CALIB_SEED = 2026
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


def flax_params():
    """The small net's numpy-made weights as the JAX net's params tree."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    from dxmi_tpu.utils.convert import convert_unet_adm

    state = {k: v.numpy() for k, v in chip_smoke.lsun_small_state().items()}
    return jax.tree.map(jnp.asarray, convert_unet_adm(state)["params"])


def jax_sampler(**net_kw):
    """The JAX EDMSampler over the small net with ``net_kw``."""
    import chip_smoke
    from dxmi_tpu.models.unet_adm import UNetADM
    from dxmi_tpu.samplers.edm import EDMSampler, KarrasDenoiser

    net = UNetADM(**chip_smoke.LSUN_SMALL, **net_kw)
    return EDMSampler(net, KarrasDenoiser(sigma_min=0.002, sigma_max=80.0),
                      **chip_smoke.lsun_small_sampler_cfg()), net


def step_means(sampler, params, states):
    """The step mean of each state (numpy NCHW), step t from states[t]."""
    step = jax.jit(lambda p, x, t: sampler.sample_step(
        p, x, t, jax.random.key(0))["mean"])
    B = states[0].shape[0]
    return np.stack([_nchw(step(params, _nhwc(x),
                                jnp.full((B,), t, jnp.int32))).astype(
        np.float32) for t, x in enumerate(states)])


def calibrate(sampler, net, params, x0, eps):
    """JAX's calibrate_quant with injected draws, from zero scales; returns
    the quant_scales tree."""
    size = sampler.sample_shape[0]
    shapes = jax.eval_shape(net.init, jax.random.key(0),
                            jnp.zeros((1, size, size, 3)),
                            jnp.zeros((1,)))["quant_scales"]
    scales = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    sch = sampler.schedule
    sig_up = sampler.sigmas_up_all(params)

    @jax.jit
    def calib_step(net_params, scales, x, t, noise):
        sigma = jnp.take(sch.sigmas, t)
        _, denoised, upd = sampler.diffusion.denoise(
            net, net_params, x, sigma, extra_vars={"quant_scales": scales},
            mutable=["quant_scales"])
        d = (x - denoised) / sigma[:, None, None, None]
        dt = (jnp.take(sch.sigma_down, t) - sigma)[:, None, None, None]
        return (x + d * dt + noise * jnp.take(sig_up, t)[:, None, None, None],
                upd["quant_scales"])

    n = x0.shape[1]
    for r in range(x0.shape[0]):
        x = _nhwc(x0[r])
        for i in range(sampler.n_timesteps):
            x, scales = calib_step(params["net"], scales, x,
                                   jnp.full((n,), i, jnp.int32),
                                   _nhwc(eps[r, i]))
    return scales


def build(teacher: dict | None = None):
    """(lsun_golden arrays, lsun_int8_golden arrays), computed with JAX on
    the CPU. With ``teacher`` (the committed lsun_golden arrays) the bf16
    and int8 steps start from the teacher's fp32 states instead of this
    build's own (on the host that wrote the golden the two are the same)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    from dxmi_tpu_torch.utils.convert import adm_quant_scales_from_flax

    net_params = flax_params()
    x0, eps = chip_smoke.lsun_draws(chip_smoke.LSUN_SEED)
    sampler, _ = jax_sampler()
    params = {"net": net_params,
              "log_betas": sampler.init_params(jax.random.key(0))[
                  "log_betas"]}
    step = jax.jit(lambda p, x, t: sampler.sample_step(
        p, x, t, jax.random.key(0)))
    B = x0.shape[0]
    x, means, sigmas = x0, [], []
    for t in range(sampler.n_timesteps):
        out = step(params, _nhwc(x), jnp.full((B,), t, jnp.int32))
        means.append(_nchw(out["mean"]).astype(np.float32))
        sigmas.append(np.asarray(out["sigma"], np.float32).reshape(-1, 1, 1,
                                                                   1))
        x = means[-1] + sigmas[-1] * eps[t]
    gold = {"seed": np.int64(chip_smoke.LSUN_SEED),
            "sigmas": np.stack(sigmas), "fp32/means": np.stack(means)}
    states = chip_smoke.lsun_states(teacher or gold, eps)
    with _env(ENV):
        s16, _ = jax_sampler(dtype=jnp.bfloat16, softmax_f32=False,
                             attn_impl="fused", up_impl="phase")
        gold["bf16/means"] = step_means(s16, params, states)
        s8, net8 = jax_sampler(attn_impl="fused", up_impl="phase",
                               quant_int8="static", quant_attn="static")
        cx0, ceps = chip_smoke.lsun_draws(CALIB_SEED, rounds=2)
        scales = calibrate(s8, net8, params, cx0, ceps)
        int8 = {"calib_seed": np.int64(CALIB_SEED),
                "int8/means": step_means(s8, dict(params,
                                                  quant_scales=scales),
                                         states)}
    for k, v in adm_quant_scales_from_flax(
            jax.tree.map(np.asarray, scales)).items():
        int8[f"scale/{k}"] = v.numpy()
    return gold, int8


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    import chip_smoke

    gold, int8 = build()
    for path, arrays in ((chip_smoke.LSUN_GOLDEN, gold),
                         (chip_smoke.LSUN_INT8_GOLDEN, int8)):
        np.savez(path, **arrays)
        print(f"wrote {path}: {len(arrays)} arrays, "
              f"{os.path.getsize(path)} bytes")
