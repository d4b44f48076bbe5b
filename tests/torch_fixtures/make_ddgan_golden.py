"""Build ``ddgan_golden.npz``: the JAX package's DDGAN step (``dxmi_tpu.
samplers.ddgan``, ``dxmi_tpu.models.ncsnpp``) on the small NCSN++ of
``chip_smoke.DDGAN_SMALL`` with the numpy-made weights of
``chip_smoke.ddgan_small_state`` (conv2 and proj_out non-zero), T = 4, batch
4, with the injected draws of ``chip_smoke.ddgan_draws``: the reference
that tests/test_torch_ddgan.py and chip_smoke.py (phase G6) hold the port's
NCSN++ and DDGANSampler to.

    python tests/torch_fixtures/make_ddgan_golden.py   # from the repo root

Stored (NCHW; the draws are not stored, both sides rebuild them from
``seed``, the calibration draws from ``seed + 1`` with two rounds):
``sigmas`` (T,) and
- ``fp32/l_sample``, ``fp32/means``: the fp32 trajectory;
- ``bf16/l_sample``, ``bf16/means``: the bf16 net's own trajectory, and
  ``bf16/means_fp32``: the fp32 net's step means at those states;
- ``int8/scale/<port buffer>``: the bf16 net with static int8 and
  ``quant_skip_attn`` (``generate_cifar10 --int8``'s NCSN++), calibrated by
  JAX from zero scales on the calibration draws; ``int8/l_sample``,
  ``int8/means``: its trajectory with those scales; ``int8/means_fp``: the
  bf16 net without int8 and ``int8/means_fp32`` the fp32 net with int8
  and the same scales at those states;
- ``calib32/scale/<port buffer>``: the fp32 net with static int8 on every
  conv and attention 1x1, calibrated from zero on the same draws;
  ``int832/l_sample``, ``int832/means``: its trajectory with those scales,
  ``int832/means_fp``: the fp32 net without int8 at those states; and
  ``calib32/init/<port buffer>``: the scales JAX's ``calibrate_quant``
  starts its maxima from instead (``net.init`` with the entry's key
  ``fold_in(key(0 + 123), 999)``).
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
                      "ddgan_golden.npz")


def _nhwc(a):
    return jnp.asarray(np.moveaxis(np.asarray(a), -3, -1))


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(np.asarray(a, np.float32), -1,
                                            -3))


def ncsnpp_to_flax(state):
    """The port's NCSN++ state dict (torch tensors) as flax params: Linear
    weights transposed, OIHW to HWIO, a 1-D weight (GroupNorm) to
    ``scale``."""
    tree = {}
    for key, val in state.items():
        *mods, leaf = key.split(".")
        v = val.numpy()
        if leaf == "weight" and v.ndim == 4:
            name, v = "kernel", v.transpose(2, 3, 1, 0)
        elif leaf == "weight" and v.ndim == 2:
            name, v = "kernel", v.T
        else:
            name = "scale" if leaf == "weight" else "bias"
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = jnp.asarray(np.ascontiguousarray(v))
    return tree


class Small:
    """The JAX side: the small NCSN++ with the golden's weights, its DDGAN
    schedule and initial sigmas."""

    def __init__(self):
        if REPO not in sys.path:
            sys.path.insert(0, REPO)
        import chip_smoke
        from dxmi_tpu.models.ncsnpp import NCSNpp, NCSNppArgs
        from dxmi_tpu.samplers.ddgan import DDGANSampler

        self.cs = chip_smoke
        self.args = NCSNppArgs(**chip_smoke.DDGAN_SMALL)
        self.NCSNpp = NCSNpp
        self.params = ncsnpp_to_flax(chip_smoke.ddgan_small_state())
        self.sampler = DDGANSampler(NCSNpp(config=self.args),
                                    chip_smoke.DDGAN_T, (3, 16, 16))
        sch = self.sampler.schedule
        self.sigmas = np.asarray(self.sampler.sigmas_all(
            {"log_betas": jnp.log(sch.init_sigma)}))
        self.c1, self.c2 = np.asarray(sch.x0_coef), np.asarray(sch.xt_coef)
        self.T = chip_smoke.DDGAN_T

    def net(self, dtype=jnp.float32, **kw):
        return self.NCSNpp(config=self.args, dtype=dtype, **kw)

    def mean(self, net, x, i, z, scales=None, mutable=False):
        """One step's mean c1 G(x, T-1-i, z) + c2 x (NHWC); with
        ``mutable`` (calibration) also the updated scales."""
        t = jnp.full((x.shape[0],), self.T - 1 - i, jnp.float32)
        variables = {"params": self.params}
        if scales is not None:
            variables["quant_scales"] = scales
        if mutable:
            x0p, upd = net.apply(variables, x, t, z,
                                 mutable=["quant_scales"])
            return self.c1[i] * x0p + self.c2[i] * x, upd["quant_scales"]
        x0p = net.apply(variables, x, t, z)
        return self.c1[i] * x0p + self.c2[i] * x

    def trajectory(self, net, x0, z, eps, scales=None, other=None):
        """(l_sample, means[, other's means at the same states]) NHWC."""
        xs, means, others = [x0], [], []
        for i in range(self.T):
            m = self.mean(net, xs[-1], i, z[i], scales)
            if other is not None:
                others.append(self.mean(other, xs[-1], i, z[i]))
            means.append(m)
            xs.append(m + self.sigmas[i] * eps[i])
        out = [jnp.stack(xs), jnp.stack(means)]
        return out + ([jnp.stack(others)] if other is not None else [])

    def calibrate(self, net, x0, z, eps):
        """JAX's calibration loop (``ddgan.py:166-204``) from zero scales on
        injected draws (rounds leading)."""
        shapes = jax.eval_shape(net.init, jax.random.key(0), x0[0],
                                jnp.zeros((x0.shape[1],)), z[0, 0])
        scales = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                              shapes["quant_scales"])
        for r in range(x0.shape[0]):
            x = x0[r]
            for i in range(self.T):
                m, scales = self.mean(net, x, i, z[r, i], scales,
                                      mutable=True)
                x = m + self.sigmas[i] * eps[r, i]
        return scales

    def init_scales(self, net):
        return net.init(jax.random.fold_in(jax.random.key(123), 999),
                        jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)),
                        jnp.zeros((1, self.args.nz)))["quant_scales"]

    def draws(self, seed, rounds=None):
        x0, z, eps = self.cs.ddgan_draws(seed, rounds=rounds)
        return _nhwc(x0), jnp.asarray(z), _nhwc(eps)


def port_scales(scales):
    from dxmi_tpu_torch.utils.convert import ncsnpp_quant_scales_from_flax

    return {k: v.numpy() for k, v in ncsnpp_quant_scales_from_flax(
        jax.tree.map(np.asarray, scales)).items()}


def build():
    small = Small()
    seed = small.cs.DDGAN_SEED
    x0, z, eps = small.draws(seed)
    cx0, cz, ceps = small.draws(seed + 1, rounds=2)
    out = {"seed": np.int64(seed), "sigmas": small.sigmas}
    l_sample, means = small.trajectory(small.net(), x0, z, eps)
    out.update({"fp32/l_sample": _nchw(l_sample), "fp32/means": _nchw(means)})
    l_sample, means, means32 = small.trajectory(
        small.net(jnp.bfloat16), x0, z, eps, other=small.net())
    out.update({"bf16/l_sample": _nchw(l_sample), "bf16/means": _nchw(means),
                "bf16/means_fp32": _nchw(means32)})
    net8 = small.net(jnp.bfloat16, quant_int8="static", quant_skip_attn=True)
    scales = small.calibrate(net8, cx0, cz, ceps)
    l_sample, means, means_fp = small.trajectory(
        net8, x0, z, eps, scales, other=small.net(jnp.bfloat16))
    means32 = jnp.stack([small.mean(
        small.net(quant_int8="static", quant_skip_attn=True), l_sample[i],
        i, z[i], scales) for i in range(small.T)])
    out.update({"int8/l_sample": _nchw(l_sample), "int8/means": _nchw(means),
                "int8/means_fp": _nchw(means_fp),
                "int8/means_fp32": _nchw(means32)})
    out.update({f"int8/scale/{k}": v for k, v in port_scales(scales).items()})
    net32 = small.net(quant_int8="static")
    scales = small.calibrate(net32, cx0, cz, ceps)
    out.update({f"calib32/scale/{k}": v for k, v in port_scales(
        scales).items()})
    l_sample, means, means_fp = small.trajectory(
        net32, x0, z, eps, scales, other=small.net())
    out.update({"int832/l_sample": _nchw(l_sample),
                "int832/means": _nchw(means),
                "int832/means_fp": _nchw(means_fp)})
    out.update({f"calib32/init/{k}": v for k, v in port_scales(
        small.init_scales(net32)).items()})
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    arrays = build()
    np.savez(GOLDEN, **arrays)
    print(f"wrote {GOLDEN}: {len(arrays)} arrays, "
          f"{os.path.getsize(GOLDEN)} bytes")
