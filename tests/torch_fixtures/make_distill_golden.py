"""Build ``distill_golden.npz``: the JAX package's distillation losses
(``dxmi_tpu.trainers.distill``), its ``karras_sample`` solvers and one
update of ``scripts/pretrain_ddpm.py``, the reference that
``tests/test_torch_distill.py`` and ``chip_smoke.py`` (phase G10) hold the
port to.

    python tests/torch_fixtures/make_distill_golden.py   # from the repo root

The nets have numpy-made weights (``chip_smoke.numpy_state``): the small
class-conditional UNetADM of ``chip_smoke.DISTILL_SMALL`` (online, target
and teacher each from its own seed, dropout 0.1, fp32), its 64x64 form for
``l2-32``, and pretrain_ddpm's UNetSmall at ``chip_smoke.DDPM_CH``. Each
case draws as the JAX code does from ``jax.random.key(seed)``; the draws
are stored beside the results so the port can replay them:

The inputs that numpy makes (x_start, labels, the training loss's sigmas,
the pretraining batches: ``chip_smoke.distill_inputs`` and ``tanh_batch``
of each case's seed) are not stored.

- ``<case>/`` for each of ``chip_smoke.DISTILL_CASES``: ``key`` (the seed),
  ``noise``, ``indices`` (consistency and progdist), in training mode
  ``dropout/NN`` (the
  online forward's keep masks in call order, ``np.packbits`` of the NCHW
  bool mask; the target's are the same ones) with ``dropout_shape/NN``, and
  ``loss`` (B,);
- ``karras/<case>/`` for each of ``chip_smoke.KARRAS_CASES``: ``key``,
  ``x`` (the initial state), ``noise`` (steps, B, 3, 16, 16: each step's
  churn draw on heun/euler/dpm, injected noise on ancestral/multistep,
  zeros where the solver draws none), ``out`` (the samples), ``move``
  (per element, the larger distance of JAX's samples from ``out`` over
  two runs whose initial standard normal draw is nudged by
  ``chip_smoke.KARRAS_NUDGE`` of itself, numpy seeds 0 and 1: how far
  rounding alone moves each solver, which G10's gate reads);
- ``ddpm/``: ``key``, ``i``, ``eps``, the dropout masks, ``loss``,
  and per parameter (port names) the gradient's norm (``gnorm/``) and the
  first Adam update's (``unorm/``);
- ``ddgan/``: one update of ``scripts/pretrain_ddgan.py`` on the small
  NCSN++ of ``chip_smoke.DDGAN_SMALL``: ``key``, ``ti``, ``eps``,
  ``z``, ``loss`` and the gradient's norm per parameter;
- ``init/<net>/``: per parameter of JAX's ``init_params`` of the three
  samplers at these small widths, its flax path, shape and [std, share of
  zeros, share of ones, max |w|], which the port's flax initialisers are
  held to.
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
                      "distill_golden.npz")


def _nhwc(a):
    return jnp.asarray(np.moveaxis(np.asarray(a), -3, -1))


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3))


def capture_dropout(fn):
    """(fn()'s result, the keep masks (NCHW bool) of every flax Dropout it
    ran in training mode, in call order): each mask drawn from the layer's
    own rng and applied as flax does, so the result is unchanged."""
    import flax.linen as nn

    masks = []

    def interceptor(next_fun, args, kwargs, context):
        if not (isinstance(context.module, nn.Dropout)
                and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        det = kwargs.get("deterministic", context.module.deterministic)
        if det or context.module.rate == 0:
            return next_fun(*args, **kwargs)
        x = args[0]
        keep = jnp.asarray(next_fun(jnp.ones_like(x), *args[1:], **kwargs)) > 0
        masks.append(_nchw(keep))
        return jax.lax.select(keep, x / (1.0 - context.module.rate),
                              jnp.zeros_like(x))

    with nn.intercept_methods(interceptor):
        out = fn()
    return out, masks


def pack_masks(out, prefix, masks):
    for i, m in enumerate(masks):
        out[f"{prefix}dropout/{i:02d}"] = np.packbits(m.ravel())
        out[f"{prefix}dropout_shape/{i:02d}"] = np.asarray(m.shape, np.int32)


def jax_adm(size, **over):
    """(JAX UNetADM at ``size``, {role: params}) of the small nets
    (``over`` overrides chip_smoke.DISTILL_SMALL)."""
    import chip_smoke
    from dxmi_tpu.models.unet_adm import UNetADM
    from dxmi_tpu.utils.convert import convert_unet_adm

    params = {}
    for role in chip_smoke.DISTILL_ROLES:
        state = {k: v.numpy() for k, v in
                 chip_smoke.distill_net(size, role, **over)
                 .state_dict().items()}
        params[role] = jax.tree.map(jnp.asarray,
                                    convert_unet_adm(state)["params"])
    return (UNetADM(**dict(chip_smoke.DISTILL_SMALL, image_size=size,
                           **over)), params)


def jax_distill_loss(name, key, x, y, extra, **over):
    """(JAX's per-sample loss of case ``name``, and the function of the
    online params that gives it) with the draws of ``key``; ``extra``
    holds the case's noise and, for training, its sigmas; ``over``
    overrides the nets' chip_smoke.DISTILL_SMALL."""
    import chip_smoke
    from dxmi_tpu.samplers.edm import KarrasDenoiser
    from dxmi_tpu.trainers import distill

    kind, norm, size, teacher, train = chip_smoke.DISTILL_CASES[name]
    net, params = jax_adm(over.pop("image_size", size), **over)
    diff = KarrasDenoiser(weight_schedule="karras", loss_norm=norm)

    def loss(p):
        if kind == "training":
            return distill.training_losses(diff, net, p, x, extra["sigmas"],
                                           key=key, y=y,
                                           noise=extra["noise"],
                                           train=train)["loss"]
        if kind == "consistency":
            return distill.consistency_losses(
                diff, net, p, params["target"], x,
                chip_smoke.DISTILL_SCALES, key,
                teacher_net=net if teacher else None,
                teacher_params=params["teacher"], y=y, noise=extra["noise"],
                train=train)["loss"]
        return distill.progdist_losses(
            diff, net, p, x, chip_smoke.DISTILL_SCALES, key, teacher_net=net,
            teacher_params=params["teacher"], y=y, noise=extra["noise"],
            train=train)["loss"]

    return loss, params["online"]


def distill_draws(name, seed, size=None):
    """The inputs and JAX draws of case ``name`` (at its image size, or
    ``size``): x (NHWC), y, the key, and the draws the loss function makes
    from it."""
    import chip_smoke

    kind = chip_smoke.DISTILL_CASES[name][0]
    x, y, sigmas = chip_smoke.distill_inputs(name, seed, size)
    B = len(x)
    key = jax.random.key(seed)
    extra = {}
    if kind == "training":
        k_noise, _ = jax.random.split(key)
        extra["sigmas"] = jnp.asarray(sigmas)
    else:
        k_noise, k_idx, _ = jax.random.split(key, 3)
        n = chip_smoke.DISTILL_SCALES - (kind == "consistency")
        extra["indices"] = jax.random.randint(k_idx, (B,), 0, n)
    extra["noise"] = jax.random.normal(k_noise, x.shape, jnp.float32)
    return jnp.asarray(x), jnp.asarray(y, jnp.int32), key, extra


def distill_cases(out):
    import chip_smoke

    for j, name in enumerate(chip_smoke.DISTILL_CASES):
        seed = 100 + j
        x, y, key, extra = distill_draws(name, seed)
        loss, p = jax_distill_loss(name, key, x, y, extra)
        val, masks = capture_dropout(lambda: loss(p))
        train = chip_smoke.DISTILL_CASES[name][4]
        if train and chip_smoke.DISTILL_CASES[name][0] == "consistency":
            half = len(masks) // 2  # the target's: the online ones again
            assert all((a == b).all() for a, b in zip(masks[:half],
                                                      masks[half:]))
            masks = masks[:half]
        assert bool(masks) == train
        pre = f"{name}/"
        out[pre + "key"] = np.int64(seed)
        out[pre + "noise"] = _nchw(extra["noise"])
        if "indices" in extra:
            out[pre + "indices"] = np.asarray(extra["indices"])
        pack_masks(out, pre, masks)
        out[pre + "loss"] = np.asarray(val, np.float32)
        print(name, out[pre + "loss"])


def nudged_first_normal(fn, seed):
    """``fn()`` with the first ``jax.random.normal`` draw it makes (the
    solvers' initial state) multiplied by 1 + N(0, 1) * KARRAS_NUDGE from
    ``np.random.RandomState(seed)``; unchanged when ``seed`` is None."""
    import chip_smoke
    if seed is None:
        return fn()
    normal, calls = jax.random.normal, []

    def nudged(key, shape, *args, **kwargs):
        z = normal(key, shape, *args, **kwargs)
        calls.append(1)
        if len(calls) > 1:
            return z
        rs = np.random.RandomState(seed)
        return jnp.asarray((np.asarray(z) * (1 + rs.randn(*z.shape)
                                             * chip_smoke.KARRAS_NUDGE))
                           .astype(np.float32))

    jax.random.normal = nudged
    try:
        return fn()
    finally:
        jax.random.normal = normal


def karras_cases(out):
    import chip_smoke
    from dxmi_tpu.samplers.edm import KarrasDenoiser, karras_sample

    net, params = jax_adm(16)
    diff = KarrasDenoiser(weight_schedule="karras")
    steps, B = chip_smoke.KARRAS_STEPS, chip_smoke.KARRAS_BATCH
    shape = (B, 16, 16, 3)
    for j, (name, opts) in enumerate(chip_smoke.KARRAS_CASES.items()):
        seed = 200 + j
        sampler = "heun" if name == "heun_churn" else name
        y = jnp.asarray(np.random.RandomState(seed).randint(
            0, chip_smoke.DISTILL_SMALL["num_classes"], B), jnp.int32)
        key = jax.random.key(seed)
        rest, k0 = jax.random.split(key)
        x = jax.random.normal(k0, shape) * 80.0
        noise = np.zeros((steps, B, 3, 16, 16), np.float32)
        if sampler in ("heun", "euler", "dpm"):
            _, kc = jax.random.split(rest)
            keys = jax.random.split(kc, steps)
        else:
            keys = jax.random.split(rest, steps)
        if sampler in ("ancestral", "multistep") or opts:
            noise = np.stack([_nchw(jax.random.normal(k, shape))
                              for k in keys])
        def run(nudge_seed=None):
            return _nchw(nudged_first_normal(
                lambda: karras_sample(diff, net, params["online"], key,
                                      shape, steps, sampler,
                                      model_kwargs={"y": y}, **opts),
                nudge_seed)).astype(np.float32)

        got = run()
        pre = f"karras/{name}/"
        out[pre + "key"] = np.int64(seed)
        out[pre + "x"], out[pre + "noise"] = _nchw(x), noise
        out[pre + "out"] = got
        out[pre + "move"] = np.maximum(*(np.abs(run(s) - got)
                                         for s in (0, 1)))
        print(name, float(np.abs(out[pre + "out"]).mean()))


def ddpm_update(out):
    import optax

    import chip_smoke
    from dxmi_tpu.models.unet_small import UNetSmall
    from dxmi_tpu.samplers.var import VARSampler
    from dxmi_tpu.utils.convert import convert_unet_small
    from dxmi_tpu_torch.utils.convert import unet_small_from_flax

    T, B = chip_smoke.DDPM_T, chip_smoke.DDPM_BATCH
    net = UNetSmall(ch=chip_smoke.DDPM_CH, out_ch=3, ch_mult=(1, 2, 2, 2),
                    num_res_blocks=2, attn_resolutions=(16,), dropout=0.1,
                    in_channels=3, resolution=32)
    sch = VARSampler(net, n_timesteps=T, sample_shape=(3, 32, 32),
                     trainable_beta="fix_last").schedule
    state = {k: v.numpy() for k, v in
             chip_smoke.ddpm_small("cpu").net.state_dict().items()}
    params = jax.tree.map(jnp.asarray, convert_unet_small(state)["params"])
    seed = 300
    x0 = jnp.asarray(chip_smoke.tanh_batch(seed, B, 32))
    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    i = jax.random.randint(k1, (B,), 0, T)
    gbar = jnp.take(sch.gamma_bar, T - 1 - i)[:, None, None, None]
    eps = jax.random.normal(k2, x0.shape)
    x_t = jnp.sqrt(gbar) * x0 + jnp.sqrt(1 - gbar) * eps
    tau = jnp.take(sch.tau, i)

    def loss_fn(p):
        pred = net.apply({"params": p}, x_t, tau, deterministic=False,
                         rngs={"dropout": k3})
        return ((pred - eps) ** 2).mean()

    _, masks = capture_dropout(lambda: loss_fn(params))
    loss, g = jax.value_and_grad(loss_fn)(params)
    opt = optax.adam(chip_smoke.DDPM_LR)
    up, _ = opt.update(g, opt.init(params), params)
    pre = "ddpm/"
    out[pre + "key"] = np.int64(seed)
    out[pre + "eps"] = _nchw(eps)
    out[pre + "i"] = np.asarray(i, np.int64)
    pack_masks(out, pre, masks)
    out[pre + "loss"] = np.float32(loss)
    for tag, tree in (("gnorm/", g), ("unorm/", up)):
        sd = unet_small_from_flax(jax.tree.map(np.asarray, tree))
        for k, v in sd.items():
            out[pre + tag + k] = np.float64(np.linalg.norm(v.numpy()))
    print("ddpm", float(loss), len(masks), "masks")


def ddgan_update(out):
    """One update of scripts/pretrain_ddgan.py on the small NCSN++
    (chip_smoke.DDGAN_SMALL, 16x16, numpy-made weights)."""
    import chip_smoke
    from dxmi_tpu.models.ncsnpp import NCSNpp, NCSNppArgs
    from dxmi_tpu.samplers.ddgan import _vp_variance
    from dxmi_tpu_torch.utils.convert import ncsnpp_from_flax
    from dxmi_tpu_torch.utils.train_state import flax_tree

    T, B = chip_smoke.DDGAN_T, chip_smoke.DISTILL_BATCH
    cfg = NCSNppArgs(**chip_smoke.DDGAN_SMALL)
    net = NCSNpp(config=cfg)
    port = chip_smoke.NCSNpp(chip_smoke.NCSNppArgs(**chip_smoke.DDGAN_SMALL))
    port.load_state_dict(chip_smoke.ddgan_small_state())
    params = jax.tree.map(jnp.asarray, flax_tree(port))
    t_grid = np.arange(0, T + 1, dtype=np.float64) / T
    t_grid = t_grid * (1.0 - 1e-3) + 1e-3
    edges = 1.0 - _vp_variance(t_grid)
    a_bar = jnp.asarray(np.cumprod(1.0 - (1.0 - edges[1:] / edges[:-1])),
                        jnp.float32)
    seed = 400
    x0 = jnp.asarray(chip_smoke.tanh_batch(seed, B, cfg.image_size))
    k_t, k_eps, k_z = jax.random.split(jax.random.key(seed), 3)
    ti = jax.random.randint(k_t, (B,), 0, T)
    ab = jnp.take(a_bar, ti)[:, None, None, None]
    eps = jax.random.normal(k_eps, x0.shape)
    x_t = jnp.sqrt(ab) * x0 + jnp.sqrt(1.0 - ab) * eps
    z = jax.random.normal(k_z, (B, cfg.nz))

    def loss_fn(p):
        x0_hat = net.apply({"params": p}, x_t, ti.astype(jnp.float32), z)
        return ((x0_hat - x0) ** 2).mean()

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(params)
    pre = "ddgan/"
    out[pre + "key"] = np.int64(seed)
    out[pre + "eps"] = _nchw(eps)
    out[pre + "ti"], out[pre + "z"] = np.asarray(ti, np.int64), np.asarray(z)
    out[pre + "loss"] = np.float32(loss)
    for k, v in ncsnpp_from_flax(jax.tree.map(np.asarray, g)).items():
        out[pre + "gnorm/" + k] = np.float64(np.linalg.norm(v.numpy()))
    print("ddgan", float(loss))


def init_stats(out):
    """Per parameter of JAX's ``init_params`` of the three samplers at the
    goldens' small widths (pretrain_ddpm's UNetSmall at DDPM_CH, the
    DISTILL_SMALL ADM, the DDGAN_SMALL NCSN++): its flax path, shape
    (padded with -1), and [std, share of exact zeros, share of exact ones,
    max |w|]."""
    import chip_smoke
    from dxmi_tpu.models.ncsnpp import NCSNpp, NCSNppArgs
    from dxmi_tpu.models.unet_adm import UNetADM
    from dxmi_tpu.models.unet_small import UNetSmall
    from dxmi_tpu.samplers.ddgan import DDGANSampler
    from dxmi_tpu.samplers.edm import EDMSampler
    from dxmi_tpu.samplers.var import VARSampler

    samplers = {
        "unet_small": VARSampler(
            UNetSmall(ch=chip_smoke.DDPM_CH, out_ch=3, ch_mult=(1, 2, 2, 2),
                      num_res_blocks=2, attn_resolutions=(16,), dropout=0.1,
                      in_channels=3, resolution=32), n_timesteps=10,
            sample_shape=(3, 32, 32), trainable_beta="fix_last"),
        "unet_adm": EDMSampler(UNetADM(**chip_smoke.DISTILL_SMALL), None, 10,
                               (3, 16, 16), class_cond=True, num_classes=4,
                               trainable_beta="fix_last"),
        "ncsnpp": DDGANSampler(NCSNpp(config=NCSNppArgs(
            **chip_smoke.DDGAN_SMALL)), n_timesteps=4,
            sample_shape=(3, 16, 16), trainable_beta="fix_last", use_z=True),
    }
    for kind, sampler in samplers.items():
        params = sampler.init_params(jax.random.key(500))
        leaves = jax.tree_util.tree_leaves_with_path(params)
        paths, shapes, stats = [], [], []
        for path, leaf in leaves:
            a = np.asarray(leaf, np.float64)
            paths.append("/".join(k.key for k in path))
            shapes.append(list(a.shape) + [-1] * (4 - a.ndim))
            stats.append([a.std(), (a == 0).mean(), (a == 1).mean(),
                          np.abs(a).max()])
        out[f"init/{kind}/paths"] = np.asarray(paths)
        out[f"init/{kind}/shapes"] = np.asarray(shapes, np.int32)
        out[f"init/{kind}/stats"] = np.asarray(stats)
        print("init", kind, len(paths), "leaves")


def build():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    out = {}
    distill_cases(out)
    karras_cases(out)
    ddpm_update(out)
    ddgan_update(out)
    init_stats(out)
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    arrays = build()
    np.savez_compressed(GOLDEN, **arrays)
    print(f"wrote {GOLDEN}: {os.path.getsize(GOLDEN)} bytes")
