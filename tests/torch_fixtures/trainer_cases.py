"""Small trainer configurations built in both packages from one seed, the
JAX trainer's iterations with its key schedule, and the replay of that key
schedule's draws into the port (NCHW), for the CPU tests of train-state
resume, the trainer's options and value-guided sampling.

Cases (``CASES``), each the trainer section of a repo config at a small
width, dropout 0 and T = 4:
- ``cifar``: ``configs/cifar10/T10.yaml`` (UNetSmall + VARSampler, IGEBM
  value; ``DxMITrainer``: Adam with the 0.1 global-norm clip, adavelreg,
  reversed betas);
- ``cond``: ``configs/imagenet64/conv16.yaml`` (class-conditional UNetADM
  + EDMSampler, IGEBM value; ``DxMITrainerCond``: RAdam, ``nan_guard``,
  forward betas, the value's gradient clip, the full-buffer sweep);
- ``f``: ``cifar`` with a separate energy net (an IGEBM encoder).

The JAX trainer's draws, replayed from its keys (``dxmi.py:343-666``):
``update_f_v``'s optional ``aug`` key, then (k_steps, k_order); the
shuffle permutation of k_order; the random order of fold_in(k_order, rep);
each sweep step's keys split(fold_in(k_steps, rep), T)[i] -> (ks, kd, ka1,
ka2), the resampled step's noise normal(ks); ``update_sampler``'s
permutation of split(key)[1] and each minibatch's (k_step, k_drop) ->
noise normal(k_step), the ``aug`` draw from k_drop.
"""
from __future__ import annotations

import os
import sys
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

T, B, SEED = 4, 4, 5
LRS = dict(lr=1e-5, v_lr=1e-5, beta_lr=1e-5)
F_LR = 1e-5
CIFAR_NET = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1,
                 attn_resolutions=[8], dropout=0.0, resolution=16)
CASES = ("cifar", "cond", "f")
AUG_SCALE = 0.1


def run_files(run_dir) -> List[str]:
    """The files of a training run directory, sorted, without the
    TensorBoard event files (written only where tensorboardX is
    installed, as the JAX entries write them)."""
    return sorted(n for n in os.listdir(run_dir)
                  if not n.startswith("events.out.tfevents."))


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a), -1, -3)))


def nhwc(a) -> jnp.ndarray:
    return jnp.asarray(np.moveaxis(np.asarray(a), -3, -1))


def jax_aug(x, key):
    """An augmentation that reads its key: each sample scaled by 1 + 0.1 n,
    n ~ N(0, 1) from the key."""
    n = jax.random.normal(key, (x.shape[0],) + (1,) * (x.ndim - 1))
    return x * (1 + AUG_SCALE * n)


def port_aug(x, draw):
    """``jax_aug`` with its normal draw injected (B,)."""
    return x * (1 + AUG_SCALE * draw.to(x.device).reshape(
        (-1,) + (1,) * (x.dim() - 1)))


def aug_draw(key, n) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jax.random.normal(
        key, (n, 1, 1, 1)))).reshape(n)


def _configs(case: str):
    from dxmi_tpu import config as cfglib

    if case == "cond":
        cfg = cfglib.load_yaml(os.path.join(REPO, "configs", "imagenet64",
                                            "conv16.yaml"))
        cfg["sampler"]["n_timesteps"] = T
        cfg["trainer"]["n_timesteps"] = T
        cfg["value"]["net"]["nh"] = 8
        return cfg
    cfg = cfglib.load_yaml(os.path.join(REPO, "configs", "cifar10",
                                        "T10.yaml"))
    cfg["sampler_net"].update(CIFAR_NET)
    cfg["sampler"].update(n_timesteps=T, sample_shape=[3, 16, 16])
    cfg["value"]["net"]["nh"] = 8
    return cfg


def seeded_params(module, args, rs: np.random.RandomState):
    """Parameters of a flax ``module`` in its tree (from ``jax.eval_shape``,
    nothing compiled) drawn from ``rs``: kernels N(0, 1/fan_in), embeddings
    N(0, 1), norm scales 1 + N(0, 0.1^2), biases N(0, 0.05^2)."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args),
                            jax.random.key(0))["params"]

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            a = rs.randn(*shape) / np.sqrt(max(np.prod(shape[:-1]), 1))
        elif name == "embedding":
            a = rs.randn(*shape)
        elif name == "scale":
            a = 1 + 0.1 * rs.randn(*shape)
        else:
            a = 0.05 * rs.randn(*shape)
        return jnp.asarray(a, leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


class JaxCase:
    """The JAX sampler, value, trainer and initial state of ``case``;
    ``trainer_kw`` override the config's trainer section."""

    def __init__(self, case: str, **trainer_kw):
        from dxmi_tpu import config as cfglib
        from dxmi_tpu.models.igebm import IGEBMEncoder

        self.case, self.cfg = case, _configs(case)
        cfg = self.cfg
        tcfg = {k: v for k, v in cfg["trainer"].items() if k != "_target_"}
        tcfg.update(trainer_kw, batchsize=B, n_timesteps=T)
        if case == "cond":
            from dxmi_tpu.models.unet_adm import create_unet_adm
            from dxmi_tpu.samplers.edm import EDMSampler, KarrasDenoiser
            from dxmi_tpu.trainers.dxmi_cond import DxMITrainerCond

            d = dict(cfg["diffusion"])
            smin, smax = d.pop("sigma_min"), d.pop("sigma_max")
            d.pop("weight_schedule")
            dist = d.pop("distillation")
            self.sampler = EDMSampler(create_unet_adm(**d), KarrasDenoiser(
                sigma_min=smin, sigma_max=smax, distillation=dist),
                **cfg["sampler"])
            self.trainer = DxMITrainerCond(**tcfg)
        else:
            from dxmi_tpu.trainers.dxmi import DxMITrainer

            net = cfglib.instantiate(cfg["sampler_net"])
            self.sampler = cfglib.instantiate(cfg["sampler"], net=net)
            self.trainer = DxMITrainer(**tcfg)
        self.value = cfglib.instantiate(cfg["value"])
        self.energy = (IGEBMEncoder(nh=8, keepdim=False) if case == "f"
                       else None)
        self.trainer.set_models(self.sampler, self.value, **LRS,
                                energy=self.energy,
                                f_lr=F_LR if case == "f" else None)
        rs = np.random.RandomState(SEED)
        key = jax.random.key(SEED)
        x = jnp.zeros((1, *self.sampler.sample_shape))
        t = jnp.zeros((1,), jnp.float32)
        y = jnp.zeros((1,), jnp.int32)
        net_args = (x, t, y) if case == "cond" else (x, t)
        sp = self.sampler.init_params(key, net_params=seeded_params(
            self.sampler.net, net_args, rs))
        vp = seeded_params(self.value, (x, y), rs)
        fp = (seeded_params(self.energy, (x,), rs)
              if self.energy is not None else None)
        self.state = self.trainer.init_state(sp, vp, f_params=fp)
        self.res = self.sampler.sample_shape[0]
        self._sample = None

    @property
    def cond(self) -> bool:
        return self.case == "cond"

    def batch(self, it: int):
        """The data batch (NHWC in [-1, 1]) and labels of iteration ``it``."""
        from dxmi_tpu.data.synthetic import structured_class_images

        img, y = structured_class_images(B, self.res, 4, seed=SEED + it)
        return (jnp.asarray(img), jnp.asarray(y) if self.cond else None)

    def keys(self, it: int):
        """(sampling, update_f_v, update_sampler) keys of iteration ``it``."""
        return jax.random.split(jax.random.fold_in(jax.random.key(SEED), it),
                                3)

    def trajectory(self, state, it: int):
        from dxmi_tpu.trainers import buffer as buflib

        sk, _, _ = self.keys(it)
        if self._sample is None:
            self._sample = jax.jit(
                (lambda p, k, y: self.sampler.sample(p, k, B, i_class=y))
                if self.cond else
                (lambda p, k, y: self.sampler.sample(p, k, B)))
        d = self._sample(state.sampler_params, sk, self.batch(it)[1])
        return d, buflib.from_d_sample(d)

    def iteration(self, state, it: int, n_generator=None):
        """One JAX iteration ``it``: trajectory, update_f_v, update_sampler.
        Returns (state, metrics, the trajectory dict)."""
        img, y = self.batch(it)
        _, uk, gk = self.keys(it)
        d, traj = self.trajectory(state, it)
        state, m1 = self.trainer.update_f_v(state, img, traj, uk, y=y)
        kw = {} if n_generator is None and self.cond else {
            "n_generator": 1 if n_generator is None else n_generator}
        state, m2 = self.trainer.update_sampler(state, traj, gk, **kw)
        return state, {**m1, **m2}, d

    # ---- the draws, replayed for the port ---------------------------------

    def f_v_draws(self, key, aug: bool = False,
                  reps: int = 1) -> Dict[str, Any]:
        """update_f_v's draws from ``key`` over ``reps`` repeats: ``perm``,
        ``order``, ``resample`` and ``aug_draws`` as the port's
        ``update_f_v`` takes them."""
        aug_draws: List[torch.Tensor] = []
        if aug:
            key, akey = jax.random.split(key)
            aug_draws.append(aug_draw(akey, 2 * B))
        key, k_steps, k_order = jax.random.split(key, 3)
        out: Dict[str, Any] = {
            "perm": torch.from_numpy(np.asarray(
                jax.random.permutation(k_order, T * B))).long(),
            "order": [torch.from_numpy(np.asarray(jax.random.permutation(
                jax.random.fold_in(k_order, rep), T))).long()
                for rep in range(reps)]}
        resample = []
        for rep in range(reps):
            for k in jax.random.split(jax.random.fold_in(k_steps, rep), T):
                ks, _, ka1, ka2 = jax.random.split(k, 4)
                resample.append({"noise": nchw(jax.random.normal(
                    ks, (B, self.res, self.res, 3)))})
                if aug:
                    aug_draws += [aug_draw(ka1, B), aug_draw(ka2, B)]
        out["resample"] = resample
        out["aug_draws"] = aug_draws if aug else None
        return out

    def sampler_draws(self, key, n_rows: int, G: int,
                      aug: bool = False) -> Dict[str, Any]:
        """update_sampler's draws from ``key`` over a buffer of ``n_rows``
        rows, G minibatches: ``perm``, ``noise`` and ``aug_draws``."""
        kk, pkey = jax.random.split(key)
        noise, augs = [], []
        for k in jax.random.split(kk, G):
            k_step, k_drop = jax.random.split(k)
            noise.append(nchw(jax.random.normal(
                k_step, (B, self.res, self.res, 3))))
            augs.append(aug_draw(k_drop, B))
        return {"perm": torch.from_numpy(np.asarray(
                    jax.random.permutation(pkey, n_rows))).long(),
                "noise": noise, "aug_draws": augs if aug else None}


def port_trainer(case: str, **trainer_kw):
    """The port's sampler, value and trainer of ``case``'s configuration on
    the CPU (fp32, einsum attention where the net has the option), with
    ``trainer_kw`` over the config's trainer section; parameters as built
    (load a state file to set them)."""
    from dxmi_tpu_torch.config import instantiate
    from dxmi_tpu_torch.models.igebm import IGEBMEncoder

    cfg = _configs(case)
    if case == "cond":
        from dxmi_tpu_torch import generate_large
        sampler = generate_large.load_sampler(
            cfg, None, "cpu", attn_impl="einsum", up_impl="resize",
            gn_stats="fp32")
    else:
        net = instantiate(cfg["sampler_net"], attn_impl="einsum",
                          fuse_gn_conv=False)
        sampler = instantiate(cfg["sampler"], net=net)
    value = instantiate(cfg["value"])
    energy = IGEBMEncoder(nh=8, keepdim=False) if case == "f" else None
    trainer = instantiate(cfg["trainer"], batchsize=B, n_timesteps=T,
                          **trainer_kw)
    trainer.set_models(sampler, value, **LRS, energy=energy,
                       f_lr=F_LR if energy is not None else None)
    return trainer


def port_buffer(d: Dict[str, Any]):
    """The port's K=1 buffer of a JAX trajectory dict."""
    from dxmi_tpu_torch.trainers.buffer import from_d_sample

    t = {k: torch.from_numpy(np.asarray(d[k])) for k in
         ("sigma", "logp", "entropy")}
    ls = nchw(d["l_sample"])
    y = d.get("y")
    return from_d_sample({"l_sample": ls, "mean": torch.zeros_like(ls[1:]),
                          **t, "y": None if y is None else
                          torch.from_numpy(np.asarray(y)).long()})


def port_iteration(jc: JaxCase, trainer, d, it: int, aug: bool = False,
                   n_generator: Optional[int] = None):
    """The port's iteration ``it`` on JAX's trajectory ``d`` with the JAX
    trainer's draws injected; returns the metrics."""
    img, y = jc.batch(it)
    _, uk, gk = jc.keys(it)
    buf = port_buffer(d)
    m1 = trainer.update_f_v(nchw(img), buf,
                            y=None if y is None else torch.from_numpy(
                                np.asarray(y)).long(),
                            **jc.f_v_draws(uk, aug))
    N = T * B
    G = N // B if (n_generator is None and jc.cond) else (n_generator or 1)
    m2 = trainer.update_sampler(buf, n_generator=G,
                                **jc.sampler_draws(gk, N, G, aug))
    return {**m1, **m2}


def jax_leaves(state) -> List[np.ndarray]:
    return [np.asarray(a) for a in jax.tree.leaves(state)]


def port_leaves(trainer) -> List[np.ndarray]:
    from dxmi_tpu_torch.utils.train_state import trainer_slots

    return [np.asarray(s.get()) for s in trainer_slots(trainer)]


def rejit(jc: JaxCase, **attrs) -> None:
    """Set ``attrs`` on the JAX trainer and jit its phases again (the jitted
    functions read the trainer's configuration when they trace)."""
    tr = jc.trainer
    for k, v in attrs.items():
        setattr(tr, k, v)
    tr._jit_update_f_v = jax.jit(tr._update_f_v_impl)
    tr._jit_update_sampler = jax.jit(tr._update_sampler_impl,
                                     static_argnames=("n_generator",))


def jax_to_port(jc: JaxCase, state, trainer, tmp_path) -> Dict[str, Any]:
    """Write ``state`` with the JAX package's ``save_train_state`` and load
    it into the port's ``trainer``; returns the meta."""
    from dxmi_tpu.utils import checkpoint as jck
    from dxmi_tpu_torch.utils.checkpoint import load_train_state

    os.makedirs(tmp_path, exist_ok=True)
    jck.save_train_state(str(tmp_path), state, i_iter=2, epoch=1,
                         best_fid=0.5)
    return load_train_state(str(tmp_path), trainer)
