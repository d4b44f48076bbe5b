"""DxMI on 2D synthetic data with the port (``train_2d.py:34-175``): an
EpsMLP policy in a T-step VARSampler over 2-vectors (``trainable_beta=
'fix_last'``), a time-dependent ValueMLP as value and energy, and
``DxMITrainer(gamma=1, use_sampler_beta, adavelreg=0.99, time_cost=0,
time_cost_sig=1)``.

    python -m dxmi_tpu_torch.train_2d --data 8gaussians --n_iter 2000 \
        [--eval_every 250 --curve_out curve.json] [--device cuda|cpu]

The policy is first pretrained by eps-matching on the sampler's own
q-process with its own Adam (``pretrain_step``, ``train_2d.py:88-118``),
unless ``--pretrain_cache`` names a file that exists: that file is the
net's parameters as flax's ``to_bytes`` writes them (read and written
through ``utils/msgpack.py``, so a cache of either package loads in the
other); a missing one is written after pretraining. The MLPs' weights are
drawn as flax's ``Dense`` draws them (``models/mlp.py``) from ``--seed``;
data come from ``RandomState(seed)`` as in the JAX entry, the sampler's
noise from a torch generator. ``--eval_every`` evaluates the mean log
density of ``--eval_n`` samples under the true 8-gaussians density and
``--curve_out`` writes the curve in the JAX entry's JSON layout
(``{'config': ..., 'curve': [{'iter', 'loglik'}, ...]}``); ``--out`` gets
``<data>_samples.npy`` of 2000 final samples.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from dxmi_tpu_torch.data.synthetic import pdf_8gaussian, sample2d
from dxmi_tpu_torch.models.mlp import EpsMLP, ValueMLP
from dxmi_tpu_torch.runtime import select_device
from dxmi_tpu_torch.samplers.var import VARSampler
from dxmi_tpu_torch.schedules import var_schedule
from dxmi_tpu_torch.trainers.dxmi import DxMITrainer, train_step
from dxmi_tpu_torch.trainers.optim import Adam
from dxmi_tpu_torch.utils import msgpack
from dxmi_tpu_torch.utils.convert import module_from_flax
from dxmi_tpu_torch.utils.train_state import flax_tree


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data", default="8gaussians",
                   choices=["8gaussians", "2spirals", "checkerboard"])
    p.add_argument("--n_timesteps", type=int, default=10)
    p.add_argument("--n_iter", type=int, default=2000)
    p.add_argument("--batchsize", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--v_lr", type=float, default=1e-4)
    p.add_argument("--beta_lr", type=float, default=1e-4)
    p.add_argument("--tau1", type=float, default=0.1)
    p.add_argument("--tau2", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pretrain_iters", type=int, default=1000)
    p.add_argument("--eval_every", type=int, default=0)
    p.add_argument("--eval_n", type=int, default=2000)
    p.add_argument("--curve_out", default="")
    p.add_argument("--pretrain_cache", default="")
    p.add_argument("--out", default="results/2d")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def build(args, device: torch.device):
    """(sampler, value, trainer) of the entry, weights from ``args.seed``."""
    gen = torch.Generator().manual_seed(args.seed)
    sampler = VARSampler(EpsMLP(generator=gen), n_timesteps=args.n_timesteps,
                         sample_shape=(2,), trainable_beta="fix_last")
    value = ValueMLP(time_dependent=True, generator=gen)
    sampler.to(device)
    value.to(device)
    trainer = DxMITrainer(batchsize=args.batchsize, tau1=args.tau1,
                          tau2=args.tau2, gamma=1.0,
                          n_timesteps=args.n_timesteps,
                          use_sampler_beta=True, adavelreg=0.99,
                          time_cost=0.0, time_cost_sig=1.0)
    trainer.set_models(sampler, value, lr=args.lr, v_lr=args.v_lr,
                       beta_lr=args.beta_lr)
    return sampler, value, trainer


def pretrain_step(sampler: VARSampler, opt: Adam, x0: torch.Tensor,
                  i: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """One eps-matching step (``train_2d.py:101-114``) at the sampling steps
    ``i`` (B,) with the noise ``eps``: x_t = sqrt(gbar) x0 + sqrt(1 - gbar)
    eps, gbar = gamma_bar[T - 1 - i], the net's eps at tau[i] against eps
    (mean square). Returns the loss."""
    T = sampler.n_timesteps
    gamma_bar = torch.as_tensor(var_schedule(T).gamma_bar,
                                dtype=torch.float32, device=x0.device)
    gbar = gamma_bar[T - 1 - i][:, None]
    x_t = torch.sqrt(gbar) * x0 + torch.sqrt(1 - gbar) * eps
    loss = ((sampler.net(x_t, sampler.tau[i]) - eps) ** 2).mean()
    opt.step(torch.autograd.grad(loss, opt.params))
    return loss.detach()


def pretrain(args, sampler: VARSampler, rng: np.random.RandomState,
             device: torch.device) -> None:
    """Load the cache, or pretrain (drawing the data from ``rng``) and write
    it when ``--pretrain_cache`` is set."""
    net = sampler.net
    if args.pretrain_cache and os.path.exists(args.pretrain_cache):
        net.load_state_dict(module_from_flax(
            net, msgpack.read(args.pretrain_cache)))
        print(f"pretrained policy loaded from {args.pretrain_cache}",
              flush=True)
        return
    if args.pretrain_iters <= 0:
        return
    opt = Adam(list(net.parameters()), 1e-3)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    B, T = args.batchsize, args.n_timesteps
    for _ in range(args.pretrain_iters):
        x0 = torch.from_numpy(sample2d(args.data, B, rng)).to(device)
        i = torch.randint(0, T, (B,), generator=gen, device=device)
        eps = torch.randn(x0.shape, generator=gen, device=device)
        loss = pretrain_step(sampler, opt, x0, i, eps)
    print(f"pretrain done, eps-loss {float(loss):.4f}", flush=True)
    if args.pretrain_cache:
        os.makedirs(os.path.dirname(args.pretrain_cache) or ".",
                    exist_ok=True)
        msgpack.write(args.pretrain_cache, flax_tree(net))
        print(f"pretrained policy saved to {args.pretrain_cache}",
              flush=True)


@torch.no_grad()
def loglik(sampler: VARSampler, n: int, generator: torch.Generator
           ) -> float:
    """Mean log of the true 8-gaussians density at ``n`` samples."""
    s = sampler.sample(n, generator)["sample"].cpu().numpy()
    return float(np.log(pdf_8gaussian(s) + 1e-12).mean())


def main(argv: Optional[List[str]] = None) -> None:
    args = parser().parse_args(argv)
    dev = select_device(args.device)
    rng = np.random.RandomState(args.seed)
    sampler, _, trainer = build(args, dev)
    pretrain(args, sampler, rng, dev)

    def eval_gen(i: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(
            args.seed + 12345 + i)

    curve = []
    do_eval = args.eval_every > 0 and args.data == "8gaussians"
    if do_eval:
        ll0 = loglik(sampler, args.eval_n, eval_gen(0))
        curve.append({"iter": 0, "loglik": ll0})
        print(f"iter 0 (post-pretrain) loglik={ll0:.4f}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.time()
    for i_iter in range(args.n_iter):
        x = torch.from_numpy(sample2d(args.data, args.batchsize, rng)).to(dev)
        m = train_step(trainer, x, None, gen, n_generator=1)
        if i_iter % 200 == 0:
            print(f"iter {i_iter} d_loss={float(m['ebm/d_loss_']):.4f} "
                  f"sampler_loss={float(m['sampler/sampler_loss_']):.4f} "
                  f"({(i_iter + 1) / (time.time() - t0):.1f} it/s)",
                  flush=True)
        if do_eval and (i_iter + 1) % args.eval_every == 0:
            ll = loglik(sampler, args.eval_n, eval_gen(i_iter + 1))
            curve.append({"iter": i_iter + 1, "loglik": ll})
            print(f"iter {i_iter + 1} loglik={ll:.4f}", flush=True)

    with torch.no_grad():
        samples = sampler.sample(2000, gen)["sample"].cpu().numpy()
    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, f"{args.data}_samples.npy"), samples)
    if args.data == "8gaussians":
        ll = float(np.log(pdf_8gaussian(samples) + 1e-12).mean())
        print(f"mean log-likelihood under true pdf: {ll:.4f}", flush=True)
    if args.curve_out and curve:
        os.makedirs(os.path.dirname(args.curve_out) or ".", exist_ok=True)
        with open(args.curve_out, "w") as f:
            json.dump({"config": vars(args), "curve": curve}, f, indent=1)
        print(f"curve saved to {args.curve_out}", flush=True)
    print(f"samples saved to {args.out}", flush=True)


if __name__ == "__main__":
    main()
