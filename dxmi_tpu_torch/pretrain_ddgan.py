"""Denoising pretraining of the DDGAN generator (``scripts/
pretrain_ddgan.py``) with the port: the under-pretrained NCSN++ that the
DDGAN closing gate fine-tunes (``runs_conv/pre_ddgan800.msgpack`` is 800
steps at batch 128, seed 7).

    python -m dxmi_tpu_torch.pretrain_ddgan --out pre.msgpack [--steps 800] \
        [--batch 64] [--lr 2e-4] [--seed 7] [--n_timesteps 4] [--fake_data] \
        [--log_every 50] [--device cuda|cpu]

NCSN++ at ``NCSNppArgs()`` (47,942,019 parameters, fp32; K1 for every
GroupNorm) in a ``DDGANSampler(T, 'fix_last', use_z=True)``, from flax's
initialisers (``models/flax_init.py``) drawn from ``--seed``. A step draws
the DDGAN time index ti ~ U{0..T-1}, eps ~ N(0, I) and z ~ N(0, I_nz),
diffuses x0 to x_t with the VP alpha-bar of the sampler's discretisation
(``_vp_variance`` on the t grid (0..T)/T * (1 - 1e-3) + 1e-3) and takes one
Adam step on the net down mean((G(x_t, ti, z) - x0)^2), the net
deterministic as the JAX script applies it. The data are
``fake_cifar(max(4 batch, 1024), seed)`` with ``--fake_data``, else
CIFAR-10's training split under ``datasets/``, in [-1, 1]. The file is the
JAX script's payload, which ``train_cifar10`` on ``configs/cifar10/
T4_ddgan.yaml`` reads as its ``training.sampler_ckpt`` in either package.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from dxmi_tpu_torch.data.cifar10 import CIFAR10, fake_cifar
from dxmi_tpu_torch.models.flax_init import flax_init_
from dxmi_tpu_torch.models.ncsnpp import NCSNpp, NCSNppArgs
from dxmi_tpu_torch.runtime import select_device
from dxmi_tpu_torch.samplers.ddgan import DDGANSampler, _vp_variance
from dxmi_tpu_torch.trainers import pretrain
from dxmi_tpu_torch.trainers.optim import Adam
from dxmi_tpu_torch.utils.checkpoint import save_checkpoint


def build(n_timesteps: int, device: torch.device,
          generator: torch.Generator,
          config: NCSNppArgs = None) -> DDGANSampler:
    """The script's sampler on ``device``, its net drawn from flax's
    initialisers."""
    with device:
        net = NCSNpp(config=config or NCSNppArgs())
        sampler = DDGANSampler(net, n_timesteps, (3, 32, 32),
                               trainable_beta="fix_last", use_z=True)
    flax_init_(net, generator)
    return sampler.to(device)


def alpha_bar(n_timesteps: int) -> np.ndarray:
    """The VP alpha-bar at the sampler's own discretisation, (T,) fp32
    (``pretrain_ddgan.py:66-72``)."""
    T = n_timesteps
    t = np.arange(0, T + 1, dtype=np.float64) / T
    t = t * (1.0 - 1e-3) + 1e-3
    edges = 1.0 - _vp_variance(t, 0.1, 20.0)
    betas = 1.0 - edges[1:] / edges[:-1]
    return np.cumprod(1.0 - betas).astype(np.float32)


def x0_loss(net: torch.nn.Module, a_bar: torch.Tensor, x0: torch.Tensor,
            ti: torch.Tensor, eps: torch.Tensor, z: torch.Tensor
            ) -> torch.Tensor:
    """The x0-matching loss at DDGAN time indices ``ti`` (B,) with noise
    ``eps`` and latents ``z`` (``pretrain_ddgan.py:78-90``)."""
    ab = a_bar[ti][:, None, None, None]
    x_t = torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * eps
    net.eval()
    return ((net(x_t, ti.float(), z) - x0) ** 2).mean()


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--n_timesteps", type=int, default=4)
    p.add_argument("--fake_data", action="store_true")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()

    dev = select_device(args.device)
    if args.fake_data:
        ds = fake_cifar(max(args.batch * 4, 1024), args.seed)
    else:
        ds = CIFAR10("datasets", train=True)
    images = pretrain.to_device(
        ds.images.astype(np.float32) / 127.5 - 1.0, dev)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    sampler = build(args.n_timesteps, dev, gen)
    a_bar = torch.from_numpy(alpha_bar(args.n_timesteps)).to(dev)
    opt = Adam(list(sampler.net.parameters()), args.lr)
    T, nz = args.n_timesteps, sampler.nz

    def step(idx):
        x0 = images[torch.from_numpy(idx).to(dev)]
        B = x0.shape[0]
        ti = torch.randint(0, T, (B,), generator=gen, device=dev)
        eps = torch.randn(x0.shape, generator=gen, device=dev)
        z = torch.randn((B, nz), generator=gen, device=dev)
        loss = x0_loss(sampler.net, a_bar, x0, ti, eps, z)
        pretrain.adam_step(opt, loss)
        return loss.detach()

    pretrain.run(step, len(images), args.batch, args.steps, args.seed,
                 args.log_every,
                 lambda it, v: f"pretrain {it:5d}  x0-mse {v:.4f}", dev)
    save_checkpoint(args.out, sampler, meta={"pretrain_steps": args.steps})
    print(f"saved pretrained DDGAN sampler to {args.out}")


if __name__ == "__main__":
    main()
