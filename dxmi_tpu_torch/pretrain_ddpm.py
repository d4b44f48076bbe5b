"""DDPM eps-matching pretraining of the CIFAR-10 U-Net sampler
(``scripts/pretrain_ddpm.py``) with the port: the under-pretrained sampler
that the CIFAR-10 closing gate fine-tunes (``runs_conv/pre800.msgpack`` is
800 steps at batch 128).

    python -m dxmi_tpu_torch.pretrain_ddpm --out pre.msgpack [--steps 3000] \
        [--batch 128] [--lr 2e-4] [--n_timesteps 10] [--seed 112233] \
        [--fake_data] [--ch 128] [--log_every 200] [--device cuda|cpu]

UNetSmall(ch, (1, 2, 2, 2), 2 res blocks, attention at 16, dropout 0.1) in
a ``VARSampler(T, 'fix_last')``, as ``train_cifar10`` builds it (fused
attention, K2; K3 for each GN+SiLU+conv that dropout does not split), from
flax's initialisers (``models/flax_init.py``) drawn from ``--seed``. A step
draws i ~ U{0..T-1}, eps ~ N(0, I) and dropout, diffuses x0 to
x_t = sqrt(gamma_bar[T-1-i]) x0 + sqrt(1 - gamma_bar[T-1-i]) eps and takes
one Adam step on the net down mean((net(x_t, tau[i]) - eps)^2). The data
are ``fake_cifar(max(4 batch, 256), seed)`` with ``--fake_data``, else
CIFAR-10's training split under ``datasets/``, in [-1, 1]. The file is the
JAX script's, ``{'params': {'net', 'log_betas'}, 'meta': {'pretrain_steps'}}``,
which ``train_cifar10 --training.sampler_ckpt`` reads in either package.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from dxmi_tpu_torch.data.cifar10 import CIFAR10, fake_cifar
from dxmi_tpu_torch.models.flax_init import flax_init_
from dxmi_tpu_torch.models.unet_small import UNetSmall
from dxmi_tpu_torch.runtime import select_device
from dxmi_tpu_torch.samplers.var import VARSampler
from dxmi_tpu_torch.schedules import var_schedule
from dxmi_tpu_torch.trainers import pretrain
from dxmi_tpu_torch.trainers.optim import Adam
from dxmi_tpu_torch.utils.checkpoint import save_checkpoint


def build(ch: int, n_timesteps: int, device: torch.device,
          generator: torch.Generator, **net_kw) -> VARSampler:
    """The script's sampler on ``device``, its net drawn from flax's
    initialisers; ``net_kw`` overrides UNetSmall's compute options."""
    with device:
        net = UNetSmall(ch=ch, out_ch=3, ch_mult=(1, 2, 2, 2),
                        num_res_blocks=2, attn_resolutions=(16,), dropout=0.1,
                        in_channels=3, resolution=32, **net_kw)
        sampler = VARSampler(net, n_timesteps, (3, 32, 32),
                             trainable_beta="fix_last")
    flax_init_(net, generator)
    return sampler.to(device)


def eps_loss(sampler: VARSampler, x0: torch.Tensor, i: torch.Tensor,
             eps: torch.Tensor) -> torch.Tensor:
    """The eps-matching loss at sampling steps ``i`` (B,) with noise
    ``eps``, the net in training mode (``pretrain_ddpm.py:70-87``)."""
    T = sampler.n_timesteps
    gamma_bar = torch.from_numpy(var_schedule(T).gamma_bar).to(x0.device)
    gbar = gamma_bar[T - 1 - i][:, None, None, None]
    x_t = torch.sqrt(gbar) * x0 + torch.sqrt(1 - gbar) * eps
    sampler.net.train()
    pred = sampler.net(x_t, sampler.tau[i])
    return ((pred - eps) ** 2).mean()


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--n_timesteps", type=int, default=10)
    p.add_argument("--seed", type=int, default=112233)
    p.add_argument("--fake_data", action="store_true")
    p.add_argument("--ch", type=int, default=128)
    p.add_argument("--log_every", type=int, default=200)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()

    dev = select_device(args.device)
    if args.fake_data:
        ds = fake_cifar(max(args.batch * 4, 256), args.seed)
    else:
        ds = CIFAR10("datasets", train=True)
    images = pretrain.to_device(
        ds.images.astype(np.float32) / 127.5 - 1.0, dev)

    torch.manual_seed(args.seed)  # dropout's draws
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    sampler = build(args.ch, args.n_timesteps, dev, gen)
    opt = Adam(list(sampler.net.parameters()), args.lr)
    T = args.n_timesteps

    def step(idx):
        x0 = images[torch.from_numpy(idx).to(dev)]
        i = torch.randint(0, T, (x0.shape[0],), generator=gen, device=dev)
        eps = torch.randn(x0.shape, generator=gen, device=dev)
        loss = eps_loss(sampler, x0, i, eps)
        pretrain.adam_step(opt, loss)
        return loss.detach()

    pretrain.run(step, len(images), args.batch, args.steps, args.seed,
                 args.log_every, lambda it, v: f"step {it} eps-loss {v:.4f}",
                 dev)
    save_checkpoint(args.out, sampler, meta={"pretrain_steps": args.steps})
    print(f"saved pretrained sampler to {args.out}")


if __name__ == "__main__":
    main()
