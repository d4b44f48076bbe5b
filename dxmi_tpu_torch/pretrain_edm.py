"""EDM denoising pretraining of an ADM net (``scripts/pretrain_edm.py``)
with the port: the starting checkpoint of the Cond family's closing gate
(``runs_conv/pre_edm16.msgpack``, ``configs/imagenet64/conv16.yaml``).

    python -m dxmi_tpu_torch.pretrain_edm --config configs/imagenet64/conv16.yaml \
        --out pre.msgpack [--steps 600] [--batch 16] [--lr 2e-4] [--seed 11] \
        [--data_size 256] [--log_every 50] [--device cuda|cpu]

The config's EDMSampler through ``train_image_large.build_sampler``: from
``training.pretrained_path`` when that file exists (the JAX script
continues from it too), else from flax's initialisers
(``models/flax_init.py``) drawn from the generator that the first draw of
``--seed`` seeds, as ``init_params``. The net computes in its config's
dtype (bf16 under ``use_fp16``, flash attention: K4 and its backward) with
fp32 parameters. The data are ``structured_class_images(data_size, res,
classes, seed)``. A step draws the EDM lognormal sigma exp(1.2 N - 1.2) and
takes one Adam step on the net down the mean of ``training_losses``
(``trainers/distill.py``, training mode, labels when class-conditional).
The file is the JAX script's payload, which ``train_image_large
--training.pretrained_path`` reads in either package.
"""
from __future__ import annotations

import argparse

import torch

from dxmi_tpu_torch.config import load_yaml
from dxmi_tpu_torch.data.synthetic import structured_class_images
from dxmi_tpu_torch.runtime import select_device
from dxmi_tpu_torch.samplers.edm import EDMSampler
from dxmi_tpu_torch.train_image_large import build_sampler
from dxmi_tpu_torch.trainers import pretrain
from dxmi_tpu_torch.trainers.distill import training_losses
from dxmi_tpu_torch.trainers.optim import Adam
from dxmi_tpu_torch.utils.checkpoint import save_checkpoint


def edm_loss(sampler: EDMSampler, x0: torch.Tensor,
             y: torch.Tensor, sig: torch.Tensor,
             noise: torch.Tensor = None,
             generator: torch.Generator = None) -> torch.Tensor:
    """The mean denoising loss at noise levels ``sig`` (B,)
    (``pretrain_edm.py:71-80``), labels ``y`` or None."""
    return training_losses(sampler.diffusion, sampler.net, x0, sig, y=y,
                           noise=noise, train=True,
                           generator=generator)["loss"].mean()


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--data_size", type=int, default=256)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()

    cfg = load_yaml(args.config)
    dev = select_device(args.device)
    torch.manual_seed(args.seed)  # dropout's draws
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    init_seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                                  device=dev))
    sampler = build_sampler(cfg, dev, init_seed, init="flax")
    n_class = int(cfg["sampler"].get("num_classes") or 0)
    class_cond = bool(cfg["sampler"].get("class_cond"))
    res = int(cfg["diffusion"]["image_size"])
    images, labels = structured_class_images(args.data_size, res,
                                             max(n_class, 1), seed=args.seed)
    images = pretrain.to_device(images, dev)
    labels = torch.from_numpy(labels.astype("int64")).to(dev)
    opt = Adam(list(sampler.net.parameters()), args.lr)

    def step(idx):
        i = torch.from_numpy(idx).to(dev)
        x0 = images[i]
        sig = torch.exp(torch.randn((x0.shape[0],), generator=gen,
                                    device=dev) * 1.2 - 1.2)
        loss = edm_loss(sampler, x0, labels[i] if class_cond else None, sig,
                        generator=gen)
        pretrain.adam_step(opt, loss)
        return loss.detach()

    pretrain.run(step, len(images), args.batch, args.steps, args.seed,
                 args.log_every,
                 lambda it, v: f"pretrain {it:5d}  edm-loss {v:.4f}", dev)
    save_checkpoint(args.out, sampler, meta={"pretrain_steps": args.steps})
    print(f"saved pretrained EDM sampler to {args.out}")


if __name__ == "__main__":
    main()
