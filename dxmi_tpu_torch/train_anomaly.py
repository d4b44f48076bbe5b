"""DxMI anomaly detection with the port (``train_anomaly.py:40-186``): train a
T-step sampler with a separate energy and value on nominal images
(``DxMITrainerEV``), then score two image directories by the energy.

    python -m dxmi_tpu_torch.train_anomaly --data_dir <pngs or .pth> \
        [--image_size 64] [--n_iter 2000] [--spectral_norm] [--fake_data] \
        [--run run] [--device cuda|cpu]
    python -m dxmi_tpu_torch.train_anomaly --score --log_dir \
        results/anomaly/run --in_dir <nominal pngs> --out_dir <anomalous pngs>

``build`` makes the JAX entry's nets: the UNetSmall policy (``ch`` 64,
``ch_mult`` (1, 2, 2), attention at image_size / 4) in a VARSampler with
trainable betas, the UNetSmallEncoder value (``ch`` 32, ``ch_mult`` (1, 2),
no attention but its mid block) and the IGEBM energy (``nh`` 64, sum pool,
learned output scale, spectral norm under ``--spectral_norm``); both
UNets run K3 and K2 (and K1) as the port's defaults. Weights are PyTorch's
initialisation drawn from ``--seed``. The data: ``--fake_data`` (uniform
noise images from ``RandomState(seed)``), a tensor file (a ``.pth``/``.pt``
path, or a directory holding ``train_data.pth``: ``data/tensor_file.py``)
or an image folder (``data/image_folder.py``, PNG). The run directory
``results/anomaly/<run>`` gets ``config.yaml`` (image_size, n_timesteps,
spectral_norm) and ``sampler_last.pth``, ``value_last.pth`` and
``energy_last.pth`` (the spectral-norm buffers in its state dict).

``--score`` reads the run directory's energy (``energy_last.msgpack`` of
the JAX entry first, else the port's ``.pth``), scores every PNG under
``--in_dir`` and ``--out_dir`` (sorted, batches of 32; a batch whose
height is not the model's is resized to it as ``jax.image.resize(...,
'bilinear')`` does: a triangle kernel widened by the scale when shrinking,
``resize_bilinear``) and prints JAX's line ``AUROC: x  AUPR: y``.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from dxmi_tpu_torch.config import load_yaml, save_yaml
from dxmi_tpu_torch.models.igebm import IGEBMEncoder
from dxmi_tpu_torch.models.unet_small import UNetSmall, UNetSmallEncoder
from dxmi_tpu_torch.runtime import select_device
from dxmi_tpu_torch.samplers.var import VARSampler
from dxmi_tpu_torch.trainers.dxmi import train_step
from dxmi_tpu_torch.trainers.dxmi_ev import DxMITrainerEV
from dxmi_tpu_torch.utils.checkpoint import (load_module_state,
                                             resolve_run_checkpoint,
                                             save_run_checkpoint)
from dxmi_tpu_torch.utils.metrics import anomaly_scores_from_energy


def build(image_size: int, n_timesteps: int, nh: int = 64, ch: int = 64,
          spectral_norm: bool = False, **net_kw
          ) -> Tuple[UNetSmall, VARSampler, UNetSmallEncoder, IGEBMEncoder]:
    """(policy net, sampler, value, energy) of ``train_anomaly.py:40-58``;
    ``net_kw`` (``fuse_gn_conv``, ``attn_impl``) go to both UNets."""
    net = UNetSmall(ch=ch, out_ch=3, ch_mult=(1, 2, 2), num_res_blocks=1,
                    attn_resolutions=(image_size // 4,), dropout=0.0,
                    in_channels=3, resolution=image_size, **net_kw)
    sampler = VARSampler(net, n_timesteps=n_timesteps,
                         sample_shape=(3, image_size, image_size),
                         trainable_beta=True)
    value = UNetSmallEncoder(ch=ch // 2, out_ch=1, ch_mult=(1, 2),
                             num_res_blocks=1, attn_resolutions=(),
                             dropout=0.0, in_channels=3,
                             resolution=image_size, **net_kw)
    energy = IGEBMEncoder(in_chan=3, out_chan=1, keepdim=False,
                          learn_out_scale=True, nh=nh,
                          use_spectral_norm=spectral_norm)
    return net, sampler, value, energy


def make_trainer(args, device: torch.device, **net_kw):
    """The nets on ``device`` (weights drawn from ``args.seed``) and the EV
    trainer with the entry's settings."""
    torch.manual_seed(args.seed)
    _, sampler, value, energy = build(args.image_size, args.n_timesteps,
                                      spectral_norm=args.spectral_norm,
                                      **net_kw)
    for m in (sampler, value, energy):
        m.to(device)
    trainer = DxMITrainerEV(batchsize=args.batchsize, tau1=args.tau1,
                            tau2=args.tau2, n_timesteps=args.n_timesteps,
                            use_sampler_beta=True, adavelreg=0.99)
    trainer.set_models(sampler, value, energy, lr=args.lr, v_lr=args.v_lr,
                       f_lr=args.f_lr)
    return trainer


def data_batches(args) -> Iterator[Tuple[np.ndarray, dict]]:
    """The entry's three data paths (``train_anomaly.py:104-124``), NHWC
    float32 batches in [-1, 1]."""
    B, res = args.batchsize, args.image_size
    if args.fake_data:
        def gen():
            rng = np.random.RandomState(args.seed)
            while True:
                yield rng.rand(B, res, res, 3).astype(np.float32) * 2 - 1, {}
        return gen()
    if args.data_dir.endswith((".pth", ".pt")) or os.path.isfile(
            os.path.join(args.data_dir, "train_data.pth")):
        from dxmi_tpu_torch.data.tensor_file import tensor_batches

        path = (args.data_dir if args.data_dir.endswith((".pth", ".pt"))
                else os.path.join(args.data_dir, "train_data.pth"))
        return tensor_batches(path, B, seed=args.seed, image_size=res)
    from dxmi_tpu_torch.data.image_folder import load_data

    return load_data(args.data_dir, B, res, seed=args.seed)


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 3, 1, 2))).to(device)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir")
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--n_timesteps", type=int, default=10)
    p.add_argument("--n_iter", type=int, default=2000)
    p.add_argument("--batchsize", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--v_lr", type=float, default=1e-4)
    p.add_argument("--f_lr", type=float, default=1e-4)
    p.add_argument("--tau1", type=float, default=0.01)
    p.add_argument("--tau2", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--run", default="run")
    p.add_argument("--fake_data", action="store_true")
    p.add_argument("--spectral_norm", action="store_true",
                   help="spectral-normalise the energy net (IGEBM-style)")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--score", action="store_true")
    p.add_argument("--log_dir")
    p.add_argument("--in_dir", help="nominal test images")
    p.add_argument("--out_dir", help="anomalous test images")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv: Optional[List[str]] = None) -> Optional[dict]:
    """The entry; returns ``score``'s AUROC and AUPR under ``--score``."""
    args = parser().parse_args(argv)
    dev = select_device(args.device)
    if args.score:
        return score(args, dev)
    trainer = make_trainer(args, dev)
    data = data_batches(args)
    logdir = os.path.join("results/anomaly", args.run)
    os.makedirs(logdir, exist_ok=True)
    save_yaml({"image_size": args.image_size,
               "n_timesteps": args.n_timesteps,
               "spectral_norm": bool(args.spectral_norm)},
              os.path.join(logdir, "config.yaml"))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.time()
    for i in range(args.n_iter):
        x, _ = next(data)
        m = train_step(trainer, to_device(x, dev), None, gen, n_generator=1)
        if i % args.log_every == 0:
            print(f"iter {i} d_loss={float(m['ebm/d_loss_']):.4f} "
                  f"sampler_loss={float(m['sampler/sampler_loss_']):.4f} "
                  f"({(i + 1) / (time.time() - t0):.3f} it/s)", flush=True)
    save_run_checkpoint(logdir, "last", trainer.sampler, trainer.value,
                        energy=trainer.energy)
    print(f"saved to {logdir}", flush=True)


# ---- scoring -------------------------------------------------------------

def _triangle_weights(n_in: int, n_out: int) -> np.ndarray:
    """``jax.image.scale.compute_weight_mat`` for the triangle kernel with
    antialiasing, scale n_out / n_in and no translation: (n_in, n_out)."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_bilinear(x: torch.Tensor, res: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, res, res, C), 'bilinear')`` of an NHWC
    tensor (``antialias=True``, fp32): each spatial axis whose size differs
    contracted with its triangle weights, H then W."""
    for axis in (1, 2):
        n_in = x.shape[axis]
        if n_in == res:
            continue
        w = torch.from_numpy(_triangle_weights(n_in, res)).to(x.device)
        x = torch.tensordot(x, w, dims=([axis], [0])).movedim(-1, axis)
    return x


@torch.no_grad()
def score(args, dev: torch.device) -> dict:
    """AUROC and AUPR of the run's energy on ``--in_dir`` (nominal) against
    ``--out_dir`` (anomalous); prints JAX's line and returns both."""
    from dxmi_tpu_torch.fid.image_dir import list_images, load_batch

    cfg = load_yaml(os.path.join(args.log_dir, "config.yaml"))
    res = int(cfg["image_size"])
    _, _, _, energy = build(res, int(cfg["n_timesteps"]),
                            spectral_norm=bool(cfg.get("spectral_norm",
                                                       False)))
    path = resolve_run_checkpoint(args.log_dir, "energy", "last")
    energy.load_state_dict(load_module_state(path, energy))
    energy.to(dev).eval()

    def dir_scores(path):
        files = list_images(path)
        out = []
        for i in range(0, len(files), 32):
            x = torch.from_numpy(load_batch(files[i:i + 32])).to(dev) \
                * 2.0 - 1.0
            if x.shape[1] != res:  # as the JAX entry, by the height
                x = resize_bilinear(x, res)
            out.append(energy(x.permute(0, 3, 1, 2)).squeeze(-1).cpu()
                       .numpy())
        return np.concatenate(out)

    d = anomaly_scores_from_energy(dir_scores(args.in_dir),
                                   dir_scores(args.out_dir))
    print(f"AUROC: {d['auroc']:.4f}  AUPR: {d['aupr']:.4f}", flush=True)
    return d


if __name__ == "__main__":
    main()
