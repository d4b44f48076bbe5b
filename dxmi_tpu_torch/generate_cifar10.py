"""Generate samples from a DxMI CIFAR-10 run directory with the port.

    python -m dxmi_tpu_torch.generate_cifar10 --log_dir <run> \
        [--sampler best|last] [--n_generate N] [--batchsize B] \
        [--save_npz samples.npz] [--seed S] [--device cuda|cpu]

Reads ``config.yaml`` and ``sampler_{best,last}.pth`` from the run directory
(the reference's run-dir contract; the YAML is read without PyYAML) and
draws ``N`` samples in batches of ``B``. ``--save_npz`` streams them batch by
batch as uint8 NHWC into ``arr_0``, the evaluator's format, so the host never
holds all N. PNG writing, FID and ``--int8`` are not ported yet.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch
from torch import nn

from dxmi_tpu_torch.config import instantiate, load_yaml
from dxmi_tpu_torch.runtime import select_device
from dxmi_tpu_torch.samplers.var import VARSampler
from dxmi_tpu_torch.utils.checkpoint import (load_sampler_into,
                                             load_sampler_state,
                                             resolve_run_checkpoint)
from dxmi_tpu_torch.utils.npz_stream import NpzStreamWriter


def load_sampler(cfg: Dict[str, Any],
                 state_dict: Optional[Dict[str, torch.Tensor]],
                 device: str = "cuda", seed: int = 0,
                 **net_overrides: Any) -> VARSampler:
    """The config's sampler on ``device`` in eval mode. ``state_dict`` is a
    ``VARSampler`` state dict (``log_betas`` may be missing: the schedule's
    initial sigmas stay); None keeps random weights drawn from ``seed``."""
    dev = select_device(device)
    torch.manual_seed(seed)
    net = instantiate(cfg["sampler_net"], **net_overrides)
    sampler = instantiate(cfg["sampler"], net=net)
    if state_dict is not None:
        load_sampler_into(sampler, state_dict)
    return sampler.to(dev).eval()


def iter_batches(sampler: nn.Module, n: int, batchsize: int,
                 seed: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
    """The sampler's (VARSampler or EDMSampler) output dicts of
    ``n // batchsize`` batches, drawn from one generator seeded with
    ``seed`` on the sampler's device."""
    if n % batchsize:
        raise ValueError(f"n={n} is not a multiple of batchsize={batchsize}")
    device = sampler.log_betas.device
    gen = torch.Generator(device=device).manual_seed(seed)
    for _ in range(n // batchsize):
        yield sampler.sample(batchsize, generator=gen)


@torch.no_grad()
def sample_batches(sampler: VARSampler, n: int, batchsize: int,
                   seed: int = 0) -> torch.Tensor:
    """``n`` final samples (n, C, H, W) float32 on the CPU, drawn in batches
    of ``batchsize`` from one generator seeded with ``seed``."""
    return torch.cat([out["sample"].cpu()
                      for out in iter_batches(sampler, n, batchsize, seed)])


@torch.no_grad()
def stream_samples(sampler: nn.Module, n: int, batchsize: int, seed: int,
                   save_npz: Optional[str]) -> int:
    """Draw the batches of ``iter_batches`` and stream each one as uint8
    NHWC into ``arr_0`` of ``save_npz``, and the class labels of a
    class-conditional sampler (int64) into ``arr_1`` at the end (None:
    draw and drop them); returns the count. Serves both CLIs."""
    C, H, W = sampler.sample_shape
    batches = iter_batches(sampler, n, batchsize, seed)
    if save_npz is None:
        n_done = sum(out["sample"].shape[0] for out in batches)
        # the batches are only queued on the card: wait for them, so that
        # the caller's clock times the generation
        if sampler.log_betas.is_cuda:
            torch.cuda.synchronize(sampler.log_betas.device)
        return n_done
    ys = []
    with NpzStreamWriter(save_npz, n, (H, W, C)) as writer:
        for out in batches:
            writer.write(to_uint8(out["sample"]))
            if out.get("y") is not None:
                ys.append(out["y"].cpu().numpy().astype(np.int64))
        if ys:
            writer.add("arr_1", np.concatenate(ys))
    return writer.n


def generate(cfg: Dict[str, Any],
             state_dict: Optional[Dict[str, torch.Tensor]], n: int,
             batchsize: int, device: str = "cuda", seed: int = 0,
             **net_overrides: Any) -> torch.Tensor:
    """Build the config's sampler, load ``state_dict`` (None: random weights
    from ``seed``) and return ``n`` samples (n, C, H, W) float32 on the CPU.
    ``net_overrides`` go to the network's constructor (e.g.
    ``fuse_gn_conv=False``)."""
    sampler = load_sampler(cfg, state_dict, device, seed, **net_overrides)
    return sample_batches(sampler, n, batchsize, seed)


def to_uint8(x: torch.Tensor) -> np.ndarray:
    """[-1, 1] float NCHW (on any device) -> uint8 NHWC on the host."""
    x = ((x + 1.0) / 2.0).clamp(0.0, 1.0)
    return (x * 255.0 + 0.5).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--log_dir", required=True)
    p.add_argument("--sampler", default="best", choices=["best", "last"])
    p.add_argument("-n", "--n_generate", type=int, default=50000)
    p.add_argument("--batchsize", type=int, default=100)
    p.add_argument("--save_npz", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--int8", action="store_true")
    args = p.parse_args()
    if args.int8:
        raise NotImplementedError("--int8: not ported yet for UNetSmall")

    cfg = load_yaml(os.path.join(args.log_dir, "config.yaml"))
    path = resolve_run_checkpoint(args.log_dir, "sampler", args.sampler)
    print(f"sampler loaded from {path}", flush=True)
    t0 = time.perf_counter()
    sampler = load_sampler(cfg, load_sampler_state(path), args.device,
                           args.seed)
    n = stream_samples(sampler, args.n_generate, args.batchsize, args.seed,
                       args.save_npz)
    dt = time.perf_counter() - t0
    print(f"generated {n} samples in {dt:.2f} s ({n / dt:.1f} img/s, setup "
          "included)", flush=True)
    if args.save_npz:
        print(f"saved {args.save_npz} (streamed)", flush=True)


if __name__ == "__main__":
    main()
