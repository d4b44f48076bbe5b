"""Generate samples from a DxMI CIFAR-10 run directory with the port.

    python -m dxmi_tpu_torch.generate_cifar10 --log_dir <run> \
        [--sampler best|last] [--n_generate N] [--batchsize B] \
        [--save_npz samples.npz] [--seed S] [--device cuda|cpu]

Reads ``config.yaml`` and ``sampler_{best,last}.pth`` from the run directory
(the reference's run-dir contract) and draws ``N`` samples in batches of
``B``. ``--save_npz`` writes them as uint8 NHWC under ``arr_0``, the
evaluator's format. PNG writing and FID are not ported yet.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from dxmi_tpu_torch.config import instantiate, load_yaml
from dxmi_tpu_torch.runtime import select_device
from dxmi_tpu_torch.samplers.var import VARSampler
from dxmi_tpu_torch.utils.checkpoint import (load_sampler_state,
                                             resolve_run_checkpoint)


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
        missing, unexpected = sampler.load_state_dict(state_dict, strict=False)
        if unexpected or set(missing) - {"log_betas"}:
            raise KeyError(f"state dict mismatch: missing {missing}, "
                           f"unexpected {unexpected}")
    return sampler.to(dev).eval()


@torch.no_grad()
def sample_batches(sampler: VARSampler, n: int, batchsize: int,
                   seed: int = 0) -> torch.Tensor:
    """``n`` final samples (n, C, H, W) float32 on the CPU, drawn in batches
    of ``batchsize`` from one generator seeded with ``seed``."""
    if n % batchsize:
        raise ValueError(f"n={n} is not a multiple of batchsize={batchsize}")
    device = sampler.log_betas.device
    gen = torch.Generator(device=device).manual_seed(seed)
    out = [sampler.sample(batchsize, generator=gen)["sample"].cpu()
           for _ in range(n // batchsize)]
    return torch.cat(out)


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
    """[-1, 1] float NCHW -> uint8 NHWC."""
    x = ((x + 1.0) / 2.0).clamp(0.0, 1.0)
    return (x * 255.0 + 0.5).to(torch.uint8).permute(0, 2, 3, 1).numpy()


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--log_dir", required=True)
    p.add_argument("--sampler", default="best", choices=["best", "last"])
    p.add_argument("-n", "--n_generate", type=int, default=50000)
    p.add_argument("--batchsize", type=int, default=100)
    p.add_argument("--save_npz", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()

    cfg = load_yaml(os.path.join(args.log_dir, "config.yaml"))
    path = resolve_run_checkpoint(args.log_dir, "sampler", args.sampler)
    print(f"sampler loaded from {path}", flush=True)
    t0 = time.perf_counter()
    x = generate(cfg, load_sampler_state(path), args.n_generate,
                 args.batchsize, args.device, args.seed)
    dt = time.perf_counter() - t0
    print(f"generated {len(x)} samples in {dt:.2f} s "
          f"({len(x) / dt:.1f} img/s, setup included)", flush=True)
    if args.save_npz:
        np.savez(args.save_npz, arr_0=to_uint8(x))
        print(f"saved {args.save_npz}", flush=True)


if __name__ == "__main__":
    main()
