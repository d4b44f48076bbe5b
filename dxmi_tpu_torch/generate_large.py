"""Generate from a large-image (ImageNet64, LSUN) DxMI run directory with the
port: UNetADM + EDMSampler.

    python -m dxmi_tpu_torch.generate_large --log_dir <run> \
        [--sampler best|last] [--n_generate N] [--batchsize B] [--seed S] \
        [--save_npz samples.npz] [--attn_impl fused|flash|einsum] \
        [--up_impl phase|resize] [--gn_stats fp32|bf16_onepass] [--int8] \
        [--device cuda|cpu]

Reads ``config.yaml`` (without PyYAML) and the sampler checkpoint from the
run directory, looked up in the JAX entry's order (``sampler_{best,last}``,
then ``sampler``; flax ``.msgpack`` before ``.pth`` and ``.pt``), builds the net from its
``diffusion:`` section and the sampler from its ``sampler:`` section, and
draws ``N`` samples in batches of ``B``. ``--save_npz`` streams them batch by
batch as uint8 NHWC into ``arr_0`` and writes the class labels under
``arr_1`` at the end. ``--int8`` samples with static W8A8 ResBlock convs
(K8) and attention blocks (K5) after calibrating their activation scales on
two rounds of 8 full-precision trajectories, as the JAX entry does. The
defaults are the JAX entry's. Not ported yet: ``--guidance_scale``, FID, and
PNG writing (``--skip_fid``, ``--save_dir``).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, Optional, Tuple

import torch

from dxmi_tpu_torch.config import load_yaml
from dxmi_tpu_torch.generate_cifar10 import iter_batches, stream_samples
from dxmi_tpu_torch.models.unet_adm import (QUANT_SCALE_NAMES,
                                            create_unet_adm, seeded_normal_)
from dxmi_tpu_torch.runtime import select_device
from dxmi_tpu_torch.samplers.edm import EDMSampler, KarrasDenoiser
from dxmi_tpu_torch.utils.checkpoint import (load_sampler_into,
                                             load_sampler_state,
                                             resolve_run_checkpoint)

# calibration of --int8, as generate_large.py's JAX entry runs it
CALIB_SEED, CALIB_N_SAMPLE, CALIB_N_ROUNDS = 123, 8, 2


def load_sampler(cfg: Dict[str, Any],
                 state_dict: Optional[Dict[str, torch.Tensor]],
                 device: str = "cuda", seed: int = 0,
                 attn_impl: str = "fused", up_impl: str = "phase",
                 gn_stats: str = "bf16_onepass",
                 int8: bool = False) -> EDMSampler:
    """The run's EDMSampler on ``device`` in eval mode, with the network's
    conv and linear weights in its compute dtype (the int8 layers keep fp32
    weights to quantise from). ``state_dict`` is an ``EDMSampler`` state
    dict (``log_betas`` and the activation scales of int8 layers may be
    missing); None draws every parameter from ``seed`` (``seeded_normal_``),
    on the device. ``int8`` builds the net with ``quant_int8='static'`` and
    calibrates it (``CALIB_*``), as the JAX entry's ``--int8``."""
    dev = select_device(device)
    dcfg = dict(cfg["diffusion"])
    sigma_min = dcfg.pop("sigma_min", 0.002)
    sigma_max = dcfg.pop("sigma_max", 80.0)
    dcfg.pop("weight_schedule", None)
    distillation = dcfg.pop("distillation", False)
    with dev:
        net = create_unet_adm(**dcfg, attn_impl=attn_impl, up_impl=up_impl,
                              gn_stats=gn_stats,
                              quant_int8="static" if int8 else False)
        sampler = EDMSampler(net, KarrasDenoiser(sigma_min=sigma_min,
                                                 sigma_max=sigma_max,
                                                 distillation=distillation),
                             **cfg["sampler"])
    sampler.to(dev)  # the schedule's buffers start on the host
    if state_dict is None:
        seeded_normal_(net, seed)
    else:
        load_sampler_into(sampler, state_dict, QUANT_SCALE_NAMES)
    net.cast_weights()
    sampler.eval()
    if int8:
        gen = torch.Generator(device=dev).manual_seed(CALIB_SEED)
        sampler.calibrate_quant(gen, CALIB_N_SAMPLE, CALIB_N_ROUNDS)
    return sampler


@torch.no_grad()
def sample_batches(sampler: EDMSampler, n: int, batchsize: int,
                   seed: int = 0) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``n`` final samples (n, C, H, W) float32 on the CPU and their labels
    (None for an unconditional net), drawn in batches of ``batchsize`` from
    one generator seeded with ``seed``."""
    xs, ys = [], []
    for out in iter_batches(sampler, n, batchsize, seed):
        xs.append(out["sample"].cpu())
        if out["y"] is not None:
            ys.append(out["y"].cpu())
    return torch.cat(xs), (torch.cat(ys) if ys else None)


def generate(cfg: Dict[str, Any],
             state_dict: Optional[Dict[str, torch.Tensor]], n: int,
             batchsize: int, device: str = "cuda", seed: int = 0,
             attn_impl: str = "fused", up_impl: str = "phase",
             gn_stats: str = "bf16_onepass", int8: bool = False
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Build the run's sampler, load ``state_dict`` (None: random weights
    from ``seed``), calibrate it when ``int8``, and return ``n`` samples
    (n, C, H, W) float32 on the CPU with their labels."""
    sampler = load_sampler(cfg, state_dict, device, seed, attn_impl, up_impl,
                           gn_stats, int8)
    return sample_batches(sampler, n, batchsize, seed)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--log_dir", required=True)
    p.add_argument("--sampler", default="best", choices=["best", "last"])
    p.add_argument("--n_sample", "--n_generate", dest="n_generate", type=int,
                   default=50000)
    p.add_argument("--batchsize", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_npz", default=None)
    p.add_argument("--attn_impl", default="fused",
                   choices=["fused", "flash", "einsum"])
    p.add_argument("--up_impl", default="phase", choices=["phase", "resize"])
    p.add_argument("--gn_stats", default="bf16_onepass",
                   choices=["fp32", "bf16_onepass"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--int8", action="store_true")
    p.add_argument("--guidance_scale", type=float, default=None)
    p.add_argument("--skip_fid", action="store_true")
    p.add_argument("--save_dir", default=None)
    args = p.parse_args()
    for flag, on in (("--guidance_scale", args.guidance_scale),
                     ("--skip_fid (PNG writing)", args.skip_fid),
                     ("--save_dir (PNG writing)", args.save_dir)):
        if on:
            raise NotImplementedError(f"{flag}: not ported yet")

    cfg = load_yaml(os.path.join(args.log_dir, "config.yaml"))
    path = resolve_run_checkpoint(args.log_dir, "sampler", args.sampler)
    print(f"sampler loaded from {path}", flush=True)
    t0 = time.perf_counter()
    sampler = load_sampler(cfg, load_sampler_state(path, net="unet_adm"), args.device,
                           args.seed, args.attn_impl, args.up_impl,
                           args.gn_stats, args.int8)
    if args.int8:
        print("int8: static activation scales calibrated", flush=True)
    n = stream_samples(sampler, args.n_generate, args.batchsize, args.seed,
                       args.save_npz)
    dt = time.perf_counter() - t0
    print(f"generated {n} samples in {dt:.2f} s ({n / dt:.1f} img/s, setup "
          "included); FID is not ported yet", flush=True)
    if args.save_npz:
        print(f"saved {args.save_npz} (streamed)", flush=True)

if __name__ == "__main__":
    main()
