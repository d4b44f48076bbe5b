"""Generate from a large-image (ImageNet64, LSUN) DxMI run directory with the
port: UNetADM + EDMSampler.

    python -m dxmi_tpu_torch.generate_large --log_dir <run> \
        [--sampler best|last] [--n_generate N] [--batchsize B] [--seed S] \
        [--save_npz samples.npz] [--skip_fid] [--save_dir DIR] \
        [--attn_impl fused|flash|einsum] [--up_impl phase|resize] \
        [--gn_stats fp32|bf16_onepass] [--int8] [--guidance_scale G] \
        [--device cuda|cpu] [--any.dot.key value ...]

Reads ``config.yaml`` (without PyYAML) and the sampler checkpoint from the
run directory, looked up in the JAX entry's order (``sampler_{best,last}``,
then ``sampler``; flax ``.msgpack`` before ``.pth`` and ``.pt``), builds the net from its
``diffusion:`` section and the sampler from its ``sampler:`` section, and
draws ``N`` samples in batches of ``B``. ``--save_npz`` streams them batch by
batch as uint8 NHWC into ``arr_0`` and writes the class labels under
``arr_1`` at the end. ``--int8`` samples with static W8A8 ResBlock convs
(K8) and attention blocks (K5) after calibrating their activation scales on
two rounds of 8 full-precision trajectories, as the JAX entry does. The
defaults are the JAX entry's, and so is FID: without ``--skip_fid`` each
batch goes through the FID Inception on the device and FID against
``datasets/VIRTUAL_<data.name>[_labeled].npz`` (or the ImageNet64 / LSUN
file) is printed at the end, with its time split; when those files or the
Inception weights are missing it says so and goes on. ``--skip_fid`` or
``--save_dir`` writes the samples as PNGs (``0_<index>.png`` into
``--save_dir``, default ``<log_dir>/generated_<sampler>``). Dot-key
overrides are merged over ``config.yaml``. ``--guidance_scale G`` samples
through ``DxMITrainerCond.sample_guidance`` with the run's value
(``value_<sampler>``), as the JAX entry does (``generate_large.py:133-153``):
labels drawn per batch, each step moved along the value's gradient times G
times the step's sigma.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, Optional, Tuple

import torch

from dxmi_tpu_torch.config import (load_yaml, merge, parse_nested_args,
                                   parse_unknown_args)
from dxmi_tpu_torch.fid import runner as fid_runner
from dxmi_tpu_torch.fid import stats as stats_lib
from dxmi_tpu_torch.generate_cifar10 import (guidance_draw, iter_batches,
                                             stream_samples)
from dxmi_tpu_torch.models.unet_adm import (QUANT_SCALE_NAMES,
                                            create_unet_adm, seeded_normal_)
from dxmi_tpu_torch.runtime import select_device
from dxmi_tpu_torch.samplers.edm import EDMSampler, KarrasDenoiser
from dxmi_tpu_torch.utils.checkpoint import (load_sampler_into,
                                             load_sampler_state, read_meta,
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
    args, unknown = p.parse_known_args()

    cfg = merge(load_yaml(os.path.join(args.log_dir, "config.yaml")),
                parse_nested_args(parse_unknown_args(unknown)))
    path = resolve_run_checkpoint(args.log_dir, "sampler", args.sampler)
    print(f"sampler loaded from {path}", flush=True)
    meta = read_meta(path)
    if "fid" in meta:
        print(f"checkpoint FID {meta['fid']}", flush=True)
    t0 = time.perf_counter()
    sampler = load_sampler(cfg, load_sampler_state(path, net="unet_adm"), args.device,
                           args.seed, args.attn_impl, args.up_impl,
                           args.gn_stats, args.int8)
    if args.int8:
        print("int8: static activation scales calibrated", flush=True)
    draw = None
    if args.guidance_scale:
        draw = guidance_draw(cfg, sampler, args.log_dir, args.sampler,
                             args.guidance_scale, args.batchsize)
    save_dir = None
    if args.skip_fid or args.save_dir:
        save_dir = args.save_dir or os.path.join(
            args.log_dir, f"generated_{args.sampler}")
        os.makedirs(save_dir, exist_ok=True)
    fid_state = None
    if not args.skip_fid:
        name = cfg["data"]["name"]
        s = fid_runner._find((
            f"datasets/VIRTUAL_{name}_labeled.npz",
            f"datasets/VIRTUAL_{name}.npz",
            "datasets/VIRTUAL_imagenet64_labeled.npz",
            "datasets/VIRTUAL_lsun_bedroom256.npz"))
        w = fid_runner._find(fid_runner.DEFAULT_WEIGHTS)
        if w and s:
            fid_state = fid_runner.build_fid_state(w, s,
                                                   sampler.log_betas.device)
        else:
            print("FID assets missing; falling back to PNG dump", flush=True)
    t1 = time.perf_counter()
    n, acts = stream_samples(sampler, args.n_generate, args.batchsize,
                             args.seed, args.save_npz, save_dir, fid_state,
                             draw)
    dt = time.perf_counter() - t0
    print(f"generated {n} samples in {dt:.2f} s ({n / dt:.1f} img/s, setup "
          "included)", flush=True)
    if save_dir is not None:
        print(f"wrote {n} PNGs to {save_dir}", flush=True)
    if args.save_npz:
        print(f"saved {args.save_npz} (streamed)", flush=True)
    if fid_state is not None:
        t2 = time.perf_counter()
        info: Dict[str, Any] = {}
        fid = stats_lib.frechet_distance(
            *stats_lib.activation_statistics(acts), fid_state.m2,
            fid_state.s2, info=info)
        print(f"FID: {fid}", flush=True)
        print(f"FID time: sample and inception {t2 - t1:.3f} s, frechet "
              f"{info['seconds']:.3f} s ({info['route']})", flush=True)


if __name__ == "__main__":
    main()
