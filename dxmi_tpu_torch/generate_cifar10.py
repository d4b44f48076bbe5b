"""Generate samples from a DxMI CIFAR-10 run directory with the port.

    python -m dxmi_tpu_torch.generate_cifar10 --log_dir <run> \
        [--sampler|--epoch best|last] [--n_generate N] [--batchsize B] \
        [--save_dir DIR] [--save_npz samples.npz] [--eval_fid] \
        [--stat stats.npz] [--cleanup] [--seed S] [--int8] \
        [--dtype fp32|bf16] [--guidance_scale G] [--device cuda|cpu] \
        [--any.dot.key value ...]

Reads ``config.yaml`` (without PyYAML; dot-key overrides merged over it, as
the JAX entry merges them) and the sampler checkpoint from the run directory
(the reference's run-dir contract in the JAX entry's order: flax
``.msgpack`` before ``.pth`` and ``.pt``) and draws ``N`` samples in batches
of ``B``. Each sample is written as ``0_<index>.png`` into ``--save_dir``
(default ``<log_dir>/generated_<sampler>``) by a thread pool
(``utils/png.py``). ``--save_npz`` also streams them batch by batch as
uint8 NHWC into ``arr_0``, the evaluator's format, so the host never holds
all N. ``--eval_fid`` (or ``--stat``) computes FID from the PNG directory
against the dataset statistics (``--stat``, else ``fid/runner.py``'s
``DEFAULT_STATS``) when they and the Inception weights are on disk, and
prints its time split; ``--cleanup`` then deletes the PNGs.

The network follows the config's ``sampler_net._target_``: UNetSmall
(VARSampler, T=10) or the DDGAN generator NCSN++ (DDGANSampler, T=4,
``configs/cifar10/T4_ddgan.yaml``). ``--int8`` samples with W8A8 static
int8 convs (K8: every ResnetBlock conv, the stride-2 Downsample convs, the
Upsample convs and the attention 1x1s of UNetSmall; every ResBlock conv and
shortcut of NCSN++, whose attention 1x1s stay out of int8 as the JAX entry
keeps them) after calibrating their activation scales on two rounds of 64
full-precision trajectories from a generator seeded with ``seed + 123``, as
the JAX entry does (``generate_cifar10.py:149-187``). ``--dtype`` is the
net's compute dtype (parameters stay fp32): by default bf16 for NCSN++ and
fp32 otherwise, as in the JAX entry. GroupNorm statistics are the JAX
entry's default (two-pass fp32). ``--guidance_scale G`` samples through the
trainer's ``sample_guidance`` with the run's value (``value_<sampler>``
from the run directory), as the JAX entry does
(``generate_cifar10.py:196-231``): each step's sample moves along the
value's gradient times G times the step's sigma.

``bench_sampler`` builds ``bench.py``'s configuration of the same net (bf16,
static int8 with the attention 1x1s in bf16, the merged qkv product, the
max-free softmax, the phase upsample, ``bf16_onepass`` statistics),
calibrated as ``bench.py`` does; ``samplers.sample_many`` draws from it.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dxmi_tpu_torch.config import (instantiate, load_yaml, merge,
                                   parse_nested_args, parse_unknown_args)
from dxmi_tpu_torch.fid import runner as fid_runner
from dxmi_tpu_torch.fid import stats as stats_lib
from dxmi_tpu_torch.fid.image_dir import dir_activations
from dxmi_tpu_torch.fid.runner import FIDState
from dxmi_tpu_torch.models.unet_small import QUANT_SCALE_NAMES, UNetSmall
from dxmi_tpu_torch.runtime import select_device
from dxmi_tpu_torch.samplers.var import VARSampler
from dxmi_tpu_torch.utils.checkpoint import (load_sampler_into,
                                             load_sampler_state,
                                             load_value_state, net_kind,
                                             read_meta,
                                             resolve_run_checkpoint)
from dxmi_tpu_torch.utils.npz_stream import NpzStreamWriter
from dxmi_tpu_torch.utils.png import PNGWriter


# calibration of --int8, as the JAX entry runs it (VARSampler's defaults)
CALIB_SEED_OFFSET, CALIB_N_SAMPLE, CALIB_N_ROUNDS = 123, 64, 2
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def default_dtype(cfg: Dict[str, Any]) -> str:
    """The JAX entry's compute dtype when ``--dtype`` is not given: bf16 for
    the DDGAN family (NCSN++), fp32 otherwise."""
    return ("bf16" if net_kind(cfg["sampler_net"].get("_target_")) == "ncsnpp"
            else "fp32")


def load_sampler(cfg: Dict[str, Any],
                 state_dict: Optional[Dict[str, torch.Tensor]],
                 device: str = "cuda", seed: int = 0, int8: bool = False,
                 dtype: Optional[str] = None, **net_overrides: Any
                 ) -> nn.Module:
    """The config's sampler on ``device`` in eval mode. ``state_dict`` is
    the sampler's state dict (``log_betas`` and the activation scales of
    int8 layers may be missing: the schedule's initial sigmas stay); None
    keeps random weights drawn from ``seed``. ``dtype`` ('fp32' or 'bf16';
    None: ``default_dtype``) is the network's compute dtype; ``int8``
    builds it with ``quant_int8='static'`` (NCSN++ also with
    ``quant_skip_attn``) and calibrates it (``CALIB_*``, from a generator
    seeded with ``seed + CALIB_SEED_OFFSET``), as the JAX entry's
    ``--int8``."""
    dev = select_device(device)
    torch.manual_seed(seed)
    net_kw = dict(dtype=DTYPES[dtype or default_dtype(cfg)])
    if int8:
        net_kw["quant_int8"] = "static"
        if net_kind(cfg["sampler_net"].get("_target_")) == "ncsnpp":
            net_kw["quant_skip_attn"] = True
    net = instantiate(cfg["sampler_net"], **net_kw, **net_overrides)
    sampler = instantiate(cfg["sampler"], net=net)
    if state_dict is not None:
        load_sampler_into(sampler, state_dict, QUANT_SCALE_NAMES)
    sampler.to(dev).eval()
    if int8:
        gen = torch.Generator(device=dev).manual_seed(seed + CALIB_SEED_OFFSET)
        sampler.calibrate_quant(gen, CALIB_N_SAMPLE, CALIB_N_ROUNDS)
    return sampler


# bench.py's configuration of the CIFAR-10 net (bench.py:56-70): full width,
# bf16 compute without the fp32 softmax, static W8A8 with the attention
# 1x1s in bf16, the merged (C, 3C) qkv product, the max-free softmax, the
# phase upsample and bf16_onepass GroupNorm statistics (bench.py:43);
# calibrated on one round of 8 trajectories, sampled at batch 96
BENCH_NET = dict(ch=128, out_ch=3, ch_mult=(1, 2, 2, 2), num_res_blocks=2,
                 attn_resolutions=(16,), dropout=0.0, in_channels=3,
                 resolution=32, dtype=torch.bfloat16, softmax_f32=False,
                 quant_int8="static", quant_skip_attn=True,
                 attn_impl="einsum_merged", softmax_nomax=True,
                 up_impl="phase", gn_stats="bf16_onepass",
                 fuse_gn_conv=False)
BENCH_CALIB = dict(n_sample=8, n_rounds=1)
BENCH_CALIB_SEED = 3
BENCH_BATCH = 96


def bench_sampler(device: str = "cuda", seed: int = 0) -> VARSampler:
    """``bench.py``'s sampler (``BENCH_NET``, T = 10, ``fix_last``) with
    random weights drawn from ``seed``, calibrated as ``bench.py`` does
    (``BENCH_CALIB``, a generator seeded with ``BENCH_CALIB_SEED``), in
    eval mode on ``device``."""
    dev = select_device(device)
    torch.manual_seed(seed)
    sampler = VARSampler(UNetSmall(**BENCH_NET), n_timesteps=10,
                         sample_shape=(3, 32, 32), trainable_beta="fix_last")
    sampler.to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(BENCH_CALIB_SEED)
    sampler.calibrate_quant(gen, **BENCH_CALIB)
    return sampler


Draw = Callable[[int, torch.Generator], Dict[str, torch.Tensor]]


def iter_batches(sampler: nn.Module, n: int, batchsize: int,
                 seed: int = 0, draw: Optional[Draw] = None
                 ) -> Iterator[Dict[str, torch.Tensor]]:
    """The sampler's (VARSampler or EDMSampler) output dicts of
    ``n // batchsize`` batches, drawn from one generator seeded with
    ``seed`` on the sampler's device; ``draw(batchsize, generator)`` takes
    the place of ``sampler.sample`` when given (guided sampling)."""
    if n % batchsize:
        raise ValueError(f"n={n} is not a multiple of batchsize={batchsize}")
    device = sampler.log_betas.device
    gen = torch.Generator(device=device).manual_seed(seed)
    for _ in range(n // batchsize):
        yield (sampler.sample(batchsize, generator=gen) if draw is None
               else draw(batchsize, gen))


def guidance_draw(cfg: Dict[str, Any], sampler: nn.Module, log_dir: str,
                  which: str, scale: float, batchsize: int) -> Draw:
    """Value-guided batches as the JAX entries build them
    (``generate_cifar10.py:196-213``, ``generate_large.py:133-153``): the
    config's value with ``value_<which>`` of the run directory, the
    config's trainer bound to ``sampler`` and that value (no optimizer:
    guidance takes no step), and its ``sample_guidance`` at ``scale``."""
    device = sampler.log_betas.device
    value = instantiate(cfg["value"])
    path = resolve_run_checkpoint(log_dir, "value", which)
    value.load_state_dict(load_value_state(path))
    value.to(device).eval()
    print(f"value loaded from {path}", flush=True)
    trainer = instantiate(cfg["trainer"], batchsize=batchsize,
                          n_timesteps=cfg["sampler"]["n_timesteps"])
    trainer.sampler, trainer.value = sampler, value
    trainer.guidance_scale = scale
    print(f"value-guided sampling, scale={scale}", flush=True)
    return lambda b, gen: trainer.sample_guidance(b, generator=gen)


@torch.no_grad()
def sample_batches(sampler: VARSampler, n: int, batchsize: int,
                   seed: int = 0) -> torch.Tensor:
    """``n`` final samples (n, C, H, W) float32 on the CPU, drawn in batches
    of ``batchsize`` from one generator seeded with ``seed``."""
    return torch.cat([out["sample"].cpu()
                      for out in iter_batches(sampler, n, batchsize, seed)])


@torch.no_grad()
def stream_samples(sampler: nn.Module, n: int, batchsize: int, seed: int,
                   save_npz: Optional[str], save_dir: Optional[str] = None,
                   fid_state: Optional[FIDState] = None,
                   draw: Optional[Draw] = None
                   ) -> Tuple[int, Optional[np.ndarray]]:
    """Draw the batches of ``iter_batches``. Each batch goes as uint8 NHWC
    into ``arr_0`` of ``save_npz`` (the class labels of a class-conditional
    sampler, int64, into ``arr_1`` at the end), as PNGs
    ``0_<index>.png`` into ``save_dir`` (written on a thread pool), and, with
    ``fid_state``, through its Inception on the device as
    ``clip((x + 1) / 2, 0, 1)``. Returns the count and the pool3
    activations (None without ``fid_state``). ``draw`` goes to
    ``iter_batches``. Serves both CLIs."""
    C, H, W = sampler.sample_shape
    with contextlib.ExitStack() as stack:
        writer = (None if save_npz is None else stack.enter_context(
            NpzStreamWriter(save_npz, n, (H, W, C))))
        pngs = (None if save_dir is None
                else stack.enter_context(PNGWriter(save_dir)))
        n_done, ys, acts = 0, [], []
        for out in iter_batches(sampler, n, batchsize, seed, draw):
            x = out["sample"]
            if fid_state is not None:
                acts.append(fid_state.extract_raw(
                    ((x + 1.0) / 2.0).clamp(0.0, 1.0)).cpu().numpy())
            if writer is not None or pngs is not None:
                xu8 = to_uint8(x)
                if writer is not None:
                    writer.write(xu8)
                if pngs is not None:
                    pngs.put_batch(n_done, xu8)
            if writer is not None and out.get("y") is not None:
                ys.append(out["y"].cpu().numpy().astype(np.int64))
            n_done += x.shape[0]
        if ys:
            writer.add("arr_1", np.concatenate(ys))
    # the batches may only be queued on the card: wait for them, so that
    # the caller's clock times the generation
    if sampler.log_betas.is_cuda:
        torch.cuda.synchronize(sampler.log_betas.device)
    return n_done, (np.concatenate(acts) if acts else None)


def generate(cfg: Dict[str, Any],
             state_dict: Optional[Dict[str, torch.Tensor]], n: int,
             batchsize: int, device: str = "cuda", seed: int = 0,
             int8: bool = False, dtype: Optional[str] = None,
             **net_overrides: Any) -> torch.Tensor:
    """Build the config's sampler, load ``state_dict`` (None: random weights
    from ``seed``), calibrate it when ``int8``, and return ``n`` samples
    (n, C, H, W) float32 on the CPU. ``net_overrides`` go to the network's
    constructor (e.g. ``fuse_gn_conv=False``)."""
    sampler = load_sampler(cfg, state_dict, device, seed, int8, dtype,
                           **net_overrides)
    return sample_batches(sampler, n, batchsize, seed)


def to_uint8(x: torch.Tensor) -> np.ndarray:
    """[-1, 1] float NCHW (on any device) -> uint8 NHWC on the host."""
    x = ((x + 1.0) / 2.0).clamp(0.0, 1.0)
    return (x * 255.0 + 0.5).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--log_dir", required=True)
    p.add_argument("--sampler", "--epoch", dest="sampler", default="best",
                   choices=["best", "last"])
    p.add_argument("-n", "--n_generate", type=int, default=50000)
    p.add_argument("--batchsize", type=int, default=100)
    p.add_argument("--stat", default=None,
                   help="FID dataset statistics (.pt/.npz); default: the "
                        "first of fid/runner.py's DEFAULT_STATS on disk")
    p.add_argument("--save_dir", default=None,
                   help="PNG directory (default <log_dir>/generated_"
                        "<sampler>)")
    p.add_argument("--save_npz", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_fid", action="store_true")
    p.add_argument("--cleanup", action="store_true",
                   help="delete the PNGs after FID")
    p.add_argument("-save", "--save_images", default=None,
                   help="False deletes the PNGs after FID (== --cleanup)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--int8", action="store_true")
    p.add_argument("--dtype", default=None, choices=sorted(DTYPES))
    p.add_argument("--guidance_scale", type=float, default=None)
    args, unknown = p.parse_known_args()
    if str(args.save_images).lower() in ("false", "0", "no"):
        args.cleanup = True

    cfg = merge(load_yaml(os.path.join(args.log_dir, "config.yaml")),
                parse_nested_args(parse_unknown_args(unknown)))
    path = resolve_run_checkpoint(args.log_dir, "sampler", args.sampler)
    print(f"sampler loaded from {path}", flush=True)
    meta = read_meta(path)
    if "fid" in meta:
        print(f"checkpoint FID {meta['fid']} (epoch {meta.get('epoch')})",
              flush=True)
    t0 = time.perf_counter()
    kind = net_kind(cfg["sampler_net"].get("_target_"))
    dtype = args.dtype or default_dtype(cfg)
    if args.dtype is None and dtype != "fp32":
        print(f"{dtype} compute torso (params fp32; --dtype fp32 opts out)",
              flush=True)
    sampler = load_sampler(cfg, load_sampler_state(path, net=kind),
                           args.device, args.seed, args.int8, dtype)
    if args.int8:
        print("int8: static activation scales calibrated", flush=True)
    draw = None
    if args.guidance_scale:
        draw = guidance_draw(cfg, sampler, args.log_dir, args.sampler,
                             args.guidance_scale, args.batchsize)
    save_dir = args.save_dir or os.path.join(args.log_dir,
                                             f"generated_{args.sampler}")
    os.makedirs(save_dir, exist_ok=True)
    t1 = time.perf_counter()
    n, _ = stream_samples(sampler, args.n_generate, args.batchsize,
                          args.seed, args.save_npz, save_dir, draw=draw)
    t2 = time.perf_counter()
    print(f"generated {n} samples in {t2 - t0:.2f} s ({n / (t2 - t0):.1f} "
          "img/s, setup included)", flush=True)
    if args.save_npz:
        print(f"saved {args.save_npz} (streamed)", flush=True)
    print(f"wrote {n} PNGs to {save_dir}", flush=True)

    if args.eval_fid or args.stat:
        w = fid_runner._find(fid_runner.DEFAULT_WEIGHTS)
        s = args.stat or fid_runner._find(fid_runner.DEFAULT_STATS)
        if w is None or s is None:
            print("FID skipped: Inception weights / dataset stats not on "
                  "disk", flush=True)
        else:
            fid_state = fid_runner.build_fid_state(w, s, sampler.log_betas.device)
            t3 = time.perf_counter()
            acts = dir_activations(save_dir, fid_state.extract_fn,
                                   batch=args.batchsize)
            t4 = time.perf_counter()
            info: Dict[str, Any] = {}
            fid = stats_lib.frechet_distance(
                *stats_lib.activation_statistics(acts), fid_state.m2,
                fid_state.s2, info=info)
            print(f"FID: {fid}", flush=True)
            print(f"FID time: sample {t2 - t1:.3f} s, inception "
                  f"{t4 - t3:.3f} s, frechet {info['seconds']:.3f} s "
                  f"({info['route']})", flush=True)
        if args.cleanup:
            shutil.rmtree(save_dir)


if __name__ == "__main__":
    main()
