#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dxmi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc. It
needs torch and numpy only (no JAX, YAML or msgpack). Phases, each printed
with its seconds; any failure exits non-zero naming the phase:

  B  build every kernel from dxmi_tpu_torch/csrc with one bounded nvcc call
     and print -Xptxas -v (registers, shared memory, spills);
  K  hold each kernel against its plain PyTorch version at the full-width
     CIFAR-10 shapes;
  T  time each kernel, its plain version and one PyTorch library call with
     CUDA events;
  G  replay the trained reference fixture (tests/fixtures/torch_rundir_t10)
     with its injected noise through the kernels, unfused and fused;
  E  generate 2 batches of 100 CIFAR-10 samples at T=10 at the full width of
     configs/cifar10/T10.yaml with seeded random weights, and check that the
     main path launched each kernel the expected number of times.

The line before the last line is the card's name and power limit from
nvidia-smi, the one before it the kernels' JSON record, and the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import faulthandler
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

from dxmi_tpu_torch.generate_cifar10 import (generate, load_sampler,
                                             sample_batches)
from dxmi_tpu_torch.ops import _lib
from dxmi_tpu_torch.ops.attn_block import attn_block, attn_block_reference
from dxmi_tpu_torch.ops.conv_fused import gn_silu_conv, gn_silu_conv_reference
from dxmi_tpu_torch.ops.groupnorm import group_norm, group_norm_silu_reference
from dxmi_tpu_torch.runtime import select_device
from dxmi_tpu_torch.utils.checkpoint import load_sampler_state

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(REPO, "tests", "fixtures", "torch_rundir_t10")
WATCHDOG_S = 1100

# tests/fixtures/torch_rundir_t10/config.yaml as PyYAML reads it (the card
# needs no YAML; tests/test_torch_imports.py holds the two equal).
FIXTURE_CONFIG = {
    "sampler_net": {"_target_": "models.DxMI.unet_small.Model",
                    "resolution": 16, "in_channels": 3, "out_ch": 3,
                    "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
                    "attn_resolutions": [8], "dropout": 0.1},
    "sampler": {"_target_": "models.DxMI.var_sampler.VARSampler",
                "n_timesteps": 10, "sample_shape": [3, 16, 16],
                "trainable_beta": "fix_last"},
    "energy": None,
    "value": {"_target_": "models.value.TimeIndependentValue",
              "net": {"_target_": "models.modules.IGEBMEncoderV2",
                      "in_chan": 3, "out_chan": 1, "use_spectral_norm": False,
                      "keepdim": False, "out_activation": "linear",
                      "avg_pool_dim": 1, "learn_out_scale": True, "nh": 32}},
    "trainer": {"_target_": "models.DxMI.trainer.DxMI_Trainer", "tau1": 0.1,
                "tau2": 0.01, "gamma": 1, "use_sampler_beta": True,
                "time_cost": 0, "adavelreg": 0.99, "entropy_in_value": None,
                "velocity_in_value": None, "time_cost_sig": True},
    "training": {"batchsize": 32, "lr": "1e-4", "v_lr": "1e-4",
                 "beta_lr": "1e-3", "seed": 7},
    "data": {"name": "cifar10"},
}

# The generation half of configs/cifar10/T10.yaml (full width).
CIFAR10_T10 = {
    "sampler_net": {"_target_": "dxmi_tpu.models.unet_small.UNetSmall",
                    "resolution": 32, "in_channels": 3, "out_ch": 3,
                    "ch": 128, "ch_mult": [1, 2, 2, 2], "num_res_blocks": 2,
                    "attn_resolutions": [16], "dropout": 0.1},
    "sampler": {"_target_": "dxmi_tpu.samplers.var.VARSampler",
                "n_timesteps": 10, "sample_shape": [3, 32, 32],
                "trainable_beta": "fix_last"},
}
BATCH, N_BATCHES, T = 100, 2, 10

# Kernel launches per UNetSmall forward at that config (fuse_gn_conv=True,
# attn_impl='fused'): K1 = norm_out + the 4x4 mid block's norm, K3 = conv1
# and conv2 of 22 ResnetBlocks, K2 = the 5 attention blocks at 16x16.
LAUNCHES_PER_FORWARD = {"gn_silu": 2, "gn_silu_conv3x3": 44, "attn_block": 5}

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate, fp32 outside the
# tensor cores, bf16 tensor cores.
HBM_BYTES_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

# Stated tolerances |kernel - plain| <= ATOL + RTOL * |plain|. K1 and K2 are
# fp32 with another summation order (the JAX package's fp32 kernel test
# holds 2e-5). K3 rounds its conv operands to bf16 like its plain version,
# but one fp32 ulp of difference in GN+SiLU can move an operand across a
# bf16 rounding boundary, and each such flip moves one product by
# 2^-8 |w h|; with |w h| up to ~0.5 at these inputs, a few flips in one
# output reach ~2e-3 (1.8e-3 measured on the H100). A wrong tap, channel
# or border moves outputs by 1e-1 or more.
TOL = {"gn_silu": (2e-5, 2e-5), "gn_silu_conv3x3": (5e-3, 5e-3),
       "attn_block": (2e-5, 2e-5)}
# Fixture replay: per-step mean against golden.npz. Unfused (K1, K2) at the
# JAX golden test's 5e-4; fused (K3's bf16 operands) at 2e-2, about three
# times the 6.2e-3 that the same bf16 arithmetic shows on the CPU.
REPLAY_TOL = {False: 5e-4, True: 2e-2}

INFO = {
    "gn_silu": ("dxmi_tpu_torch/csrc/groupnorm.cu",
                "dxmi_tpu/ops/groupnorm.py:157"),
    "gn_silu_conv3x3": ("dxmi_tpu_torch/csrc/conv_fused.cu",
                        "dxmi_tpu/ops/conv_fused.py:36"),
    "attn_block": ("dxmi_tpu_torch/csrc/attn_block.cu",
                   "dxmi_tpu/ops/attn_block.py:225"),
}


class PhaseError(Exception):
    pass


def run_phase(name, fn):
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    except Exception as e:
        traceback.print_exc()
        raise PhaseError(f"phase {name} failed: {e}") from e
    print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def randn(gen, *shape, scale=1.0, shift=0.0):
    return torch.randn(shape, generator=gen, device="cuda") * scale + shift


def max_err(a, b, name):
    atol, rtol = TOL[name]
    err = (a - b).abs()
    bad = err > atol + rtol * b.abs()
    if not torch.isfinite(a).all() or bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max "
                             f"abs err {err.max().item():.3e}")
    return err.max().item()


# ---- the kernels' cases at the main path's shapes ----------------------

def gn_case(gen, B, HW, C, silu):
    x = randn(gen, B, HW, C, scale=2.0, shift=0.5)
    return (x, randn(gen, C, scale=0.1, shift=1.0), randn(gen, C, scale=0.1),
            32, 1e-6, silu)


def conv_case(gen, B, R, Cin, Cout):
    return (randn(gen, B, R, R, Cin, scale=2.0, shift=0.5),
            randn(gen, Cin, scale=0.1, shift=1.0), randn(gen, Cin, scale=0.1),
            randn(gen, 3, 3, Cin, Cout, scale=(9 * Cin) ** -0.5),
            randn(gen, Cout, scale=0.1), 32, 1e-6)


def attn_case(gen, B, S, C):
    return (randn(gen, B, S, C, scale=2.0, shift=0.5),
            randn(gen, C, scale=0.1, shift=1.0), randn(gen, C, scale=0.1),
            randn(gen, C, 3 * C, scale=C ** -0.5), randn(gen, 3 * C, scale=0.1),
            randn(gen, C, C, scale=C ** -0.5), randn(gen, C, scale=0.1))


# GroupNorm inputs of K1 and K3 on the main path: norm_out (32x32, C=128,
# SiLU) and the mid attention norm (4x4, C=256); every (res, Cin, Cout) of
# the 22 ResnetBlocks' convs; the 16x16 attention blocks.
GN_SHAPES = [(BATCH, 1024, 128, True), (BATCH, 16, 256, False)]
CONV_SHAPES = [(BATCH, 32, 128, 128), (BATCH, 32, 384, 128),
               (BATCH, 32, 256, 128), (BATCH, 16, 128, 256),
               (BATCH, 16, 256, 256), (BATCH, 16, 512, 256),
               (BATCH, 16, 384, 256), (BATCH, 8, 256, 256),
               (BATCH, 8, 512, 256), (BATCH, 4, 256, 256),
               (BATCH, 4, 512, 256)]
ATTN_SHAPES = [(BATCH, 256, 256)]


def phase_build():
    proc = _lib.build(verbose=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry",
                                   "smem", "warning", "error")):
            print("  ptxas:", line.strip())
    _lib.lib()


def phase_kernels(gen):
    errs = {}
    errs["gn_silu"] = max(
        max_err(group_norm(*a), group_norm_silu_reference(*a), "gn_silu")
        for a in (gn_case(gen, *s) for s in GN_SHAPES))
    errs["gn_silu_conv3x3"] = max(
        max_err(gn_silu_conv(*a), gn_silu_conv_reference(*a),
                "gn_silu_conv3x3")
        for a in (conv_case(gen, *s) for s in CONV_SHAPES))
    errs["attn_block"] = max(
        max_err(attn_block(*a, num_heads=1, eps=1e-6),
                attn_block_reference(*a, num_heads=1, eps=1e-6), "attn_block")
        for a in (attn_case(gen, *s) for s in ATTN_SHAPES))
    for k, v in errs.items():
        print(f"  K {k}: max abs err vs plain {v:.3e} "
              f"(tol {TOL[k][0]:g} + {TOL[k][1]:g}*|plain|)")
    return errs


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_times(gen):
    """ms, plain_ms, library_ms and bound_ms of each kernel at its widest
    main-path shape; inputs of K1 and K3 (52 MB each) exceed the 50 MB L2."""
    rows = {}

    B, HW, C, silu = GN_SHAPES[0]
    a = gn_case(gen, B, HW, C, silu)
    x_nchw = a[0].reshape(B, 32, 32, C).permute(0, 3, 1, 2)
    n = B * HW * C
    rows["gn_silu"] = dict(
        ms=time_ms(lambda: group_norm(*a)),
        plain_ms=time_ms(lambda: group_norm_silu_reference(*a)),
        library_ms=time_ms(lambda: F.silu(F.group_norm(x_nchw, 32, a[1], a[2],
                                                       1e-6))),
        # one fp32 read and one write; ~7 flops of GN and 4 of SiLU each
        bytes=2 * n * 4 + 2 * C * 4, ops={"fp32": 11 * n})

    B, R, Cin, Cout = CONV_SHAPES[0]
    a = conv_case(gen, B, R, Cin, Cout)
    x_nchw = a[0].permute(0, 3, 1, 2)
    w_lib = a[3].permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    b_lib = a[4].to(torch.bfloat16)
    M = B * R * R
    rows["gn_silu_conv3x3"] = dict(
        ms=time_ms(lambda: gn_silu_conv(*a)),
        plain_ms=time_ms(lambda: gn_silu_conv_reference(*a)),
        library_ms=time_ms(lambda: F.conv2d(
            F.silu(F.group_norm(x_nchw, 32, a[1], a[2], 1e-6)).bfloat16(),
            w_lib, b_lib, padding=1)),
        bytes=(M * Cin + 9 * Cin * Cout + M * Cout + 2 * Cin + Cout) * 4,
        ops={"bf16": 2 * M * Cout * 9 * Cin, "fp32": 11 * M * Cin})

    B, S, C = ATTN_SHAPES[0]
    a = attn_case(gen, B, S, C)
    x, gs, gb, wqkv, bqkv, wp, bp = a

    def library_attn():
        g = F.group_norm(x.transpose(1, 2), 32, gs, gb, 1e-6).transpose(1, 2)
        q, k, v = (g @ wqkv + bqkv).split(C, dim=-1)
        o = F.scaled_dot_product_attention(q, k, v)
        return x + o @ wp + bp

    rows["attn_block"] = dict(
        ms=time_ms(lambda: attn_block(*a, num_heads=1, eps=1e-6)),
        plain_ms=time_ms(lambda: attn_block_reference(*a, num_heads=1,
                                                      eps=1e-6)),
        library_ms=time_ms(library_attn),
        bytes=(2 * B * S * C + 4 * C * C + 5 * C) * 4,
        # qkv, logits, AV and proj products; ~5 flops of softmax per logit
        ops={"fp32": 2 * B * S * C * 3 * C + 4 * B * S * S * C
             + 2 * B * S * C * C + 5 * B * S * S})

    peaks = {"fp32": FP32_FLOPS, "bf16": BF16_FLOPS}
    for name, r in rows.items():
        t_bytes = r["bytes"] / HBM_BYTES_S * 1e3
        t_ops = sum(v / peaks[k] for k, v in r.pop("ops").items()) * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"  T {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}"
              f" ms, library {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}: bytes "
              f"{t_bytes:.4f} ms, ops {t_ops:.4f} ms)")
    return rows


def phase_replay():
    golden = np.load(os.path.join(FIXTURE_DIR, "golden.npz"))
    state = load_sampler_state(os.path.join(FIXTURE_DIR, "sampler_best.pth"))
    errs = {}
    for fuse in (False, True):
        _lib.reset_launches()
        sampler = load_sampler(FIXTURE_CONFIG, state, "cuda",
                               fuse_gn_conv=fuse)
        x = torch.from_numpy(golden["x0"]).cuda()
        worst = 0.0
        with torch.no_grad():
            for t in range(sampler.n_timesteps):
                out = sampler.sample_step(
                    x, t, noise=torch.from_numpy(golden["eps"][t]).cuda())
                ref_mean = golden["means"][t]
                err = float(np.abs(out["mean"].cpu().numpy() - ref_mean).max())
                worst = max(worst, err)
                if err > REPLAY_TOL[fuse]:
                    raise AssertionError(f"fuse_gn_conv={fuse} step {t}: "
                                         f"mean err {err:.3e}")
                np.testing.assert_allclose(
                    out["sigma"].cpu().numpy().reshape(-1, 1, 1, 1),
                    golden["sigmas"][t], rtol=1e-5, atol=1e-7)
                x = torch.from_numpy(ref_mean + golden["sigmas"][t]
                                     * golden["eps"][t]).cuda()
        used = {k for k, v in _lib.LAUNCHES.items() if v}
        want = {"gn_silu", "attn_block"} | ({"gn_silu_conv3x3"} if fuse
                                            else set())
        if used != want:
            raise AssertionError(f"fuse_gn_conv={fuse}: launched {used}, "
                                 f"expected {want}")
        errs[fuse] = worst
        print(f"  G fuse_gn_conv={fuse}: max per-step mean err {worst:.3e} "
              f"(tol {REPLAY_TOL[fuse]:g}), kernels {sorted(used)}")
    return errs


def phase_generate():
    # warm-up outside the counted run (cuDNN plans, allocator)
    generate(CIFAR10_T10, None, BATCH, BATCH, "cuda", seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    t0 = time.perf_counter()
    x = generate(CIFAR10_T10, None, BATCH * N_BATCHES, BATCH, "cuda", seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    if tuple(x.shape) != (BATCH * N_BATCHES, 3, 32, 32):
        raise AssertionError(f"samples of shape {tuple(x.shape)}")
    if not torch.isfinite(x).all():
        raise AssertionError("non-finite samples")
    want = {k: v * T * N_BATCHES for k, v in LAUNCHES_PER_FORWARD.items()}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    peak = torch.cuda.max_memory_allocated()

    sampler = load_sampler(CIFAR10_T10, None, "cuda", seed=0)
    sample_batches(sampler, BATCH, BATCH, seed=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample_batches(sampler, BATCH * N_BATCHES, BATCH, seed=3)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    print(f"  E launches {launches} (expected {want})")
    print(f"  E generate(): {x.shape[0]} samples in {wall:.3f} s with setup "
          f"({x.shape[0] / wall:.1f} img/s); sampling alone "
          f"{BATCH * N_BATCHES / steady:.1f} img/s; samples in "
          f"[{x.min().item():.3f}, {x.max().item():.3f}], std "
          f"{x.std().item():.3f}; peak allocated {peak / 2**20:.1f} MiB")
    profile_batch(sampler)
    return launches


def profile_batch(sampler):
    """Device time by kernel over one batch's trajectory (torch.profiler),
    and the device's idle share of the wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sample_batches(sampler, BATCH, BATCH, seed=4)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    total = sum(r[0] for r in rows)
    if total == 0:
        print("  E profile: device time not measured (no CUDA events)")
        return
    print(f"  E profile, one trajectory of {BATCH}: device busy {total:.2f} ms"
          f" of {wall_ms:.2f} ms wall (idle {1 - total / wall_ms:.1%})")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        print(f"    {ms:9.3f} ms {ms / total:6.1%} x{count:<5d} {key[:90]}")


def nvidia_smi():
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0].strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)
    select_device("cuda")  # fp32 products in the plain versions (no TF32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        run_phase("B", phase_build)
        errs = run_phase("K", lambda: phase_kernels(gen))
        times = run_phase("T", lambda: phase_times(gen))
        run_phase("G", phase_replay)
        launches = run_phase("E", phase_generate)
        smi = nvidia_smi()
    except PhaseError as e:
        print(str(e), file=sys.stderr, flush=True)
        return 1
    kernels = []
    for name, (src, replaces) in INFO.items():
        r = times[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
