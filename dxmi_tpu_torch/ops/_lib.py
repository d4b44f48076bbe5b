"""Build, load and count the port's hand-written CUDA kernels.

All kernel sources (``dxmi_tpu_torch/csrc/*.cu``) have a plain C interface.
One ``nvcc`` call per source compiles them for ``sm_90a`` (all started
together) and one more links them into
``build/dxmi_tpu_torch/libkernels.so`` at the repository root on first use,
and ``ctypes`` binds the entry points. Every pointer and the stream travel
as ``c_void_p`` (a plain int argument would be cut to 32 bits); every entry
point returns ``cudaGetLastError()`` after its launches, and ``check``
raises on a non-zero code.

Each wrapper adds one to its entry in ``LAUNCHES`` per call that launches
its kernel on the card; the CPU path (the plain version) does not count.
"""
from __future__ import annotations

import collections
import ctypes
import os
import pathlib
import subprocess
import threading
from typing import List, Optional

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "dxmi_tpu_torch"
LIB_PATH = BUILD_DIR / "libkernels.so"
NVCC_TIMEOUT_S = 300

LAUNCHES: "collections.Counter[str]" = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# entry point -> argument types (all return int, the CUDA error code)
_SIGNATURES = {
    # x, scale, bias, y, mean_c, rstd_c, B, HW, C, G, eps, silu, is_bf16,
    # onepass, stream
    "dxmi_gn_forward": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                        _I, _P],
    # HW, C, G, element bytes, out int[3]: K1's route (on-chip, slabs, CTAs
    # a cluster)
    "dxmi_gn_plan": [_I, _I, _I, _I, ctypes.POINTER(_I)],
    # x, gn_scale, gn_bias, w(9,Cin,Cout) bf16, bias, y, mean_c, rstd_c,
    # partials scratch (or null), B, H, W, Cin, Cout, G, eps, slices,
    # is_bf16 (x and y bf16), stream
    "dxmi_gn_silu_conv3x3": [_P] * 9 + [_I, _I, _I, _I, _I, _I, _F, _I, _I,
                                        _P],
    # B, H, W, Cin, Cout, out int[3]: K3's plan (chunk channels, positions
    # a tile, slices)
    "dxmi_conv_plan": [_I, _I, _I, _I, _I, ctypes.POINTER(_I)],
    # x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj, y, mean_c, rstd_c,
    # qkv scratch, attn scratch, B, S, C, nh, G, eps, stream
    "dxmi_attn_block": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _F, _P],
    # the same arguments, bf16 tensors (GN parameters and statistics fp32)
    "dxmi_attn_block_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _F, _P],
    # x, gn_scale, gn_bias, w_qkv, b_qkv, w_proj, b_proj, y, stats scratch
    # (B, 2, C), qkv scratch, attn scratch, B, S, C, nh, G, bb, eps, stream
    # (fp32; bf16)
    "dxmi_attn_block_bb": [_P] * 11 + [_I, _I, _I, _I, _I, _I, _F, _P],
    "dxmi_attn_block_bb_bf16": [_P] * 11 + [_I, _I, _I, _I, _I, _I, _F, _P],
    # qkv, attn, B, S, C, nh, stream: the wide attention core alone
    "dxmi_attn_core_wide": [_P, _P, _I, _I, _I, _I, _P],
    # q, k, v, o, lse (or null), B, S, nh, d, row_stride, out_row_stride,
    # sm_scale, stream
    "dxmi_flash_attn": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # qkv, o, dout, lse, di scratch, dqkv, B, S, nh, d, sm_scale, stream
    "dxmi_flash_attn_bwd_dkv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                _P],
    # qkv, dout, lse, di, dqkv, B, S, nh, d, sm_scale, stream
    "dxmi_flash_attn_bwd_dq": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # x, ct, gs, gb, w_qkv, b_qkv, w_proj, dx, dgs, dgb, dw_qkv, db_qkv,
    # dw_proj, db_proj, then scratch mean_c, rstd_c, h, qkv, da, a, lse, di,
    # dqkv_f, dqkv_t, dh, part; B, S, C, nh, G, eps, splits, chunks, stream
    "dxmi_attn_block_bwd": [_P] * 26 + [_I, _I, _I, _I, _I, _F, _I, _I, _P],
    "dxmi_attn_block_bwd_bf16": [_P] * 26 + [_I, _I, _I, _I, _I, _F, _I, _I,
                                             _P],
    # K6 fp32 at small maps: x, ct, gs, gb, w_qkv, b_qkv, w_proj, dx, the
    # parameter cotangents (one buffer), the samples' partials; B, S, C, nh,
    # G, eps, stream
    "dxmi_attn_block_bwd_small": [_P] * 10 + [_I, _I, _I, _I, _I, _F, _P],
    # x, is_bf16, gs, gb, wq, swq, isa_q, bq, wp, swp, isa_p, bp, y, mean_c,
    # rstd_c, qkv scratch, attn scratch, B, S, C, nh, G, eps, stream
    "dxmi_attn_block_i8": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # x, x_bf16, xs, divide, w, dq, bias (or null), y, y_bf16, B, H, W, Cin,
    # Cout, kh, kw, pad_top, pad_left, stream
    "dxmi_int8_conv": [_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _I, _I, _I, _P],
    # the same at stride 2, then pad_bottom, pad_right, stream
    "dxmi_int8_conv_s2": [_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def compile_command(src: pathlib.Path, obj: pathlib.Path,
                    verbose: bool = False) -> List[str]:
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xcompiler", "-fPIC", f"-I{CSRC}", "-c", "-o", str(obj)]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    return cmd + [str(src)]


def build(verbose: bool = False) -> subprocess.CompletedProcess:
    """Compile every kernel source, one nvcc process each, all started
    together, then link them into ``LIB_PATH``; each process is bounded by
    ``NVCC_TIMEOUT_S``. Writes to temporary names first so that a
    concurrent loader never sees a half-written library. Returns the
    compilers' output (``-Xptxas -v`` when ``verbose``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        jobs.append((obj, subprocess.Popen(
            compile_command(src, obj, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    out, err, failed = [], [], []
    try:
        for obj, proc in jobs:
            o, e = proc.communicate(timeout=NVCC_TIMEOUT_S)
            out.append(o)
            err.append(e)
            if proc.returncode != 0:
                failed.append(obj.name)
    finally:
        for _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    objs = [str(obj) for obj, _ in jobs]
    if not failed:
        tmp = BUILD_DIR / f"libkernels.{tag}.so"
        link = subprocess.run([_nvcc(), "-gencode",
                               "arch=compute_90a,code=sm_90a", "-shared",
                               "-o", str(tmp), *objs],
                              capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S)
        out.append(link.stdout)
        err.append(link.stderr)
        if link.returncode != 0:
            failed.append("link")
        else:
            os.replace(tmp, LIB_PATH)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                           + "\n".join(out) + "\n".join(err))
    return subprocess.CompletedProcess(["nvcc"], 0, "\n".join(out),
                                       "\n".join(err))


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(s.stat().st_mtime > built for s in CSRC.iterdir())


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or older than a
    source."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            handle = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def require(t: torch.Tensor, name: str, shape, dtype=torch.float32,
            device: Optional[torch.device] = None) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned CUDA tensor of the
    given shape and dtype (on ``device`` when given): the kernels load 16
    bytes at a time."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def reset_launches() -> None:
    LAUNCHES.clear()
