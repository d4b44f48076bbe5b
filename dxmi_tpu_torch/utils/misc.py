"""Small helpers (``dxmi_tpu.utils.misc``, ``misc.py:12-65``): ``mkdir_p``,
``print0``, ``batch_run``, ``batch_run_grad`` and ``weight_norm``."""
from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from dxmi_tpu_torch.utils.logging import weight_norm_of


def mkdir_p(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def print0(*args, **kwargs) -> None:
    """Print (flushed) on the first process only: the one with rank 0 when
    ``torch.distributed`` is initialised, else this one."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_rank() == 0:
        print(*args, **kwargs, flush=True)


def _as_numpy(out):
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


def batch_run(fn: Callable, x: np.ndarray, batch_size: int = 100,
              to_numpy: bool = True, **kwargs):
    """``fn`` over ``x`` in chunks of ``batch_size``, the tail padded by
    repeating its last row so every call has one shape (and the padding's
    outputs dropped): the concatenated numpy result, or the list of
    outputs when ``to_numpy`` is False."""
    n = len(x)
    outs = []
    for i in range(0, n, batch_size):
        chunk = x[i:i + batch_size]
        pad = batch_size - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad,
                                                     axis=0)])
        out = fn(chunk, **kwargs)
        out = _as_numpy(out) if to_numpy else out
        if pad:
            out = out[:-pad]
        outs.append(out)
    return np.concatenate(outs) if to_numpy else outs


def batch_run_grad(fn: Callable, x: np.ndarray, batch_size: int = 100,
                   flatten: bool = False, **kwargs) -> np.ndarray:
    """Per-sample input-gradient norms ||d fn_i / d x_i||_2 (N,) of a
    function mapping a batch (B, ...) to per-sample scalars (B,), in
    chunks as ``batch_run``; ``fn`` gets each chunk as an fp32 CPU tensor
    (it may move it to its device: the gradient follows)."""

    def gnorm(chunk, **kw):
        if flatten:
            chunk = chunk.reshape(len(chunk), -1)
        c = torch.as_tensor(np.asarray(chunk, np.float32)).requires_grad_(
            True)
        g, = torch.autograd.grad(fn(c, **kw).sum(), c)
        return torch.sqrt((g.reshape(len(g), -1) ** 2).sum(dim=1))

    return batch_run(gnorm, x, batch_size=batch_size, **kwargs)


def weight_norm(params) -> float:
    """Global L2 norm of a module's parameters, or of a flat dict or an
    iterable of tensors or arrays (``utils.logging.weight_norm_of``)."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    elif isinstance(params, dict):
        params = params.values()
    return weight_norm_of(torch.as_tensor(p) for p in params)
