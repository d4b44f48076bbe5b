"""The loop that the three pretraining entries share (``pretrain_ddpm``,
``pretrain_ddgan``, ``pretrain_edm``; ``scripts/pretrain_*.py``): Adam on
the sampler's net (``adam_step``), one batch of indices a step from
``np.random.RandomState(seed)`` (bit-equal to the JAX scripts' batches) and
the JAX script's line every ``log_every`` steps and at the last (``run``).
Each entry then writes the JAX package's checkpoint payload
(``utils/checkpoint.save_checkpoint``: ``{'params', 'meta':
{'pretrain_steps': N}}``).

After the run it prints one line of its own: the first step's seconds, the
seconds per step after it, the peak memory allocated on the card and the
kernels' launches (``ops/_lib.LAUNCHES``, as JSON) over the run.
"""
from __future__ import annotations

import json
import time
from typing import Callable

import numpy as np
import torch

from dxmi_tpu_torch.ops import _lib
from dxmi_tpu_torch.trainers.optim import Adam


def adam_step(opt: Adam, loss: torch.Tensor) -> None:
    """One optax-style Adam update of ``opt.params`` down ``loss``."""
    opt.step(torch.autograd.grad(loss, opt.params))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(step: Callable[[np.ndarray], torch.Tensor], n_data: int, batch: int,
        steps: int, seed: int, log_every: int,
        line: Callable[[int, float], str], device: torch.device) -> None:
    """``steps`` calls of ``step(idx)`` (it updates the parameters and
    returns the loss) on batches of data indices drawn as the JAX scripts
    draw them; prints ``line(it, loss)`` on the logged steps."""
    rng = np.random.RandomState(seed)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _lib.reset_launches()
    t0 = time.perf_counter()
    t1 = None
    for it in range(steps):
        loss = step(rng.randint(0, n_data, batch))
        if it % log_every == 0 or it == steps - 1:
            print(line(it, float(loss)), flush=True)
        if it == 0:
            _sync(device)
            t1 = time.perf_counter()
    _sync(device)
    t2 = time.perf_counter()
    rate = ((t2 - t1) / (steps - 1) if steps > 1 else float("nan"))
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else 0.0)
    print(f"pretrain timing: first step {t1 - t0:.3f} s, {rate:.4f} s/step "
          f"over steps 1-{steps - 1}; peak allocated {peak:.2f} GiB; kernel "
          f"launches over {steps} steps {json.dumps(dict(_lib.LAUNCHES))}",
          flush=True)


def to_device(images: np.ndarray, device: torch.device) -> torch.Tensor:
    """NHWC float images -> NCHW fp32 on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(
        images.transpose(0, 3, 1, 2), np.float32)).to(device)
