"""Experiment logging with the reference's key-suffix protocol
(``dxmi_tpu/utils/logging.py``):

  * keys ending ``_``  -> scalar (TensorBoard ``add_scalar``, wandb)
  * keys ending ``@``  -> image  (TensorBoard ``add_image``)

and the expansion of the trainers' ``per_step/*`` vectors into the
reference's per-step scalar families (``running_cost/step_{t}_``,
``value/step_{t}_``, ``sigma/sigma_{t}_``, ``adavelreg/beta{t}_``).

A ``tensorboardX`` writer is used when that package imports; wandb only
with ``--wandb`` and when it is installed (``init_wandb`` says so and goes
on without it otherwise, as the JAX package does).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch


def _np(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v)


class BaseLogger:
    def __init__(self, writer=None, use_wandb: bool = False):
        self.writer = writer
        self.wandb = None
        if use_wandb:
            try:
                import wandb
                self.wandb = wandb
            except ImportError:
                self.wandb = None

    def log(self, d_result: Dict[str, Any], i: int) -> None:
        d_wandb = {}
        for key, val in d_result.items():
            if key.endswith("_"):
                v = float(_np(val))
                if self.writer is not None:
                    self.writer.add_scalar(key, v, i)
                d_wandb[key] = v
            elif key.endswith("@"):
                img = _np(val)
                if self.writer is not None:
                    self.writer.add_image(
                        key.rstrip("@"), img, i,
                        dataformats="HWC" if img.ndim == 3 else "CHW")
        if self.wandb is not None and d_wandb:
            self.wandb.log(d_wandb, step=i)

    def flush(self) -> None:
        if self.writer is not None:
            self.writer.flush()


def init_wandb(project: str, name: str, logdir: str,
               cfg_container: Optional[dict] = None):
    """``wandb.init`` with the reference's contract (project per dataset
    and T, run name ``{model_cfg_name}_{run}``, run files under the log
    dir, the config attached). Returns the wandb module, or None after
    JAX's line when wandb is not installed."""
    try:
        import wandb
    except ImportError:
        print("wandb not installed — --wandb ignored", flush=True)
        return None
    wandb.init(project=project, name=name, dir=logdir, config=cfg_container)
    return wandb


def tensorboard_writer(logdir: str):
    """A ``tensorboardX.SummaryWriter`` on ``logdir``, or None when that
    package is not installed."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(logdir=logdir)


def expand_metrics(metrics: Dict[str, Any]) -> Dict[str, float]:
    """A trainer's metrics (scalars and ``per_step/`` vectors) as the
    reference's flat scalar key families."""
    out: Dict[str, float] = {}
    per_step = {}
    for k, v in metrics.items():
        if k.startswith("per_step/"):
            per_step[k.split("/", 1)[1]] = _np(v)
        else:
            out[k] = float(_np(v))
    t_order = per_step.get("t")
    for name, fmt in (("running_cost", "running_cost/step_{t}_"),
                      ("value", "value/step_{t}_")):
        if name in per_step:
            vec = per_step[name]
            ts = (t_order if t_order is not None
                  else np.arange(len(vec))[::-1])
            for t, val in zip(ts, vec):
                out[fmt.format(t=int(t))] = float(val)
    if "sigma" in per_step:
        for t, val in enumerate(per_step["sigma"]):
            out[f"sigma/sigma_{t}_"] = float(val)
    if "betas_for_q" in per_step:
        for t, val in enumerate(per_step["betas_for_q"]):
            out[f"adavelreg/beta{t}_"] = float(val)
    return out


def weight_norm_of(params: Iterable[torch.Tensor]) -> float:
    """The global L2 norm of a set of parameters (the reference's
    ``weight_norm/*`` families), summed on their device."""
    sums = [p.detach().float().pow(2).sum() for p in params]
    return float(torch.stack(sums).double().sum().sqrt()) if sums else 0.0


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2) -> np.ndarray:
    """(N, H, W, C) images tiled into one (H', W', C) grid on ones."""
    n, h, w, c = images.shape
    ncol = int(np.ceil(n / nrow))
    grid = np.ones((ncol * (h + pad) + pad, nrow * (w + pad) + pad, c),
                   dtype=images.dtype)
    for i in range(n):
        r, co = divmod(i, nrow)
        y = r * (h + pad) + pad
        x = co * (w + pad) + pad
        grid[y:y + h, x:x + w] = images[i]
    return grid
