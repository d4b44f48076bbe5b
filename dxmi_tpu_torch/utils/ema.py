"""EMA parameter tracking and the consistency-training EMA/scale schedules
(``dxmi_tpu.utils.ema``, ``ema.py:9-42``) in PyTorch."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


@torch.no_grad()
def update_ema(ema: nn.Module, net: nn.Module, rate: float = 0.9999) -> None:
    """ema <- ema * rate + net * (1 - rate), in place, over the parameters
    of the same names (as JAX's tree map over two trees of one
    structure): a name that one module has and the other lacks raises."""
    params = dict(net.named_parameters())
    ema_params = dict(ema.named_parameters())
    if params.keys() != ema_params.keys():
        raise ValueError(f"update_ema: the parameters differ: "
                         f"{sorted(params.keys() ^ ema_params.keys())[:4]}")
    for name, e in ema_params.items():
        e.copy_(e * rate + params[name] * (1.0 - rate))


def ema_and_scales_fn(target_ema_mode: str = "fixed",
                      start_ema: float = 0.95,
                      scale_mode: str = "fixed",
                      start_scales: int = 40, end_scales: int = 40,
                      total_steps: int = 600_000,
                      distill_steps_per_iter: int = 50_000):
    """The consistency-training EMA/scale schedules (``ema.py:20-42``):
    step -> (target EMA rate, num_scales). Unlike
    ``trainers.distill.create_ema_and_scales_fn`` it has no ``progdist``
    mode and casts the scale count with ``np.int32``; the fixed modes
    return the arguments as they were given."""

    def fn(step):
        if target_ema_mode == "fixed" and scale_mode == "fixed":
            return start_ema, start_scales
        if target_ema_mode == "fixed" and scale_mode == "progressive":
            scales = np.ceil(np.sqrt(
                (step / total_steps) * ((end_scales + 1) ** 2
                                        - start_scales ** 2)
                + start_scales ** 2) - 1).astype(np.int32)
            scales = np.maximum(scales, 1) + 1
            return start_ema, int(scales)
        if target_ema_mode == "adaptive" and scale_mode == "progressive":
            scales = np.ceil(np.sqrt(
                (step / total_steps) * ((end_scales + 1) ** 2
                                        - start_scales ** 2)
                + start_scales ** 2) - 1).astype(np.int32)
            scales = np.maximum(scales, 1)
            c = -np.log(start_ema) * start_scales
            return float(np.exp(-c / scales)), int(scales) + 1
        raise NotImplementedError((target_ema_mode, scale_mode))

    return fn
