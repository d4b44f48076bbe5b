"""Run-directory checkpoints in the reference's PyTorch format.

The run directory holds ``config.yaml`` and ``sampler_{best,last}.pth``
(``dxmi_tpu.utils.checkpoint.resolve_run_checkpoint`` also reads flax
msgpack files; loading those is not ported yet).
"""
from __future__ import annotations

import os
from typing import Dict

import torch


def resolve_run_checkpoint(log_dir: str, name: str, which: str) -> str:
    """``{name}_{which}.pth``, then ``{name}.pth``."""
    for cand in (f"{name}_{which}.pth", f"{name}.pth"):
        path = os.path.join(log_dir, cand)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        f"no {name} checkpoint in {log_dir} (tried {name}_{which}.pth, "
        f"{name}.pth; msgpack checkpoints are not readable by the port yet)")


def load_sampler_state(path: str) -> Dict[str, torch.Tensor]:
    """A reference sampler checkpoint as a state dict of the port's
    ``VARSampler``: network weights under ``net.``, plus ``log_betas`` when
    the file has them. Container keys (``state_dict``/``model``/``ema``) and
    ``module.`` prefixes are unwrapped; the reference's ``std`` buffer is
    dropped (the port pins the last sigma itself)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for container in ("state_dict", "model", "ema"):
        if container in ckpt and isinstance(ckpt[container], dict):
            ckpt = ckpt[container]
            break
    out = {}
    for key, val in ckpt.items():
        key = key.replace("module.", "")
        if key == "std":
            continue
        out[key if key == "log_betas" else f"net.{key}"] = val
    return out
