"""Run-directory checkpoints in the reference's PyTorch format.

The run directory holds ``config.yaml``, ``sampler_{best,last}.pth`` and
``value_{best,last}.pth``; ``resolve_run_checkpoint`` looks a checkpoint up in
the JAX package's order, which puts flax msgpack files first (loading those
is not ported yet).
``save_run_checkpoint`` writes the ``{'state_dict': ...}`` files that the
reference and ``load_sampler_state`` / ``load_value_state`` read; the full
train state (optimizers, resume) is not ported yet.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch


def resolve_run_checkpoint(log_dir: str, name: str, which: str) -> str:
    """The first of ``{name}_{which}.msgpack``, ``{name}.msgpack``,
    ``{name}_{which}.pth``, ``{name}.pth``, ``{name}_{which}.pt`` and
    ``{name}.pt`` that exists, the order of the JAX package's
    ``resolve_run_checkpoint``. The port cannot read msgpack yet, so a
    msgpack file that ranks first raises, naming it, rather than resolving
    to another checkpoint than the JAX entries would."""
    names = (f"{name}_{which}.msgpack", f"{name}.msgpack",
             f"{name}_{which}.pth", f"{name}.pth", f"{name}_{which}.pt",
             f"{name}.pt")
    for cand in names:
        path = os.path.join(log_dir, cand)
        if not os.path.exists(path):
            continue
        if cand.endswith(".msgpack"):
            raise NotImplementedError(
                f"{path}: msgpack checkpoints are not readable by the port "
                "yet (the JAX entries would load this file)")
        return path
    raise FileNotFoundError(f"no {name} checkpoint in {log_dir} (tried "
                            f"{', '.join(names)})")


def _state_dict_of(path: str) -> Dict[str, torch.Tensor]:
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for container in ("state_dict", "model", "ema"):
        if container in ckpt and isinstance(ckpt[container], dict):
            return ckpt[container]
    return ckpt


def load_value_state(path: str) -> Dict[str, torch.Tensor]:
    """A reference value checkpoint (``TimeIndependentValue`` state dict,
    keys ``net.*``) as a state dict of the port's ``TimeIndependentValue``;
    containers and ``module.`` prefixes are unwrapped."""
    return {k.replace("module.", ""): v
            for k, v in _state_dict_of(path).items()}


def save_run_checkpoint(log_dir: str, which: str, sampler, value,
                        meta: Optional[Dict] = None) -> None:
    """Write ``sampler_{which}.pth`` (the network's keys without the
    ``net.`` prefix, and ``log_betas``, as the reference's sampler files) and
    ``value_{which}.pth`` (the value's own keys): fp32 tensors on the CPU
    under ``state_dict``, with ``meta``'s entries beside it."""
    os.makedirs(log_dir, exist_ok=True)
    sampler_sd = {k[4:] if k.startswith("net.") else k: v
                  for k, v in sampler.state_dict().items()}
    for name, sd in (("sampler", sampler_sd), ("value", value.state_dict())):
        sd = {k: v.detach().float().cpu() for k, v in sd.items()}
        torch.save({"state_dict": sd, **(meta or {})},
                   os.path.join(log_dir, f"{name}_{which}.pth"))


def load_sampler_state(path: str) -> Dict[str, torch.Tensor]:
    """A reference sampler checkpoint as a state dict of the port's
    ``VARSampler``: network weights under ``net.``, plus ``log_betas`` when
    the file has them. Container keys (``state_dict``/``model``/``ema``) and
    ``module.`` prefixes are unwrapped; the reference's ``std`` buffer is
    dropped (the port pins the last sigma itself)."""
    out = {}
    for key, val in _state_dict_of(path).items():
        key = key.replace("module.", "")
        if key == "std":
            continue
        out[key if key == "log_betas" else f"net.{key}"] = val
    return out


def load_sampler_into(sampler: torch.nn.Module, state: Dict[str, torch.Tensor],
                      optional_suffixes: Tuple[str, ...] = ()) -> None:
    """Load a sampler state dict, allowing only ``log_betas`` (the schedule's
    initial sigmas stay) and keys ending in ``optional_suffixes`` (the int8
    scale buffers, calibrated later) to be missing; any other missing or
    unexpected key raises ``KeyError``, as the JAX entries fail at their
    first forward on such a checkpoint."""
    missing, unexpected = sampler.load_state_dict(state, strict=False)
    missing = sorted(k for k in missing if k != "log_betas"
                     and not k.endswith(optional_suffixes))
    if unexpected or missing:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {sorted(unexpected)}")
