"""Run-directory checkpoints: the reference's PyTorch format and the JAX
package's flax msgpack files.

The run directory holds ``config.yaml``, ``sampler_{best,last}`` and
``value_{best,last}`` checkpoints; ``resolve_run_checkpoint`` looks one up
in the JAX package's order, which puts flax msgpack files first.
``load_sampler_state`` and ``load_value_state`` read either format: a
``.msgpack`` file through the port's own reader (``utils/msgpack.py``) and
the flax-to-port converters (``utils/convert.py``), in every layout that
the JAX package's ``load_sampler_params`` accepts; a ``.pth``/``.pt`` file
through ``torch.load``. ``save_run_checkpoint`` writes the
``{'state_dict': ...}`` files of the reference. ``save_train_state`` and
``load_module_state`` reads a value or energy file of either package into
a given net (the JAX files keep spectral-norm ``sn_stats`` beside
``params``). ``save_train_state`` and
``load_train_state`` write and read the full train state (parameters,
optimizer states, ``betas_for_q``) in the JAX package's
``train_state.msgpack`` layout (``utils/train_state.py``), so that a run
resumes in either package from the other's file.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dxmi_tpu_torch.utils import convert, msgpack
from dxmi_tpu_torch.utils.train_state import trainer_slots

TRAIN_STATE = "train_state.msgpack"


def resolve_run_checkpoint(log_dir: str, name: str, which: str) -> str:
    """The first of ``{name}_{which}.msgpack``, ``{name}.msgpack``,
    ``{name}_{which}.pth``, ``{name}.pth``, ``{name}_{which}.pt`` and
    ``{name}.pt`` that exists, the order of the JAX package's
    ``resolve_run_checkpoint``."""
    names = (f"{name}_{which}.msgpack", f"{name}.msgpack",
             f"{name}_{which}.pth", f"{name}.pth", f"{name}_{which}.pt",
             f"{name}.pt")
    for cand in names:
        path = os.path.join(log_dir, cand)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no {name} checkpoint in {log_dir} (tried "
                            f"{', '.join(names)})")


def load_flax_checkpoint(path: str) -> Any:
    """A flax msgpack file (``save_checkpoint``'s ``{'params', 'meta'}``
    payload, or any tree ``msgpack_serialize`` wrote) as a tree of dicts,
    lists, scalars and numpy arrays."""
    return msgpack.read(path)


# the converters of a net's flax params and of a sampler's
# ``{'net', 'log_betas'}`` params, by net
_FLAX_NETS = {
    "unet_small": (convert.unet_small_from_flax,
                   convert.var_sampler_from_flax),
    "unet_adm": (convert.unet_adm_from_flax, convert.edm_sampler_from_flax),
    "ncsnpp": (convert.ncsnpp_from_flax, convert.ddgan_sampler_from_flax),
}


def net_kind(target: str) -> str:
    """The network a CIFAR-10 config's ``sampler_net._target_`` names, as
    the JAX entries tell them apart: ``ncsnpp`` (the DDGAN generator) when
    the path mentions it, else ``unet_small``."""
    return "ncsnpp" if "ncsnpp" in str(target).lower() else "unet_small"


def sampler_state_from_flax(tree: Dict[str, Any], net: str
                            ) -> Dict[str, torch.Tensor]:
    """A sampler state dict from a flax checkpoint tree in any layout of
    the JAX package's ``load_sampler_params``: a run-dir payload
    ``{'params': ..., 'meta': ...}``, a bare sampler tree ``{'net',
    'log_betas'}`` or a bare net tree (then ``log_betas`` is left out, and
    the sampler keeps its own, as JAX keeps ``current``'s). ``net`` names the
    network: ``unet_small`` (VARSampler), ``unet_adm`` (EDMSampler) or
    ``ncsnpp`` (DDGANSampler)."""
    net_fn, sampler_fn = _FLAX_NETS[net]
    tree = tree.get("params", tree)
    if "net" not in tree:
        return {f"net.{k}": v for k, v in net_fn(tree).items()}
    extra = sorted(set(tree) - {"net", "log_betas"})
    if extra:
        raise KeyError(f"sampler params: unexpected entries {extra}")
    if "log_betas" in tree:
        return sampler_fn(tree)
    return {f"net.{k}": v for k, v in net_fn(tree["net"]).items()}


def _state_dict_of(path: str) -> Dict[str, torch.Tensor]:
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for container in ("state_dict", "model", "ema"):
        if container in ckpt and isinstance(ckpt[container], dict):
            return ckpt[container]
    return ckpt


def read_meta(path: str) -> Dict[str, Any]:
    """The metadata of a run-directory checkpoint: a ``.msgpack`` payload's
    ``meta``, or the entries a ``.pth``/``.pt`` file holds beside its
    weights (``save_run_checkpoint``'s ``fid``, ``epoch``, ...)."""
    if path.endswith(".msgpack"):
        tree = load_flax_checkpoint(path)
        return dict(tree.get("meta", {})) if isinstance(tree, dict) else {}
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in ckpt.items()
            if k not in ("state_dict", "model", "ema")
            and not isinstance(v, (dict, torch.Tensor))}


def load_value_state(path: str) -> Dict[str, torch.Tensor]:
    """A value checkpoint as a state dict of the port's
    ``TimeIndependentValue``: a flax msgpack file (``{'params': {'net':
    ...}}`` or ``{'net': ...}``, an IGEBM encoder's or a Wide-ResNet's)
    through ``value_from_flax``, or a ``value.pth`` of the reference or of
    the port (keys ``net.*``), containers and ``module.`` prefixes
    unwrapped."""
    if path.endswith(".msgpack"):
        return convert.value_from_flax(load_flax_checkpoint(path))
    return {k.replace("module.", ""): v
            for k, v in _state_dict_of(path).items()}


def load_module_state(path: str, module: torch.nn.Module
                      ) -> Dict[str, torch.Tensor]:
    """A state dict of ``module`` from a run-directory file of either
    package: a ``.msgpack`` payload (``{'params'[, 'sn_stats'], 'meta'}``,
    the spectral-norm statistics beside the parameters, as the JAX
    package's ``save_run_checkpoint`` writes the value and energy files)
    through ``convert.module_from_flax``, or a ``.pth`` state dict."""
    if path.endswith(".msgpack"):
        tree = load_flax_checkpoint(path)
        return convert.module_from_flax(module, tree.get("params", tree),
                                        tree.get("sn_stats"))
    return _state_dict_of(path)


def save_run_checkpoint(log_dir: str, which: str, sampler, value,
                        meta: Optional[Dict] = None, energy=None) -> None:
    """Write ``sampler_{which}.pth`` (the network's keys without the
    ``net.`` prefix, and ``log_betas``, as the reference's sampler files),
    ``value_{which}.pth`` (the value's own keys) and, with an ``energy``
    net, ``energy_{which}.pth``: fp32 tensors on the CPU under
    ``state_dict`` (spectral-norm buffers included), with ``meta``'s
    entries beside it."""
    os.makedirs(log_dir, exist_ok=True)
    sampler_sd = {k[4:] if k.startswith("net.") else k: v
                  for k, v in sampler.state_dict().items()}
    files = [("sampler", sampler_sd), ("value", value.state_dict())]
    if energy is not None:
        files.append(("energy", energy.state_dict()))
    for name, sd in files:
        sd = {k: v.detach().float().cpu() for k, v in sd.items()}
        torch.save({"state_dict": sd, **(meta or {})},
                   os.path.join(log_dir, f"{name}_{which}.pth"))


def load_sampler_state(path: str, net: Optional[str] = None
                       ) -> Dict[str, torch.Tensor]:
    """A sampler checkpoint as a state dict of the port's sampler: network
    weights under ``net.``, plus ``log_betas`` when the file has them. A
    ``.msgpack`` file goes through ``sampler_state_from_flax`` with ``net``
    (``unet_small``, ``unet_adm`` or ``ncsnpp``, required for such a
    file), as the JAX
    entries load a path ending in ``.msgpack`` with ``load_sampler_params``.
    Otherwise a reference
    PyTorch checkpoint: container keys (``state_dict``/``model``/``ema``)
    and ``module.`` prefixes are unwrapped, and the reference's ``std``
    buffer is dropped (the port pins the last sigma itself)."""
    if path.endswith(".msgpack"):
        if net not in _FLAX_NETS:
            raise ValueError(f"{path}: a flax checkpoint needs net= one of "
                             f"{sorted(_FLAX_NETS)}, got {net!r}")
        return sampler_state_from_flax(load_flax_checkpoint(path), net)
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


def save_train_state(log_dir: str, trainer, *, i_iter: int, epoch: int,
                     best_fid: float = float("inf"),
                     name: str = TRAIN_STATE) -> None:
    """The JAX package's ``save_train_state`` (``checkpoint.py:147-165``):
    ``{'leaves': {'0': ..., '1': ...}, 'meta': {'i_iter', 'epoch',
    'best_fid'}}`` of ``trainer``'s state, written to ``<name>.tmp`` and then
    moved into place."""
    leaves = [slot.get() for slot in trainer_slots(trainer)]
    msgpack.write(os.path.join(log_dir, name), {
        "leaves": {str(i): a for i, a in enumerate(leaves)},
        "meta": {"i_iter": int(i_iter), "epoch": int(epoch),
                 "best_fid": float(best_fid)}})


def _leaf_dtype(a) -> str:
    return ("bfloat16" if isinstance(a, torch.Tensor)
            and a.dtype == torch.bfloat16 else np.asarray(a).dtype.name)


def load_train_state(log_dir: str, trainer,
                     name: str = TRAIN_STATE) -> Dict[str, Any]:
    """Restore ``trainer``'s state from a ``save_train_state`` file of
    either package and return its meta. A file whose leaf count, or any
    leaf's shape or dtype, differs from the trainer's configuration is
    refused with a ``ValueError`` naming the first leaf that differs
    (nothing is restored then)."""
    payload = msgpack.read(os.path.join(log_dir, name))
    stored = payload["leaves"]
    leaves = [stored[str(i)] for i in range(len(stored))]
    slots = trainer_slots(trainer)
    if len(leaves) != len(slots):
        raise ValueError(
            f"{name}: {len(leaves)} leaves, the trainer's configuration has "
            f"{len(slots)}: the saved state does not match it")
    for i, (slot, leaf) in enumerate(zip(slots, leaves)):
        got = (tuple(leaf.shape), _leaf_dtype(leaf))
        if got != (slot.shape, slot.dtype):
            raise ValueError(
                f"{name}: leaf {i} ({slot.name}) is {got[1]} {got[0]} in the "
                f"file, {slot.dtype} {slot.shape} in the trainer")
    for slot, leaf in zip(slots, leaves):
        slot.set(leaf)
    return dict(payload["meta"])
