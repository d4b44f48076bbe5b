"""Config loading and ``_target_`` instantiation for the port.

``_target_`` paths of the JAX package (``dxmi_tpu.*``) and of the reference
(``models.DxMI.*``) resolve through an alias table to the port's classes,
so the repo's configs and reference run directories build port modules.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

_ALIASES: Dict[str, str] = {
    "dxmi_tpu.models.unet_small.UNetSmall":
        "dxmi_tpu_torch.models.unet_small.UNetSmall",
    "models.DxMI.unet_small.Model":
        "dxmi_tpu_torch.models.unet_small.UNetSmall",
    "dxmi_tpu.samplers.var.VARSampler":
        "dxmi_tpu_torch.samplers.var.VARSampler",
    "models.DxMI.var_sampler.VARSampler":
        "dxmi_tpu_torch.samplers.var.VARSampler",
}


def load_yaml(path: str) -> Dict[str, Any]:
    """Read a YAML config file (needs PyYAML, imported here only)."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def resolve_target(path: str) -> Callable:
    target = _ALIASES.get(path, path)
    if not target.startswith("dxmi_tpu_torch."):
        raise KeyError(f"_target_ {path!r} has no port in dxmi_tpu_torch")
    module, _, name = target.rpartition(".")
    return getattr(importlib.import_module(module), name)


def instantiate(cfg: Any, **overrides: Any) -> Any:
    """Build the object a config node names in ``_target_``; nested nodes
    with a ``_target_`` are built first, ``overrides`` win over the node."""
    if not isinstance(cfg, dict):
        return cfg
    if "_target_" not in cfg:
        return {k: instantiate(v) for k, v in cfg.items()}
    kwargs = {k: instantiate(v) for k, v in cfg.items() if k != "_target_"}
    kwargs.update(overrides)
    return resolve_target(cfg["_target_"])(**kwargs)
