"""Flax params (as numpy) -> the port's PyTorch state dicts.

``unet_small_from_flax`` and ``unet_adm_from_flax`` invert
``dxmi_tpu.utils.convert.convert_unet_small`` and ``convert_unet_adm``: flax
module names go back to the reference's dotted paths, GroupNorm
``gn/{scale,bias}`` back to ``weight``/``bias``, conv kernels (kh, kw, I, O)
back to (O, I, kh, kw), dense kernels (I, O) back to (O, I) and embedding
tables to ``weight``. ``unet_small_quant_scales_from_flax`` and
``adm_quant_scales_from_flax`` carry the JAX net's calibrated
``quant_scales`` collection into the port's scale buffers.
``ncsnpp_from_flax``, ``ncsnpp_quant_scales_from_flax`` and
``ddgan_sampler_from_flax`` carry the JAX package's own NCSN++ (which has
no reference layout) into the port's, whose names are the flax ones.
``igebm_from_flax`` and ``value_from_flax`` invert ``convert_igebm`` and
``wrap_value_params`` (``dxmi_tpu/utils/convert.py:168-275``); the port's
value state dicts are the reference ``value.pth`` layout.
``wideresnet_from_flax`` carries the JAX package's Wide-ResNet value net
(no reference layout either) into the port's, whose names are the flax
ones; ``value_from_flax`` takes either value net.
``inception_from_flax`` carries the JAX package's folded FID Inception tree
into the port's ``InceptionV3FID``.
``module_from_flax`` is derived from the flax names of
``utils/train_state.py`` (``flax_path``): it looks each parameter (and
spectral-norm buffer) of a port module up in the flax tree and applies the
inverse of the torch-to-flax permutation; ``EpsMLP``, ``ValueMLP``,
``UNetSmallEncoder``, the IGEBM's ``sn_stats`` and any net wrapped in a
``TimeIndependentValue`` or a sampler convert through it.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

_RENAMES = [
    (re.compile(r"^temb_dense(\d)$"), r"temb.dense.\1"),
    (re.compile(r"^down_(\d+)_block_(\d+)$"), r"down.\1.block.\2"),
    (re.compile(r"^down_(\d+)_attn_(\d+)$"), r"down.\1.attn.\2"),
    (re.compile(r"^down_(\d+)_downsample$"), r"down.\1.downsample"),
    (re.compile(r"^up_(\d+)_block_(\d+)$"), r"up.\1.block.\2"),
    (re.compile(r"^up_(\d+)_attn_(\d+)$"), r"up.\1.attn.\2"),
    (re.compile(r"^up_(\d+)_upsample$"), r"up.\1.upsample"),
    (re.compile(r"^mid_(block_1|attn_1|block_2)$"), r"mid.\1"),
]


def _unet_small_path(mods) -> str:
    """flax module path of a UNetSmall leaf -> reference dotted path:
    ``down_1_attn_0/q`` -> ``down.1.attn.0.q``."""
    top = mods[0]
    for pat, repl in _RENAMES:
        top = pat.sub(repl, top)
    return ".".join([top, *mods[1:]])


def _leaves(tree: Dict[str, Any], path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v, dtype=np.float32)


def unet_small_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``UNetSmall`` from the JAX ``UNetSmall``
    params tree (numpy leaves; a ``{'params': ...}`` wrapper is accepted)."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for path, val in _leaves(params):
        *mods, leaf = path
        if mods and mods[-1] == "gn":
            mods, name = mods[:-1], {"scale": "weight", "bias": "bias"}[leaf]
        elif leaf == "kernel":
            name = "weight"
            val = val.transpose(3, 2, 0, 1) if val.ndim == 4 else val.T
        elif leaf == "bias":
            name = "bias"
        else:
            raise ValueError(f"unhandled flax leaf {'/'.join(path)}")
        key = f"{_unet_small_path(mods)}.{name}"
        out[key] = torch.from_numpy(np.ascontiguousarray(val))
    return out


def unet_small_quant_scales_from_flax(scales: Dict[str, Any]
                                      ) -> Dict[str, torch.Tensor]:
    """State-dict entries of the port's ``UNetSmall`` scale buffers from the
    JAX ``quant_scales`` collection (a ``{'quant_scales': ...}`` wrapper is
    accepted), for every placement JAX uses: the ``act_scale`` of each
    ``QConv`` (``down_0_block_0/conv1`` -> ``down.0.block.0.conv1``), of an
    ``einsum_merged`` attention block (``mid_attn_1`` -> ``mid.attn_1``) and
    of a phase ``Upsample`` (``up_1_upsample`` -> ``up.1.upsample``). Load
    them with ``load_state_dict(..., strict=False)``."""
    scales = scales.get("quant_scales", scales)
    out: Dict[str, torch.Tensor] = {}
    for path, val in _leaves(scales):
        *mods, leaf = path
        if leaf != "act_scale" or not mods:
            raise ValueError(f"unhandled quant_scales leaf {'/'.join(path)}")
        out[f"{_unet_small_path(mods)}.{leaf}"] = torch.from_numpy(
            np.array(val, dtype=np.float32))
    return out


def _lookup(tree: Dict[str, Any], path: Sequence[str]) -> np.ndarray:
    node = tree
    for i, k in enumerate(path):
        if not isinstance(node, dict) or k not in node:
            raise KeyError(f"flax tree has no {'/'.join(path[:i + 1])}")
        node = node[k]
    return np.asarray(node, dtype=np.float32)


def _count(tree: Any) -> int:
    return (sum(_count(v) for v in tree.values())
            if isinstance(tree, dict) else 1)


def module_from_flax(module: torch.nn.Module, params: Dict[str, Any],
                     stats: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, torch.Tensor]:
    """State dict of ``module`` from its flax ``params`` tree (a
    ``{'params': ...}`` wrapper is accepted) and, for a spectral-norm net,
    its ``sn_stats`` tree: each entry found at ``train_state.flax_path``
    and permuted back. Raises ``KeyError`` when the trees lack a leaf of the
    module or hold leaves it has not."""
    from dxmi_tpu_torch.utils.train_state import (_inverse, flax_path,
                                                  sn_buffers)

    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    named = [(k, p, params) for k, p in module.named_parameters()]
    if stats is not None:
        stats = stats.get("sn_stats", stats)
        named += [(k, b, stats) for k, b in sn_buffers(module)]
    for key, t, tree in named:
        path, axes = flax_path(module, key, t.dim())
        val = _lookup(tree, path)
        if axes is not None:
            val = val.transpose(_inverse(axes))
        out[key] = torch.from_numpy(np.array(val))
    n_params = len(list(module.parameters()))
    for tree, n in ((params, n_params),
                    (stats, len(out) - n_params)):
        if tree is not None and _count(tree) != n:
            raise KeyError(f"flax tree holds {_count(tree)} leaves, "
                           f"{type(module).__name__} {n}")
    return out


def var_sampler_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``VARSampler`` from the JAX sampler params
    ``{'net': <UNetSmall params>, 'log_betas': (T,)}``."""
    out = {f"net.{k}": v for k, v in unet_small_from_flax(params["net"]).items()}
    out["log_betas"] = torch.from_numpy(
        np.asarray(params["log_betas"], dtype=np.float32))
    return out


def _adm_module_path(name: str) -> str:
    """flax module name -> reference dotted path: ``input_blocks_1_0`` ->
    ``input_blocks.1.0``, ``output_blocks_2_2_conv`` -> ``output_blocks.2.2.conv``,
    ``input_blocks_3_0_op`` -> ``input_blocks.3.0.op``."""
    name = re.sub(r"_(\d+)", r".\1", name)
    return re.sub(r"_(op|conv)$", r".\1", name)


def _axes(leaf: str, ndim: int) -> Optional[Tuple[int, ...]]:
    """The transpose of a flax kernel into the port's layout (HWIO -> OIHW,
    a Dense's (in, out) -> (out, in)); None for other leaves."""
    if leaf != "kernel":
        return None
    return (3, 2, 0, 1) if ndim == 4 else (1, 0)


def adm_leaf(path: Sequence[str], ndim: int
             ) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """The port's ``UNetADM`` state-dict key of the flax leaf at ``path``
    and the transpose that takes its value there (None: as it is)."""
    *mods, leaf = path
    if mods and mods[-1] == "gn":
        mods, name = mods[:-1], {"scale": "weight", "bias": "bias"}[leaf]
    elif leaf in ("kernel", "bias", "embedding"):
        name = "bias" if leaf == "bias" else "weight"
    else:
        raise ValueError(f"unhandled flax leaf {'/'.join(path)}")
    key = ".".join([*(_adm_module_path(m) for m in mods), name])
    return key, _axes(leaf, ndim)


def unet_adm_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``UNetADM`` from the JAX ``UNetADM`` params
    tree (numpy leaves; a ``{'params': ...}`` wrapper is accepted)."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for path, val in _leaves(params):
        key, axes = adm_leaf(path, val.ndim)
        if axes is not None:
            val = val.transpose(axes)
        out[key] = torch.from_numpy(np.ascontiguousarray(val))
    return out


def adm_quant_scales_from_flax(scales: Dict[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """State-dict entries of the port's ``UNetADM`` scale buffers from the
    JAX ``quant_scales`` collection (``act_scale`` of each ``QConv`` and
    phase up-block, ``attn_act_scale``/``attn_proj_scale`` of each int8
    attention block; a ``{'quant_scales': ...}`` wrapper is accepted): the
    flax module path goes back to the reference's dotted path, the leaf
    name stays. Load them with ``load_state_dict(..., strict=False)``."""
    scales = scales.get("quant_scales", scales)
    out: Dict[str, torch.Tensor] = {}
    for path, val in _leaves(scales):
        *mods, leaf = path
        if leaf not in ("act_scale", "attn_act_scale", "attn_proj_scale"):
            raise ValueError(f"unhandled quant_scales leaf {'/'.join(path)}")
        key = ".".join([*(_adm_module_path(m) for m in mods), leaf])
        out[key] = torch.from_numpy(np.array(val, dtype=np.float32))
    return out


def edm_sampler_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``EDMSampler`` from the JAX sampler params
    ``{'net': <UNetADM params>, 'log_betas': (T,)}``."""
    out = {f"net.{k}": v for k, v in unet_adm_from_flax(params["net"]).items()}
    out["log_betas"] = torch.from_numpy(
        np.asarray(params["log_betas"], dtype=np.float32))
    return out


def igebm_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``IGEBMEncoder`` from the JAX
    ``IGEBMEncoder`` params (numpy leaves; a ``{'params': ...}`` wrapper is
    accepted): ``block_<i>`` -> ``blocks.<i>``, ``skip`` -> ``skip.0``,
    ``class_embed/embedding`` -> ``class_embed.weight``."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for path, val in _leaves(params):
        *mods, leaf = path
        mods = [re.sub(r"^block_(\d+)$", r"blocks.\1", m) for m in mods]
        if mods[-1] == "skip":
            mods.append("0")
        if leaf == "kernel":
            name = "weight"
            val = val.transpose(3, 2, 0, 1) if val.ndim == 4 else val.T
        elif leaf in ("bias", "embedding"):
            name = "bias" if leaf == "bias" else "weight"
        else:
            raise ValueError(f"unhandled flax leaf {'/'.join(path)}")
        out[".".join([*mods, name])] = torch.from_numpy(np.array(val))
    return out


def wideresnet_leaf(path: Sequence[str], ndim: int
                    ) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """The port's ``WideResNet`` state-dict key of the flax leaf at
    ``path`` (the module path joined with dots, GroupNorm ``scale`` as
    ``weight``) and the transpose that takes its value there."""
    *mods, leaf = path
    if leaf not in ("kernel", "bias", "scale"):
        raise ValueError(f"unhandled flax leaf {'/'.join(path)}")
    name = "bias" if leaf == "bias" else "weight"
    return ".".join([*mods, name]), _axes(leaf, ndim)


def wideresnet_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``WideResNet`` from the JAX ``WideResNet``
    params (numpy leaves; a ``{'params': ...}`` wrapper is accepted): HWIO
    conv kernels to OIHW, the Dense kernel (in, out) to the Linear weight
    (out, in), GroupNorm ``scale`` to ``weight`` (``wideresnet_leaf``)."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for path, val in _leaves(params):
        key, axes = wideresnet_leaf(path, val.ndim)
        if axes is not None:
            val = val.transpose(axes)
        out[key] = torch.from_numpy(np.array(val))
    return out


def value_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``TimeIndependentValue`` from the JAX value
    params ``{'net': <IGEBMEncoder or WideResNet params>}`` (a ``{'params':
    ...}`` wrapper is accepted); a WideResNet is told by its ``norm_out``
    (the IGEBM encoder has none)."""
    params = params.get("params", params)
    net = params["net"]
    conv = wideresnet_from_flax if "norm_out" in net else igebm_from_flax
    return {f"net.{k}": v for k, v in conv(net).items()}


def ncsnpp_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``NCSNpp`` from the JAX ``NCSNpp`` params
    tree (numpy leaves; a ``{'params': ...}`` wrapper is accepted): the
    flax module path joined with dots (``down_1_attn_0/q`` ->
    ``down_1_attn_0.q``), Dense kernels (in, out) to ``Linear`` weights
    (out, in), HWIO conv kernels to OIHW, GroupNorm ``scale`` to
    ``weight``."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for path, val in _leaves(params):
        *mods, leaf = path
        if leaf == "kernel":
            name = "weight"
            val = val.transpose(3, 2, 0, 1) if val.ndim == 4 else val.T
        elif leaf in ("bias", "scale"):
            name = "bias" if leaf == "bias" else "weight"
        else:
            raise ValueError(f"unhandled flax leaf {'/'.join(path)}")
        out[".".join([*mods, name])] = torch.from_numpy(np.array(val))
    return out


def ncsnpp_quant_scales_from_flax(scales: Dict[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """State-dict entries of the port's ``NCSNpp`` scale buffers from the
    JAX ``quant_scales`` collection (a ``{'quant_scales': ...}`` wrapper is
    accepted): the ``act_scale`` of every ``QConv``, the ResBlocks' conv1,
    conv2 and shortcut and the attention 1x1s (``mid_attn/q`` ->
    ``mid_attn.q.act_scale``). Load them with ``load_state_dict(...,
    strict=False)``."""
    scales = scales.get("quant_scales", scales)
    out: Dict[str, torch.Tensor] = {}
    for path, val in _leaves(scales):
        *mods, leaf = path
        if leaf != "act_scale" or not mods:
            raise ValueError(f"unhandled quant_scales leaf {'/'.join(path)}")
        out[".".join([*mods, leaf])] = torch.from_numpy(
            np.array(val, dtype=np.float32))
    return out


def ddgan_sampler_from_flax(params: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``DDGANSampler`` from the JAX sampler
    params ``{'net': <NCSNpp params>, 'log_betas': (T,)}``."""
    out = {f"net.{k}": v for k, v in ncsnpp_from_flax(params["net"]).items()}
    out["log_betas"] = torch.from_numpy(
        np.array(params["log_betas"], dtype=np.float32))
    return out


def inception_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``InceptionV3FID`` (without ``fc``) from the
    JAX package's folded FID Inception tree (``load_fid_inception_params``:
    ``<module path>/Conv_0/{kernel HWIO, bias}``; a ``{'params': ...}``
    wrapper is accepted): ``<module path>.conv.{weight OIHW, bias}``."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for path, val in _leaves(params):
        *mods, conv, leaf = path
        if conv != "Conv_0" or leaf not in ("kernel", "bias"):
            raise ValueError(f"unhandled flax leaf {'/'.join(path)}")
        if leaf == "kernel":
            val = val.transpose(3, 2, 0, 1)
        name = "weight" if leaf == "kernel" else "bias"
        out[".".join([*mods, "conv", name])] = torch.from_numpy(np.array(val))
    return out
