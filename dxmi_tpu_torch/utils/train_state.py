"""The trainer's full state as the JAX package lays it out in
``train_state.msgpack`` (``dxmi_tpu/utils/checkpoint.py:147-181``): the
leaves of its ``DxMIState`` (``dxmi_tpu/trainers/dxmi.py:37-55``) in the
order of ``jax.tree.leaves``, each with JAX's shape and dtype.

``DxMIState``'s fields, in order, and what the port holds for each:

- ``sampler_params``: ``{'log_betas', 'net'}``: the sampler's
  ``log_betas`` and its network's parameters under flax's names;
- ``v_params``: the value's parameters (``{'net': ...}``);
- ``opt_state_sampler``: optax's state of the sampler's optimizer, built
  as ``set_models`` builds it (``dxmi.py:139-183``): with ``nan_guard`` the
  ``apply_if_finite`` counters (``notfinite_count``, ``last_finite``,
  ``total_notfinite``) around a chain of the global-norm clip (no leaves)
  and a ``multi_transform`` whose labels come sorted, ``log_betas`` then
  ``net``, each an Adam or RAdam state masked to its own parameters:
  ``count``, ``mu``, ``nu``;
- ``opt_state_v``: the value's Adam (``count``, ``mu``, ``nu``);
- ``betas_for_q``;
- ``f_params`` and ``opt_state_f``: the separate energy net and its Adam,
  with no leaves when the trainer has none;
- ``v_stats`` and ``f_stats``: the value's and the energy's spectral-norm
  statistics (``sn_stats``: each normalised conv's ``u`` and ``sigma``),
  no leaves when the net has none.

A dict's leaves come in the sorted order of its keys, at every level. The
flax names are those of the JAX package's torch-to-flax converters
(``dxmi_tpu/utils/convert.py``; the port keeps its own copy of that
direction here, ``flax_path``): conv kernels (O, I, kh, kw) go to (kh, kw,
I, O), dense kernels (O, I) to (I, O), GroupNorm weights to ``scale``.
Every leaf is fp32 but the counters (int32) and ``last_finite`` (bool):
the JAX nets keep fp32 parameters in every compute dtype (flax's
``param_dtype``), and optax keeps ``mu`` and ``nu`` in the parameters'
dtype.
"""
from __future__ import annotations

import re
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

Path = Tuple[str, ...]
Axes = Optional[Tuple[int, ...]]


# ---- torch names -> flax paths ------------------------------------------

_UNET_SMALL_RENAMES = [
    (re.compile(r"^temb\.dense\.(\d)\."), r"temb_dense\1."),
    (re.compile(r"^down\.(\d+)\.block\.(\d+)\."), r"down_\1_block_\2."),
    (re.compile(r"^down\.(\d+)\.attn\.(\d+)\."), r"down_\1_attn_\2."),
    (re.compile(r"^down\.(\d+)\.downsample\."), r"down_\1_downsample."),
    (re.compile(r"^up\.(\d+)\.block\.(\d+)\."), r"up_\1_block_\2."),
    (re.compile(r"^up\.(\d+)\.attn\.(\d+)\."), r"up_\1_attn_\2."),
    (re.compile(r"^up\.(\d+)\.upsample\."), r"up_\1_upsample."),
    (re.compile(r"^mid\.(block_1|attn_1|block_2)\."), r"mid_\1."),
]
# module-local names of the GroupNorms of UNetSmall and UNetADM (flax nests
# them as ``<module>/gn``)
_UNET_SMALL_GN = {"norm", "norm1", "norm2", "norm_out"}
_ADM_GN = {"in_layers_0", "out_layers_0", "norm", "out_0"}


def _kernel(leaf: str, ndim: int) -> Tuple[str, Axes]:
    """The flax leaf of a torch ``weight``/``bias`` by its rank: a conv
    kernel (kh, kw, I, O), a dense kernel (I, O), a norm's ``scale``."""
    if leaf == "bias":
        return "bias", None
    if leaf != "weight":
        raise ValueError(f"unhandled parameter {leaf!r}")
    if ndim == 4:
        return "kernel", (2, 3, 1, 0)
    if ndim == 2:
        return "kernel", (1, 0)
    return "scale", None


def _unet_small_path(key: str, ndim: int) -> Tuple[Path, Axes]:
    name = key
    for pat, repl in _UNET_SMALL_RENAMES:
        name = pat.sub(repl, name)
    *mods, leaf = name.split(".")
    if mods and mods[-1] in _UNET_SMALL_GN:
        return (*mods, "gn", "scale" if leaf == "weight" else "bias"), None
    leaf, axes = _kernel(leaf, ndim)
    return (*mods, leaf), axes


def _adm_path(key: str, ndim: int) -> Tuple[Path, Axes]:
    """``dxmi_tpu.utils.convert._adm_flax_path``: a digit token joins the
    name before it (``input_blocks.1.0`` -> ``input_blocks_1_0``), and a
    trailing ``op``/``conv`` joins its block."""
    *tokens, leaf = key.split(".")
    groups: List[str] = []
    for tok in tokens:
        if tok.isdigit():
            groups[-1] = f"{groups[-1]}_{tok}"
        else:
            groups.append(tok)
    if len(groups) >= 2 and groups[-1] in ("op", "conv"):
        groups = groups[:-2] + [f"{groups[-2]}_{groups[-1]}"]
    if groups[-1] == "label_emb":
        return (*groups, "embedding"), None
    if groups[-1] in _ADM_GN:
        return (*groups, "gn", "scale" if leaf == "weight" else "bias"), None
    leaf, axes = _kernel(leaf, ndim)
    return (*groups, leaf), axes


# flax numbers a block's SpectralNorm wrappers in creation order
_SN_INDEX = {"conv1": 0, "conv2": 1, "skip": 2}


def _igebm_path(key: str, ndim: int) -> Tuple[Path, Axes]:
    """``convert_igebm``: ``blocks.<i>`` -> ``block_<i>``, ``skip.0`` ->
    ``skip``, ``class_embed.weight`` -> ``class_embed/embedding``. A
    spectral-norm buffer (``blocks.<i>.<conv>.u`` / ``.sigma``, the stem's
    ``conv1.u``) goes to its ``sn_stats`` path, ``[block_<i>/]
    SpectralNorm_<k>/<conv>/kernel/<u|sigma>``."""
    *mods, leaf = key.split(".")
    if leaf in ("u", "sigma"):
        prefix = (f"block_{mods[1]}",) if mods[0] == "blocks" else ()
        conv = mods[2] if prefix else mods[0]
        return (*prefix, f"SpectralNorm_{_SN_INDEX[conv]}",
                f"{conv}/kernel/{leaf}"), None
    name = re.sub(r"^blocks\.(\d+)\.", r"block_\1.", key)
    name = name.replace("skip.0.", "skip.")
    *mods, leaf = name.split(".")
    if mods[-1] == "class_embed" and leaf == "weight":
        return (*mods, "embedding"), None
    leaf, axes = _kernel(leaf, ndim)
    return (*mods, leaf), axes


def _dotted_path(key: str, ndim: int) -> Tuple[Path, Axes]:
    """The nets whose port names are the flax module paths joined with dots
    (NCSN++, the Wide-ResNet)."""
    *mods, leaf = key.split(".")
    leaf, axes = _kernel(leaf, ndim)
    return (*mods, leaf), axes


_PATHS = {"UNetSmall": _unet_small_path, "UNetSmallEncoder":
          _unet_small_path, "UNetADM": _adm_path,
          "IGEBMEncoder": _igebm_path, "NCSNpp": _dotted_path,
          "WideResNet": _dotted_path, "EpsMLP": _dotted_path,
          "ValueMLP": _dotted_path}


def flax_path(module: nn.Module, key: str, ndim: int) -> Tuple[Path, Axes]:
    """The flax path of ``module``'s parameter ``key`` (a
    ``named_parameters`` name, ``ndim`` its rank) and the permutation that
    takes the torch tensor to flax's layout (None: as it is); of a
    spectral-norm buffer (``sn_buffers``), its path in ``sn_stats``. A
    ``TimeIndependentValue`` nests its net under ``net``; a sampler holds
    ``log_betas`` and its net under ``net``."""
    kind = type(module).__name__
    if kind in _PATHS:
        return _PATHS[kind](key, ndim)
    if key == "log_betas":
        return ("log_betas",), None
    head, _, rest = key.partition(".")
    if head != "net":
        raise ValueError(f"{kind}: no flax path for {key!r}")
    path, axes = flax_path(module.net, rest, ndim)
    return ("net", *path), axes


def flax_params(module: nn.Module, params: Sequence[torch.Tensor]
                ) -> List[Tuple[Path, int, Axes]]:
    """(flax path, index into ``params``, permutation) of each trainable
    parameter of ``module`` that ``params`` holds, in jax.tree.leaves order
    (the paths sorted). Every parameter of ``module`` must be in
    ``params``."""
    index = {id(p): i for i, p in enumerate(params)}
    out = []
    for key, p in module.named_parameters():
        path, axes = flax_path(module, key, p.dim())
        out.append((path, index[id(p)], axes))
    out.sort(key=lambda e: e[0])
    return out


def sn_buffers(module: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of ``module``'s spectral-norm buffers (each conv's
    ``u`` and ``sigma``, ``models/igebm.py``)."""
    out = []
    for name, m in module.named_modules():
        own = dict(m.named_buffers(recurse=False))
        if "u" in own and "sigma" in own:
            out += [(f"{name}.{leaf}", own[leaf]) for leaf in ("u", "sigma")]
    return out


def flax_stats(module: nn.Module) -> List[Tuple[Path, torch.Tensor]]:
    """(path in JAX's ``sn_stats`` collection, tensor) of ``module``'s
    spectral-norm buffers, sorted by path (jax.tree.leaves order)."""
    return sorted(((flax_path(module, key, t.dim())[0], t)
                   for key, t in sn_buffers(module)), key=lambda e: e[0])


def flax_tree(module: nn.Module, stats: bool = False) -> dict:
    """``module``'s parameters (``stats``: its spectral-norm buffers) as the
    nested dict of numpy arrays that flax's ``to_state_dict`` gives for
    the JAX net (its ``params`` or ``sn_stats`` collection)."""
    if stats:
        entries = flax_stats(module)
    else:
        entries = []
        for key, p in module.named_parameters():
            path, axes = flax_path(module, key, p.dim())
            entries.append((path, p if axes is None else p.permute(axes)))
    tree: dict = {}
    for path, t in entries:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t.detach().float().cpu().contiguous().numpy().copy()
    return tree


# ---- the state's leaves --------------------------------------------------

class Slot(NamedTuple):
    """One leaf of the state: JAX's key path (``jax.tree_util.keystr``),
    its shape and dtype name, how to read it (numpy or a CPU tensor, in
    flax's layout) and how to restore it."""
    name: str
    shape: Tuple[int, ...]
    dtype: str
    get: Callable[[], Any]
    set: Callable[[Any], None]


def _keystr(prefix: str, path: Path) -> str:
    return prefix + "".join(f"['{k}']" for k in path)


def _inverse(axes: Axes) -> Axes:
    return None if axes is None else tuple(int(i) for i in np.argsort(axes))


def _dtype_name(t: torch.Tensor) -> str:
    return ("bfloat16" if t.dtype == torch.bfloat16
            else str(t.dtype).replace("torch.", ""))


def _tensor_slot(name: str, t: torch.Tensor, axes: Axes) -> Slot:
    shape = tuple(t.shape) if axes is None else tuple(t.shape[i]
                                                      for i in axes)

    def get():
        v = t.detach() if axes is None else t.detach().permute(axes)
        v = v.contiguous().cpu()
        return v if v.dtype == torch.bfloat16 else v.numpy().copy()

    @torch.no_grad()
    def set_(a):
        v = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a).reshape(np.shape(a)))
        if axes is not None:
            v = v.permute(_inverse(axes))
        t.copy_(v)

    return Slot(name, shape, _dtype_name(t), get, set_)


def _scalar_slot(name: str, dtype: str, get: Callable[[], Any],
                 set_: Callable[[Any], None]) -> Slot:
    return Slot(name, (), dtype, lambda: np.asarray(get(), np.dtype(dtype)),
                set_)


def _param_slots(prefix: str, layout) -> List[Slot]:
    return [_tensor_slot(_keystr(prefix, path), t, axes)
            for path, t, axes in layout]


def _adam_slots(prefix: str, opt, layout, mask: Path = ()) -> List[Slot]:
    """optax's ``ScaleByAdamState`` of ``opt`` (Adam or RAdam) over the
    parameters of ``layout`` ((path, index into opt.params, axes), sorted):
    ``count``, then ``mu`` and ``nu`` with the parameters' paths under
    ``mask``."""
    def set_count(a):
        opt.count = int(a)

    out = [_scalar_slot(f"{prefix}.count", "int32", lambda: opt.count,
                        set_count)]
    for moment in ("mu", "nu"):
        tensors = getattr(opt, moment)
        out += [_tensor_slot(_keystr(f"{prefix}.{moment}", (*mask, *path)),
                             tensors[i], axes) for path, i, axes in layout]
    return out


def _layout(module: nn.Module, opt) -> Tuple[list, list]:
    """``module``'s parameters, which ``opt`` holds, sorted by flax path:
    as (path, tensor, axes) and as (path, index into opt.params, axes)."""
    idx = flax_params(module, opt.params)
    return [(path, opt.params[i], axes) for path, i, axes in idx], idx


def trainer_slots(trainer) -> List[Slot]:
    """The leaves of the JAX ``DxMIState`` of ``trainer``'s configuration
    (a ``DxMITrainer`` or ``DxMITrainerCond`` after ``set_models``), in
    ``jax.tree.leaves`` order."""
    sampler = trainer.sampler
    s_params = trainer.opt_net.params + trainer.opt_betas.params
    slots = _param_slots(".sampler_params", [
        (path, s_params[i], axes)
        for path, i, axes in flax_params(sampler, s_params)])
    v_layout, v_opt = _layout(trainer.value, trainer.opt_v)
    slots += _param_slots(".v_params", v_layout)

    inner = ".opt_state_sampler"
    if trainer.guard is not None:
        g = trainer.guard
        for field, dtype in (("notfinite_count", "int32"),
                             ("last_finite", "bool"),
                             ("total_notfinite", "int32")):
            slots.append(_scalar_slot(
                f"{inner}.{field}", dtype,
                lambda f=field: getattr(g, f),
                lambda a, f=field: setattr(g, f, a.item())))
        inner += ".inner_state"
    # the chain: [clip_by_global_norm (EmptyState),] multi_transform
    mt = f"{inner}[{1 if trainer.sampler_grad_clip is not None else 0}]"
    slots += _adam_slots(
        f"{mt}.inner_states['log_betas'].inner_state[0]", trainer.opt_betas,
        [(("log_betas",), 0, None)])
    slots += _adam_slots(f"{mt}.inner_states['net'].inner_state[0]",
                         trainer.opt_net,
                         flax_params(sampler.net, trainer.opt_net.params),
                         mask=("net",))
    slots += _adam_slots(".opt_state_v[0]", trainer.opt_v, v_opt)

    def set_betas(a):
        trainer.betas_for_q = torch.as_tensor(np.asarray(a)).to(
            trainer.betas_for_q.device)
    slots.append(Slot(".betas_for_q", tuple(trainer.betas_for_q.shape),
                      _dtype_name(trainer.betas_for_q),
                      lambda: trainer.betas_for_q.detach().cpu().numpy()
                      .copy(), set_betas))
    if trainer.energy is not None:
        f_layout, f_opt = _layout(trainer.energy, trainer.opt_f)
        slots += _param_slots(".f_params", f_layout)
        slots += _adam_slots(".opt_state_f[0]", trainer.opt_f, f_opt)
    for field, net in (("v_stats", trainer.value),
                       ("f_stats", trainer.energy)):
        if net is not None:
            slots += [_tensor_slot(_keystr(f".{field}", path), t, None)
                      for path, t in flax_stats(net)]
    return slots
