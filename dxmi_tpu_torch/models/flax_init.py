"""flax's initialisers for the port's nets, the weights that the JAX
package's ``init_params`` gives a net it trains from scratch (the three
pretraining entries).

Each parameter is drawn by its flax leaf (``utils/train_state.flax_path``):

- ``kernel`` (conv and dense): ``lecun_normal``, a normal truncated to
  (-2, 2) and scaled to variance 1 / fan_in, fan_in being the product of
  every axis but the output one (kh * kw * in for a conv);
- ``embedding`` (``nn.Embed``): a plain normal of variance 1 / features;
- ``bias``: zeros; GroupNorm ``scale``: ones;
- the kernels that the JAX modules zero on purpose: UNetADM's residual
  branches' last conv (``out_layers_3``, ``zeros_init``,
  ``dxmi_tpu/models/unet_adm.py:72``, ``:166``), its attention blocks'
  ``proj_out`` (``:237``, ``:299``) and its output conv ``out_2``
  (``:469-470``); NCSN++'s blocks' ``conv2`` and ``proj_out``
  (``dxmi_tpu/models/ncsnpp.py:154``, ``:181``). UNetSmall zeroes none.

The draws come from an explicit ``torch.Generator``, on its device. Torch
cannot reproduce threefry, so the values differ from JAX's; their
distributions do not (the same shapes, zeros, truncation and variance).
A sampler's ``log_betas`` keep the value its constructor gives them, the
samplers' own init formula.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from dxmi_tpu_torch.utils.train_state import flax_path

# std of a standard normal truncated to (-2, 2) (flax's variance_scaling)
TRUNC_STD = 0.87962566103423978

# the modules whose kernels the JAX nets initialise to zeros
ZERO_KERNELS = {"UNetADM": ("out_layers_3", "proj_out", "out_2"),
                "NCSNpp": ("conv2", "proj_out")}


def lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator]
                  ) -> None:
    """flax's ``lecun_normal`` on a torch weight (out, in, ...): a normal
    truncated to (-2, 2), scaled to variance 1 / fan_in, drawn on the
    generator's device by the inverse CDF of a uniform draw, as
    ``jax.random.truncated_normal``."""
    std = math.sqrt(1.0 / w[0].numel()) / TRUNC_STD
    device = generator.device if generator is not None else w.device
    lo, hi = (math.erf(b / math.sqrt(2.0)) for b in (-2.0, 2.0))
    u = torch.rand(w.shape, generator=generator, device=device) \
        * (hi - lo) + lo
    z = (torch.erfinv(u) * math.sqrt(2.0)).clamp(-2.0, 2.0)
    with torch.no_grad():
        w.copy_(z * std)


@torch.no_grad()
def flax_init_(net: nn.Module, generator: Optional[torch.Generator]
               ) -> nn.Module:
    """Draw every parameter of ``net`` (UNetSmall, UNetADM, NCSNpp or any
    net ``flax_path`` names) as the JAX net's ``init`` does; returns it."""
    zero = ZERO_KERNELS.get(type(net).__name__, ())
    for key, p in net.named_parameters():
        path, _ = flax_path(net, key, p.dim())
        leaf = path[-1]
        if leaf == "bias" or (leaf == "kernel" and path[-2] in zero):
            p.zero_()
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf == "embedding":
            device = generator.device if generator is not None else p.device
            p.copy_(torch.randn(p.shape, generator=generator, device=device)
                    * math.sqrt(1.0 / p.shape[1]))
        elif leaf == "kernel":
            lecun_normal_(p, generator)
        else:
            raise ValueError(f"{type(net).__name__}: no initialiser for "
                             f"{key} ({'/'.join(path)})")
    return net
