"""Karras diffusion training losses: denoising score matching, consistency
distillation and training, progressive distillation
(``dxmi_tpu.trainers.distill``, ``distill.py:35-262``) in PyTorch.

The losses take the nets themselves: ``net`` (online, trained), a
``target_net`` (its EMA, ``utils/ema.py``) and a ``teacher_net``; each
returns per-sample terms with gradients to ``net`` alone. Teacher forwards
run in eval mode under ``no_grad``, as the reference's ``@th.no_grad``
teachers; the target's forward runs under ``no_grad`` too (JAX's
``stop_gradient``), in the mode the online one runs. ``KarrasDenoiser.
denoise`` sets a net's mode for its call alone, so a teacher or target that
is the online module itself does not change the online net's mode.

The online and target forwards of a consistency loss see the same dropout
draw (the reference restores the torch RNG state between them, JAX passes
both the same key): the default generators' states are saved before the
online forward and restored before the target's. ``dropout_masks`` (keep
masks in the nets' call order, ``NetControls.inject_dropout_masks``)
replays given masks in both instead. Every other draw is injectable too:
``noise`` and the scale ``indices``; when None they come from
``generator``. ``randint``'s upper bound is exclusive, as in JAX:
``num_scales - 1`` for consistency, ``num_scales`` for progdist.

``l2-32`` resizes both sides to 32x32 as ``jax.image.resize(...,
"bilinear")`` does, which antialiases when it downsamples
(``F.interpolate(..., antialias=True)``); ``lpips`` raises, as in the JAX
package (the reference's import of it is commented out).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dxmi_tpu_torch.samplers.edm import KarrasDenoiser


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over every axis but the batch's."""
    return x.reshape(x.shape[0], -1).mean(dim=1)


def append_dims(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """``x`` (B,) shaped to broadcast against a rank-``ndim`` batch."""
    return x.reshape(-1, *([1] * (ndim - 1)))


def create_ema_and_scales_fn(target_ema_mode: str, start_ema: float,
                             scale_mode: str, start_scales: int,
                             end_scales: int, total_steps: int,
                             distill_steps_per_iter: int = 0):
    """step -> (target EMA rate, num_scales) of consistency or progressive
    distillation (``distill.py:35-76``): modes (fixed, fixed), (fixed,
    progressive), (adaptive, progressive) and (fixed, progdist), the last
    halving the scale count each ``distill_steps_per_iter`` steps down to 2,
    then 1."""

    def progressive_scales(step: int) -> int:
        s = np.sqrt((step / total_steps)
                    * ((end_scales + 1) ** 2 - start_scales ** 2)
                    + start_scales ** 2)
        return int(max(np.ceil(s) - 1, 1)) + 1

    def ema_and_scales_fn(step: int):
        mode = (target_ema_mode, scale_mode)
        if mode == ("fixed", "fixed"):
            return float(start_ema), int(start_scales)
        if mode == ("fixed", "progressive"):
            return float(start_ema), progressive_scales(step)
        if mode == ("adaptive", "progressive"):
            scales = progressive_scales(step) - 1
            c = -np.log(start_ema) * start_scales
            return float(np.exp(-c / scales)), scales + 1
        if mode == ("fixed", "progdist"):
            stage = step // distill_steps_per_iter
            scales = max(start_scales // (2 ** stage), 2)
            if scales == 2:
                sub_stage = int(max(
                    step - distill_steps_per_iter
                    * (np.log2(start_scales) - 1), 0)
                ) // (distill_steps_per_iter * 2)
                scales = max(2 // (2 ** sub_stage), 1)
            return 1.0, int(scales)
        raise NotImplementedError(mode)

    return ema_and_scales_fn


def _pow(x: torch.Tensor, p: float) -> torch.Tensor:
    """x ** p rounded once to x's dtype (XLA's pow, which the JAX package's
    ``**`` lowers to, is correctly rounded on the CPU; torch's fp32 pow
    can be an ulp off)."""
    return (x.double() ** p).to(x.dtype)


def get_snr(sigmas: torch.Tensor) -> torch.Tensor:
    """SNR of the EDM forward process at noise level sigma."""
    return _pow(sigmas, -2.0)


def get_weightings(weight_schedule: str, snrs: torch.Tensor,
                   sigma_data: float) -> torch.Tensor:
    """Per-sample loss weights (``distill.py:84-98``)."""
    if weight_schedule == "snr":
        return snrs
    if weight_schedule == "snr+1":
        return snrs + 1.0
    if weight_schedule == "karras":
        return snrs + 1.0 / sigma_data ** 2
    if weight_schedule == "truncated-snr":
        return torch.clamp(snrs, min=1.0)
    if weight_schedule == "uniform":
        return torch.ones_like(snrs)
    raise NotImplementedError(f"unknown weight_schedule {weight_schedule!r}")


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """NCHW bilinear resize to ``size`` x ``size`` with half-pixel centres
    and, when shrinking, the antialiasing of ``jax.image.resize``."""
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)


def norm_loss(loss_norm: str, pred: torch.Tensor, target: torch.Tensor,
              weights: torch.Tensor) -> torch.Tensor:
    """The weighted distillation loss per sample (``distill.py:107-123``)."""
    if loss_norm == "l1":
        return mean_flat(torch.abs(pred - target)) * weights
    if loss_norm == "l2":
        return mean_flat((pred - target) ** 2) * weights
    if loss_norm == "l2-32":
        pred, target = resize_bilinear(pred, 32), resize_bilinear(target, 32)
        return mean_flat((pred - target) ** 2) * weights
    if loss_norm == "lpips":
        raise ValueError(
            "loss_norm='lpips' is dead code in the reference snapshot (the "
            "piq import is commented out, karras_diffusion.py:10); use "
            "'l1', 'l2' or 'l2-32'")
    raise ValueError(f"unknown loss norm {loss_norm!r}")


def karras_t(diffusion: KarrasDenoiser, frac: torch.Tensor) -> torch.Tensor:
    """The rho-interpolated sigma at grid position ``frac`` in [0, 1]."""
    smax_r = diffusion.sigma_max ** (1.0 / diffusion.rho)
    smin_r = diffusion.sigma_min ** (1.0 / diffusion.rho)
    return _pow(smax_r + frac * (smin_r - smax_r), diffusion.rho)


def _draw_noise(x_start, noise, generator):
    if noise is not None:
        return noise
    return torch.randn(x_start.shape, generator=generator,
                       device=x_start.device, dtype=x_start.dtype)


def _draw_indices(x_start, high, indices, generator):
    if indices is None:
        indices = torch.randint(0, high, (x_start.shape[0],),
                                generator=generator, device=x_start.device)
    return indices.to(device=x_start.device, dtype=torch.float32)


def _rng_state(device: torch.device):
    """The default generators' states (the CPU's and the card's)."""
    return (torch.get_rng_state(), torch.cuda.get_rng_state(device)
            if device.type == "cuda" else None)


def _set_rng_state(device: torch.device, state) -> None:
    torch.set_rng_state(state[0])
    if state[1] is not None:
        torch.cuda.set_rng_state(state[1], device)


def _denoise(diffusion, net, x, sigma, y, train, masks):
    """The net's denoised estimate in training or eval mode, replaying
    ``masks`` when given."""
    if masks is not None:
        net.inject_dropout_masks(masks)
    try:
        return diffusion.denoise(net, x, sigma, y, train=train)[1]
    finally:
        if masks is not None:
            net.inject_dropout_masks(None)


@torch.no_grad()
def _teacher(diffusion, net, x, sigma, y):
    return diffusion.denoise(net, x, sigma, y, train=False)[1]


def training_losses(diffusion: KarrasDenoiser, net: nn.Module,
                    x_start: torch.Tensor, sigmas: torch.Tensor,
                    y: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None,
                    train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    dropout_masks: Optional[Sequence[torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
    """The denoising score-matching loss at noise levels ``sigmas`` (B,)
    (``distill.py:134-157``): {'xs_mse', 'mse', 'loss'}, each (B,)."""
    dims = x_start.dim()
    noise = _draw_noise(x_start, noise, generator)
    x_t = x_start + noise * append_dims(sigmas, dims)
    denoised = _denoise(diffusion, net, x_t, sigmas, y, train, dropout_masks)
    weights = get_weightings(diffusion.weight_schedule, get_snr(sigmas),
                             diffusion.sigma_data)
    terms = {"xs_mse": mean_flat((denoised - x_start) ** 2),
             "mse": mean_flat(append_dims(weights, dims)
                              * (denoised - x_start) ** 2)}
    terms["loss"] = terms["mse"]
    return terms


def consistency_losses(diffusion: KarrasDenoiser, net: nn.Module,
                       target_net: Optional[nn.Module],
                       x_start: torch.Tensor, num_scales: int, *,
                       teacher_net: Optional[nn.Module] = None,
                       teacher_diffusion: Optional[KarrasDenoiser] = None,
                       y: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None,
                       indices: Optional[torch.Tensor] = None,
                       train: bool = False,
                       generator: Optional[torch.Generator] = None,
                       dropout_masks: Optional[Sequence[torch.Tensor]] = None
                       ) -> Dict[str, torch.Tensor]:
    """The consistency loss (``distill.py:160-218``): with ``teacher_net``
    the adjacent point comes from one Heun step of the teacher
    (distillation), without one from an Euler step towards ``x_start``
    (training). ``target_net`` is evaluated there without gradients; it is
    required."""
    if target_net is None:
        raise ValueError("Must have a target model")
    dims = x_start.dim()
    noise = _draw_noise(x_start, noise, generator)
    idx = _draw_indices(x_start, num_scales - 1, indices, generator)
    t = karras_t(diffusion, idx / (num_scales - 1))
    t2 = karras_t(diffusion, (idx + 1) / (num_scales - 1))

    x_t = x_start + noise * append_dims(t, dims)
    rng = _rng_state(x_start.device) if train else None
    distiller = _denoise(diffusion, net, x_t, t, y, train, dropout_masks)

    with torch.no_grad():
        if teacher_net is None:
            d = (x_t - x_start) / append_dims(t, dims)
            x_t2 = x_t + d * append_dims(t2 - t, dims)
        else:
            td = teacher_diffusion or diffusion
            d = (x_t - _teacher(td, teacher_net, x_t, t, y)) \
                / append_dims(t, dims)
            samples = x_t + d * append_dims(t2 - t, dims)
            next_d = (samples - _teacher(td, teacher_net, samples, t2, y)) \
                / append_dims(t2, dims)
            x_t2 = x_t + (d + next_d) * append_dims((t2 - t) / 2.0, dims)
        if rng is not None:
            _set_rng_state(x_start.device, rng)
        target = _denoise(diffusion, target_net, x_t2, t2, y, train,
                          dropout_masks)

    weights = get_weightings(diffusion.weight_schedule, get_snr(t),
                             diffusion.sigma_data)
    return {"loss": norm_loss(diffusion.loss_norm, distiller, target,
                              weights)}


def progdist_losses(diffusion: KarrasDenoiser, net: nn.Module,
                    x_start: torch.Tensor, num_scales: int, *,
                    teacher_net: nn.Module,
                    teacher_diffusion: Optional[KarrasDenoiser] = None,
                    y: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None,
                    indices: Optional[torch.Tensor] = None,
                    train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    dropout_masks: Optional[Sequence[torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
    """The progressive-distillation loss (``distill.py:221-262``): the
    student at sigma t regresses the denoiser that two teacher Euler
    half-steps (t -> t2 -> t3) imply. ``l2-32`` raises."""
    if diffusion.loss_norm == "l2-32":
        raise ValueError("loss_norm 'l2-32' is not supported by "
                         "progdist_losses (karras_diffusion.py:311-331)")
    dims = x_start.dim()
    noise = _draw_noise(x_start, noise, generator)
    idx = _draw_indices(x_start, num_scales, indices, generator)
    t = karras_t(diffusion, idx / num_scales)
    t2 = karras_t(diffusion, (idx + 0.5) / num_scales)
    t3 = karras_t(diffusion, (idx + 1.0) / num_scales)

    x_t = x_start + noise * append_dims(t, dims)
    denoised_x = _denoise(diffusion, net, x_t, t, y, train, dropout_masks)

    td = teacher_diffusion or diffusion

    def euler(x, s, s_next):
        d = (x - _teacher(td, teacher_net, x, s, y)) / append_dims(s, dims)
        return x + d * append_dims(s_next - s, dims)

    with torch.no_grad():
        x_t3 = euler(euler(x_t, t, t2), t2, t3)
        target_x = x_t - append_dims(t, dims) * (x_t3 - x_t) \
            / append_dims(t3 - t, dims)

    weights = get_weightings(diffusion.weight_schedule, get_snr(t),
                             diffusion.sigma_data)
    return {"loss": norm_loss(diffusion.loss_norm, denoised_x, target_x,
                              weights)}
