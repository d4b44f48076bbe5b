"""The conditional DxMI trainer for ImageNet64 / LSUN
(``dxmi_tpu.trainers.dxmi_cond.DxMITrainerCond``, ``dxmi_cond.py:29-50``):
the base trainer with forward ``betas_for_q`` ordering, ``betas_for_q``
initialised to the EDM policy's sigmas^2, RAdam for the sampler, no sampler
gradient clip, the non-finite update guard (``apply_if_finite(..., 100)``)
in place of fp16 loss scaling, and a policy update that sweeps every
minibatch of the buffer. Value-guided sampling (``sample_guidance``) is not
ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from dxmi_tpu_torch.trainers.dxmi import DxMITrainer


class DxMITrainerCond(DxMITrainer):
    def __init__(self, *args, beta_ordering: str = "forward", **kwargs):
        super().__init__(*args, beta_ordering=beta_ordering, **kwargs)
        self.sampler_grad_clip = None
        self.nan_guard = True
        self.sampler_optimizer = "radam"

    def init_betas_for_q(self) -> torch.Tensor:
        if self.use_sampler_beta:
            if hasattr(self.sampler, "betas_for_q_default"):
                return self.sampler.betas_for_q_default.detach().float()
            raise ValueError("use_sampler_beta requires a sampler schedule")
        return super().init_betas_for_q()

    def update_sampler(self, buffer, n_generator: Optional[int] = None,
                       **kwargs):
        """The full-buffer sweep by default."""
        return super().update_sampler(buffer, n_generator, **kwargs)
