"""The conditional DxMI trainer for ImageNet64 / LSUN
(``dxmi_tpu.trainers.dxmi_cond.DxMITrainerCond``, ``dxmi_cond.py:29-50``):
the base trainer with forward ``betas_for_q`` ordering, ``betas_for_q``
initialised to the EDM policy's sigmas^2, RAdam for the sampler, no sampler
gradient clip, the non-finite update guard (``apply_if_finite(..., 100)``)
in place of fp16 loss scaling, and a policy update that sweeps every
minibatch of the buffer; value-guided sampling (``sample_guidance``,
``dxmi_cond.py:54-79``) threads class labels through every step.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

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

    def sample_guidance(self, n_sample: int, *args,
                        i_class: Optional[Any] = None,
                        y: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        **kwargs) -> Dict[str, Any]:
        """The base trainer's guided sampling with class labels: ``y``, else
        ``i_class`` (one class for all, or one a sample), else drawn
        uniformly from the sampler's ``num_classes`` (1000 when it has
        none) when the sampler is class-conditional. The value is queried
        without labels, as in the JAX package."""
        if y is None and getattr(self.sampler, "class_cond", False):
            device = self.sampler.log_betas.device
            if i_class is None:
                n_classes = int(getattr(self.sampler, "num_classes", 0)
                                or 1000)
                y = torch.randint(0, n_classes, (n_sample,),
                                  generator=generator, device=device)
            else:
                y = torch.as_tensor(i_class, dtype=torch.long,
                                    device=device).expand(n_sample)
        return super().sample_guidance(n_sample, *args, y=y,
                                       generator=generator, **kwargs)
