"""Sampler wrappers (``dxmi_tpu.samplers``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

# trajectory entries whose batch axis is axis 0; every other entry carries a
# leading T or T+1 time axis with the batch on axis 1
# (``dxmi_tpu/samplers/__init__.py:40-43``)
BATCH_AXIS0 = ("sample", "logp_terminal", "y")


def sample_many(sampler, n_batches: int, batch: int,
                generator: Optional[torch.Generator] = None,
                **kw) -> torch.Tensor:
    """The final samples of ``n_batches`` whole trajectories of ``batch``,
    drawn one after another from one ``generator``, stacked:
    (n_batches, batch, C, H, W) (``dxmi_tpu/samplers/__init__.py:21``, a
    lax.scan over whole ``sample`` calls there). ``kw`` go to
    ``sampler.sample``."""
    return torch.stack([sampler.sample(batch, generator=generator,
                                       **kw)["sample"]
                        for _ in range(n_batches)])


def sample_chunked(sampler, n_sample: int, n_chunks: int,
                   generator: Optional[torch.Generator] = None,
                   y: Optional[torch.Tensor] = None
                   ) -> Dict[str, Optional[torch.Tensor]]:
    """Trajectories of ``n_sample`` samples drawn in ``n_chunks`` sequential
    chunks (a plain loop), merged along each entry's batch axis
    (``BATCH_AXIS0``); ``None`` entries stay ``None``. Class labels ``y``
    (n_sample,) are split per chunk. Bounds the per-step working set of a
    large batch; distributionally the same as one batch, not bitwise."""
    def draw(n, yy):
        kw = {} if yy is None else {"y": yy}
        return sampler.sample(n, generator=generator, **kw)

    if n_chunks <= 1:
        return draw(n_sample, y)
    if n_sample % n_chunks:
        raise ValueError(f"n_sample={n_sample} not divisible by "
                         f"n_chunks={n_chunks}")
    b = n_sample // n_chunks
    chunks = [draw(b, None if y is None else y[i * b:(i + 1) * b])
              for i in range(n_chunks)]

    def merge(name):
        parts = [c[name] for c in chunks]
        if any(p is None for p in parts):
            return None
        return torch.cat(parts, dim=0 if name in BATCH_AXIS0 else 1)

    return {k: merge(k) for k in chunks[0]}
