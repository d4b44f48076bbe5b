"""Sampler wrappers (``dxmi_tpu.samplers``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch


def sample_chunked(sampler, n_sample: int, n_chunks: int,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
    """Trajectories of ``n_sample`` samples drawn in ``n_chunks`` sequential
    chunks (a plain loop), merged along the batch axis: axis 0 for
    ``sample``, axis 1 for the entries with a leading time axis. Bounds the
    per-step working set of a large batch; distributionally the same as one
    batch, not bitwise."""
    if n_chunks <= 1:
        return sampler.sample(n_sample, generator=generator)
    if n_sample % n_chunks:
        raise ValueError(f"n_sample={n_sample} not divisible by "
                         f"n_chunks={n_chunks}")
    chunks = [sampler.sample(n_sample // n_chunks, generator=generator)
              for _ in range(n_chunks)]
    return {k: torch.cat([c[k] for c in chunks], dim=0 if k == "sample" else 1)
            for k in chunks[0]}
