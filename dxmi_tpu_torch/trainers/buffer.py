"""Trajectory replay buffer with a regular (K, T, B, ...) layout
(``dxmi_tpu.trainers.buffer``, ``buffer.py:24-106``).

Exactly B rows per timestep per trajectory, so the (T, B) structure stays
explicit; K is the number of stacked trajectories. States are NCHW.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class TrajectoryBuffer:
    state: torch.Tensor        # (K, T, B, C, H, W)  x_t
    next_state: torch.Tensor   # (K, T, B, C, H, W)  x_{t+1}
    mean: torch.Tensor         # (K, T, B, C, H, W)  policy mean
    sigma: torch.Tensor        # (K, T, B)           policy std
    logp: torch.Tensor         # (K, T, B)
    entropy: torch.Tensor      # (K, T, B)
    y: Optional[torch.Tensor]  # (K, T, B) class labels, or None

    def last(self) -> "TrajectoryBuffer":
        """The newest trajectory, K=1 (the TD sweep consumes only it)."""
        return TrajectoryBuffer(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name)[-1:]
            for f in dataclasses.fields(self)})

    def flat(self) -> Dict[str, torch.Tensor]:
        """(K T B, ...) rows plus a ``timestep`` vector: the rows the sampler
        update draws its minibatches from."""
        K, T, B = self.state.shape[:3]
        out = {f.name: getattr(self, f.name).reshape(
                   K * T * B, *getattr(self, f.name).shape[3:])
               for f in dataclasses.fields(self)
               if getattr(self, f.name) is not None}
        out["timestep"] = torch.arange(T, device=self.state.device)[
            None, :, None].expand(K, T, B).reshape(-1)
        return out


def from_d_sample(d_sample: Dict[str, torch.Tensor]) -> TrajectoryBuffer:
    """A K=1 buffer from a sampler's trajectory dict (``l_sample`` (T+1, B,
    ...), ``mean`` (T, B, ...), ``sigma``, ``logp``, ``entropy`` (T, B),
    ``y`` (B,) or None)."""
    l_sample = d_sample["l_sample"]
    T, B = l_sample.shape[0] - 1, l_sample.shape[1]
    y = d_sample.get("y")
    if y is not None:
        y = y[None].expand(T, B)[None]
    sigma = d_sample["sigma"].reshape(T, B)
    entropy = d_sample.get("entropy")
    return TrajectoryBuffer(
        state=l_sample[None, :-1], next_state=l_sample[None, 1:],
        mean=d_sample["mean"][None], sigma=sigma[None],
        logp=d_sample["logp"][None],
        entropy=(torch.log(sigma) if entropy is None
                 else entropy.reshape(T, B))[None],
        y=y)


def concat(*buffers: TrajectoryBuffer) -> TrajectoryBuffer:
    """The trajectories of ``buffers`` stacked along K (``buffer.py:103``:
    the buffers gathered between two sampler updates when n_critic > 1)."""
    return TrajectoryBuffer(**{
        f.name: None if getattr(buffers[0], f.name) is None
        else torch.cat([getattr(b, f.name) for b in buffers])
        for f in dataclasses.fields(TrajectoryBuffer)})
