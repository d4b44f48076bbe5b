"""The DxMI trainer with separate energy and value nets, the anomaly
variant (``dxmi_tpu.trainers.dxmi_ev.DxMITrainerEV``, ``dxmi_ev.py:29-269``)
in PyTorch.

Against ``DxMITrainer``:
- ``betas_for_q`` under ``use_sampler_beta`` is exp of the sampler's live
  ``log_betas`` (``dxmi_ev.py:54-70``), not its q-process eta;
- the energy step trains f alone, with its own Adam behind a 0.1
  global-norm clip (``chain(clip_by_global_norm(0.1), adam(f_lr))``,
  ``:80-81``) and no gamma penalty;
- every TD step resamples its next state from the current policy (eval
  mode, no gradient) and its target blends f in at t = T-1:
  [v(x', t+1) 1{t < T-1} + f(x') 1{t = T-1}] + tau2 cost - tau1 log sigma
  (``:148-176``), without a gradient clip;
- the sampler step blends f in the same way (``:232-243``).

The spectral-norm stats of f and of the value are stored by the energy
step's forward of f and by each TD step's forward of the value, as in the
base trainer. ``noise[i]`` injects the policy step of sweep step i (in
update order, T-1 down to 0); drawn from ``generator`` when None.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from dxmi_tpu_torch.models.igebm import update_sn_stats
from dxmi_tpu_torch.trainers.buffer import TrajectoryBuffer
from dxmi_tpu_torch.trainers.dxmi import DxMITrainer
from dxmi_tpu_torch.trainers.optim import Adam, clip_by_global_norm


class DxMITrainerEV(DxMITrainer):
    def __init__(self, batchsize: int, tau1: float = 0.0, tau2: float = 0.0,
                 q_beta_schedule: str = "constant",
                 q_beta_start: float = 1.0, q_beta_end: float = 1.0,
                 adavelreg: Optional[float] = None, n_timesteps: int = 10,
                 use_sampler_beta: bool = False):
        super().__init__(batchsize, tau1=tau1, tau2=tau2,
                         q_beta_schedule=q_beta_schedule,
                         q_beta_start=q_beta_start, q_beta_end=q_beta_end,
                         adavelreg=adavelreg, n_timesteps=n_timesteps,
                         use_sampler_beta=use_sampler_beta)

    def init_betas_for_q(self) -> torch.Tensor:
        if self.use_sampler_beta:
            return torch.exp(self.sampler.log_betas.detach().float())
        return super().init_betas_for_q()

    def set_models(self, sampler, value, energy, lr: float, v_lr: float,
                   f_lr: float, beta_lr: Optional[float] = None) -> None:
        super().set_models(sampler, value, lr, v_lr, beta_lr)
        self.energy = energy
        self.opt_f = Adam(list(energy.parameters()), f_lr)

    def update_f_v(self, img: torch.Tensor, buffer: TrajectoryBuffer,
                   y: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[Sequence[torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
        """The energy step on f, then the TD sweep T-1 down to 0 with each
        next state resampled from the policy; ``y`` is not used (the
        anomaly nets take no labels). Returns the JAX trainer's metrics."""
        del y
        T = self.n_timesteps
        last = buffer.last()
        state, next_state = last.state[0], last.next_state[0]
        betas = self.betas_for_q.to(state.device)
        if self.adavelreg is not None:
            diff = torch.flip(((next_state - state) ** 2).reshape(T, -1)
                              .mean(dim=1), dims=(0,))
            betas = betas * self.adavelreg + (1 - self.adavelreg) * diff

        inputs = torch.cat([img, next_state[-1]], dim=0)
        with update_sn_stats(self.energy):
            out = self._f(inputs)
        pos, neg = out[:img.shape[0]], out[img.shape[0]:]
        d_loss = pos.mean() - neg.mean()
        grads = torch.autograd.grad(d_loss, self.opt_f.params)
        self.opt_f.step(clip_by_global_norm(list(grads), 0.1))

        steps = {k: [] for k in ("v_loss", "running_cost", "value", "t")}
        for i, t in enumerate(range(T - 1, -1, -1)):
            x = state[t]
            tvec = torch.full((x.shape[0],), t, dtype=torch.long,
                              device=x.device)
            with torch.no_grad():
                d = self.sampler.sample_step(
                    x, tvec, None if noise is None else noise[i],
                    generator=generator)
                nxt, sigma = d["sample"], d["sigma"]
                cost = self._running_cost(betas, x, nxt, tvec)
                non_term = (tvec < T - 1).float()
                v_next = (self._v(nxt, tvec + 1) * non_term
                          + self._f(nxt) * (1 - non_term))
                target = (v_next + cost * self.tau2
                          - torch.log(sigma) * self.tau1)
            with update_sn_stats(self.value):
                v = self._v(x, tvec)
            v_loss = ((v - target) ** 2).mean()
            self._value_step(v_loss, clip=False)
            for k, val in (("v_loss", v_loss.detach()),
                           ("running_cost", cost.mean()),
                           ("value", v.mean().detach()),
                           ("t", torch.tensor(t))):
                steps[k].append(val)
        per = {k: torch.stack(v) for k, v in steps.items()}
        self.betas_for_q = betas.detach()
        return {"ebm/d_loss_": d_loss.detach(),
                "ebm/v_loss_": per["v_loss"][-1],
                "ebm/pos_e_": pos.mean().detach(),
                "ebm/neg_e_": neg.mean().detach(),
                "ebm/running_cost_": per["running_cost"][-1],
                "per_step/t": per["t"],
                "per_step/running_cost": per["running_cost"],
                "per_step/value": per["value"]}

    def minibatch_loss(self, flat: Dict[str, torch.Tensor],
                       idx: torch.Tensor, noise: Optional[torch.Tensor],
                       generator: Optional[torch.Generator] = None,
                       z: Optional[torch.Tensor] = None, aug_draw=None):
        """The policy loss of buffer rows ``idx`` (``dxmi_ev.py:232-243``):
        mean of the f-blended next value, plus tau2 times the mean running
        cost, minus tau1 times the mean log sigma."""
        del z, aug_draw
        T = self.n_timesteps
        s, t = flat["state"][idx], flat["timestep"][idx]
        d = self.sampler.sample_step(s, t, noise, None, generator,
                                     train=True)
        cost = self._running_cost(self.betas_for_q.to(s.device), s,
                                  d["sample"], t).mean()
        entropy = torch.log(d["sigma"]).mean()
        non_term = (t < T - 1).float()
        v_next = (self._v(d["sample"], t + 1) * non_term
                  + self._f(d["sample"]) * (1 - non_term))
        loss = v_next.mean() + cost * self.tau2 - entropy * self.tau1
        return loss, v_next.mean(), cost, entropy
