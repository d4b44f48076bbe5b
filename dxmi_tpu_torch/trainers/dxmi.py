"""The DxMI trainer (``dxmi_tpu.trainers.dxmi.DxMITrainer``) in PyTorch: the
value + energy update and the policy update, the paths that the ImageNet64
and CIFAR-10 configs reach with ``value_update_order='backward'``.

``update_f_v`` (``dxmi.py:343-585``): the adaptive velocity regularisation of
``betas_for_q`` (``adavelreg``), one contrastive energy step of the value at
the terminal timestep (with the ``gamma`` square penalty), then the TD sweep
backward in time, one optimizer step per timestep, in order: the sweep stays
sequential, as the reference's semantics need (``dxmi.py:6-10``), with the
``value_grad_clip`` scaling to global norm 0.1. With ``value_resample`` each
sweep step re-runs the policy step on its states, the net in training mode
and without gradient, and its sample and sigma take the place of the
trajectory's next state and sigma (``dxmi.py:475-488``).

``train_step`` composes one iteration as ``_train_step_impl`` does
(``dxmi.py:303-336``): sample a trajectory (``sample_chunked``), the buffer,
``update_f_v``, ``update_sampler``.

``update_sampler`` (``dxmi.py:587-670``): a permutation of the flat buffer, G
minibatches of B rows; each re-runs one policy step with gradients and
descends V(x_{t+1}) + (tau2 cost - tau1 log sigma) [t < T - skip_sampler_tau]
with the sampler optimizer (Adam or RAdam, a separate rate for
``log_betas``, optionally the 0.1 global-norm clip and the non-finite guard).

Torch cannot reproduce threefry draws, so the noise (and DDGAN's latents)
of the re-run steps and the permutation come from a ``torch.Generator`` or
are injected (``perm``, ``noise``, ``z``, ``resample``; dropout masks
through the net's ``inject_dropout_masks``): the tests replay the JAX
trainer's draws that way.
Parameters are updated in place; the trainer keeps ``betas_for_q`` and the
optimizer state. Options that the ImageNet64 and CIFAR-10 configs do not
set raise ``NotImplementedError`` (see ROADMAP.md): a separate energy ``f``,
``aug``, the ``shuffle`` and ``random`` orders,
``repeat_value_update`` > 1 and spectral-norm value statistics.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from dxmi_tpu_torch.samplers import sample_chunked
from dxmi_tpu_torch.schedules import make_beta_schedule
from dxmi_tpu_torch.trainers.buffer import TrajectoryBuffer, from_d_sample
from dxmi_tpu_torch.trainers.optim import (Adam, ApplyIfFinite, RAdam,
                                           clip_by_global_norm, global_norm)


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).mean(dim=1)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: not ported yet (ROADMAP.md)")


class DxMITrainer:
    """Static config and the two update phases (``dxmi.py:62-133``)."""

    def __init__(self, batchsize: int, tau1: float = 0.0, tau2: float = 0.0,
                 gamma: Optional[float] = None,
                 q_beta_schedule: str = "constant",
                 q_beta_start: float = 1.0, q_beta_end: float = 1.0,
                 adavelreg: Optional[float] = None, n_timesteps: int = 10,
                 value_update_order: str = "backward",
                 entropy_in_value: Optional[int] = None,
                 velocity_in_value: Optional[int] = None,
                 use_sampler_beta: bool = False,
                 time_cost: Optional[float] = None,
                 time_cost_sig: Optional[float] = None,
                 repeat_value_update: int = 1, value_resample: bool = False,
                 value_grad_clip: bool = False, skip_sampler_tau: int = 0,
                 beta_ordering: str = "reversed",
                 entropy_value_scale: float = 1.0,
                 sigma_scale: Optional[float] = None,
                 time_cost_sig_center: Optional[int] = None,
                 skip_running_last: bool = False, aug=None,
                 sample_chunks: int = 1):
        if value_update_order != "backward":
            raise _not_ported(f"value_update_order={value_update_order!r}")
        if aug is not None:
            raise _not_ported("aug")
        if int(repeat_value_update) != 1:
            raise _not_ported("repeat_value_update > 1")
        if beta_ordering not in ("reversed", "forward"):
            raise ValueError(f"beta_ordering={beta_ordering!r}")
        self.batchsize = int(batchsize)
        self.n_timesteps = int(n_timesteps)
        self.tau1, self.tau2 = float(tau1), float(tau2)
        self.gamma = gamma
        self.q_beta_schedule = q_beta_schedule
        self.q_beta_start, self.q_beta_end = q_beta_start, q_beta_end
        self.adavelreg = adavelreg
        self.entropy_in_value = entropy_in_value
        self.velocity_in_value = velocity_in_value
        self.use_sampler_beta = use_sampler_beta
        self.time_cost = time_cost
        # a YAML bool counts as 1.0, as in the reference
        self.time_cost_sig = (None if time_cost_sig is None
                              else float(time_cost_sig))
        self.value_grad_clip = bool(value_grad_clip)
        self.skip_sampler_tau = int(skip_sampler_tau)
        self.beta_ordering = beta_ordering
        self.entropy_value_scale = float(entropy_value_scale)
        self.sigma_scale = sigma_scale
        self.time_cost_sig_center = time_cost_sig_center
        self.sample_chunks = int(sample_chunks)
        self.value_resample = bool(value_resample)
        self.sampler_grad_clip: Optional[float] = 0.1
        self.nan_guard = False
        self.sampler_optimizer = "adam"
        self.sampler = self.value = None

    # ---- setup ----------------------------------------------------------

    def set_models(self, sampler, value, lr: float, v_lr: float,
                   beta_lr: Optional[float] = None, energy=None) -> None:
        """Bind the sampler and value modules and build the optimizers:
        ``log_betas`` gets its own rate (the ``multi_transform`` of
        ``dxmi.py:168-176``); with ``nan_guard`` the sampler's step is
        ``apply_if_finite(..., 100)``. Also initialises ``betas_for_q``."""
        if energy is not None:
            raise _not_ported("a separate energy net f")
        self.sampler, self.value = sampler, value
        opt = {"adam": Adam, "radam": RAdam}[self.sampler_optimizer]
        self.net_params = [p for p in sampler.net.parameters()]
        self.opt_net = opt(self.net_params, lr)
        self.opt_betas = opt([sampler.log_betas],
                             lr if beta_lr is None else beta_lr)
        self.guard = (ApplyIfFinite([self.opt_net, self.opt_betas], 100)
                      if self.nan_guard else None)
        self.v_params = list(value.parameters())
        self.opt_v = Adam(self.v_params, v_lr)
        self.betas_for_q = self.init_betas_for_q()

    def init_betas_for_q(self) -> torch.Tensor:
        """``dxmi.py:204-219``: with ``use_sampler_beta`` the sampler's
        q-process betas (``user_defined_eta``, VARSampler), else the exp of
        its current ``log_betas``; otherwise the configured schedule."""
        if self.use_sampler_beta:
            if hasattr(self.sampler, "user_defined_eta"):
                return self.sampler.user_defined_eta.detach().float().clone()
            if hasattr(self.sampler, "log_betas"):
                return torch.exp(self.sampler.log_betas.detach().float())
            raise ValueError("use_sampler_beta requires a sampler schedule "
                             "or log_betas")
        return torch.as_tensor(make_beta_schedule(
            schedule=self.q_beta_schedule, n_timesteps=self.n_timesteps,
            start=self.q_beta_start, end=self.q_beta_end),
            dtype=torch.float32)

    # ---- shared pieces ----------------------------------------------------

    def _v(self, x, t, y=None) -> torch.Tensor:
        return self.value(x, t, y).squeeze(-1)

    def _running_cost(self, betas, state, next_state, t) -> torch.Tensor:
        """(dx)^2 / (2 beta_q), mean over pixels; 'reversed' ordering
        indexes the q-process from the data side."""
        if self.beta_ordering == "reversed":
            t = self.n_timesteps - t - 1
        return mean_flat((next_state - state) ** 2) / (2.0 * betas[t])

    def _entropy_of(self, sigma: torch.Tensor) -> torch.Tensor:
        if self.sigma_scale is not None:
            return torch.log(sigma / self.sigma_scale)
        return torch.log(sigma)

    def _time_cost_terms(self, t: torch.Tensor):
        add = 0.0
        if self.time_cost_sig is not None:
            center = (self.n_timesteps // 2 if self.time_cost_sig_center
                      is None else self.time_cost_sig_center)
            tf = t.float()
            add = add + self.time_cost_sig * (
                torch.sigmoid(-tf + center) - torch.sigmoid(-tf - 1 + center))
        if self.time_cost is not None:
            add = add + self.time_cost
        return add

    def _value_step(self, loss: torch.Tensor, clip: bool) -> None:
        grads = torch.autograd.grad(loss, self.v_params)
        if clip:
            scale = torch.clamp(0.1 / (global_norm(grads) + 1e-12), max=1.0)
            grads = [g * scale for g in grads]
        self.opt_v.step(grads)

    # ---- value / energy update -------------------------------------------

    def update_f_v(self, img: torch.Tensor, buffer: TrajectoryBuffer,
                   y: Optional[torch.Tensor] = None,
                   resample: Optional[Sequence[Dict[str, Any]]] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One value update from the data batch ``img`` (B, C, H, W) and the
        newest trajectory of ``buffer``; returns the JAX trainer's metrics.
        Under ``value_resample``, ``resample[i]`` holds the keyword draws of
        the i-th sweep step's policy step (timestep T-1-i: ``noise``, and
        ``z`` for DDGANSampler), drawn from ``generator`` when None."""
        T = self.n_timesteps
        last = buffer.last()
        state, next_state, sigma = (last.state[0], last.next_state[0],
                                    last.sigma[0])
        betas = self.betas_for_q
        if self.adavelreg is not None:
            diff = ((next_state - state) ** 2).reshape(T, -1).mean(dim=1)
            if self.beta_ordering == "reversed":
                diff = torch.flip(diff, dims=(0,))
            betas = (betas.to(diff.device) * self.adavelreg
                     + (1 - self.adavelreg) * diff).detach()
        betas = betas.to(state.device)

        inputs = torch.cat([img, next_state[-1]], dim=0)
        t_term = torch.full((inputs.shape[0],), T, dtype=torch.long,
                            device=inputs.device)
        ys = torch.cat([y, y]) if y is not None else None
        out = self._v(inputs, t_term, ys)
        pos, neg = out[:img.shape[0]], out[img.shape[0]:]
        d_loss = pos.mean() - neg.mean()
        reg = torch.zeros((), device=out.device)
        if self.gamma is not None:
            reg = (pos ** 2).mean() + (neg ** 2).mean()
            d_loss = d_loss + self.gamma * reg
        self._value_step(d_loss, clip=False)

        B = state.shape[1]
        steps: Dict[str, List[torch.Tensor]] = {
            k: [] for k in ("v_loss", "running_cost", "value", "t")}
        traj_y = None if last.y is None else last.y[0]
        for i, t in enumerate(range(T - 1, -1, -1)):
            tvec = torch.full((B,), t, dtype=torch.long, device=state.device)
            with torch.no_grad():
                s_next, s_sigma = next_state[t], sigma[t]
                if self.value_resample:
                    # the policy step again, dropout on (``dxmi.py:475-488``)
                    d = self.sampler.sample_step(
                        state[t], tvec, generator=generator, train=True,
                        y=None if traj_y is None else traj_y[t],
                        **({} if resample is None else resample[i]))
                    s_next, s_sigma = d["sample"], d["sigma"]
                cost = self._running_cost(betas, state[t], s_next, tvec)
                entropy = self._entropy_of(s_sigma)
                target = self._v(s_next, tvec + 1, y) \
                    + self._time_cost_terms(tvec)
                if self.velocity_in_value is not None:
                    nt = (tvec < T - self.velocity_in_value).float()
                    target = target + cost * self.tau2 * nt
                if self.entropy_in_value is not None:
                    nt = (tvec < T - int(self.entropy_in_value)).float()
                    target = target - (entropy * self.tau1 * nt
                                       * self.entropy_value_scale)
            v = self._v(state[t], tvec, y)
            v_loss = ((v - target) ** 2).mean()
            self._value_step(v_loss, clip=self.value_grad_clip)
            for k, val in (("v_loss", v_loss), ("running_cost", cost.mean()),
                           ("value", v.mean()),
                           ("t", torch.tensor(t, device=v.device))):
                steps[k].append(val.detach())
        self.betas_for_q = betas
        per = {k: torch.stack(v) for k, v in steps.items()}
        metrics = {
            "ebm/d_loss_": d_loss.detach(), "ebm/v_loss_": per["v_loss"][-1],
            "ebm/pos_e_": pos.mean().detach(),
            "ebm/neg_e_": neg.mean().detach(),
            "ebm/running_cost_": per["running_cost"][-1],
            "ebm/reg_": reg.detach(), "per_step/t": per["t"],
            "per_step/running_cost": per["running_cost"],
            "per_step/value": per["value"], "per_step/v_loss": per["v_loss"]}
        if self.adavelreg is not None:
            metrics["per_step/betas_for_q"] = betas
        return metrics

    # ---- sampler (policy) update -----------------------------------------

    def minibatch_loss(self, flat: Dict[str, torch.Tensor],
                       idx: torch.Tensor, noise: Optional[torch.Tensor],
                       generator: Optional[torch.Generator] = None,
                       z: Optional[torch.Tensor] = None):
        """The policy loss of one minibatch of buffer rows ``idx``, with
        gradients through the re-run step (its ``noise``, and DDGAN's
        latents ``z``, drawn when None); returns (loss, v_term mean, cost
        mean, causal entropy mean)."""
        T = self.n_timesteps
        s, t = flat["state"][idx], flat["timestep"][idx]
        yb = flat["y"][idx] if "y" in flat else None
        d = self.sampler.sample_step(s, t, noise, yb, generator, train=True,
                                     **({} if z is None else {"z": z}))
        cost = self._running_cost(self.betas_for_q.to(s.device), s,
                                  d["sample"], t)
        causal_entropy = torch.log(d["sigma"])
        v_term = self._v(d["sample"], t + 1, yb)
        nt = (t < T - self.skip_sampler_tau).float()
        loss = (v_term + (cost * self.tau2 - causal_entropy * self.tau1)
                * nt).mean()
        return loss, v_term.mean(), cost.mean(), causal_entropy.mean()

    def sampler_grads(self, loss: torch.Tensor) -> List[torch.Tensor]:
        """d loss / d (net parameters, log_betas), in that order (zeros for
        a parameter the loss does not reach)."""
        params = self.net_params + [self.sampler.log_betas]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for g, p in zip(grads, params)]

    def update_sampler(self, buffer: TrajectoryBuffer,
                       n_generator: Optional[int] = 1,
                       perm: Optional[torch.Tensor] = None,
                       noise: Optional[Sequence[torch.Tensor]] = None,
                       generator: Optional[torch.Generator] = None,
                       z: Optional[Sequence[torch.Tensor]] = None
                       ) -> Dict[str, torch.Tensor]:
        """G = ``n_generator`` minibatches (None: every minibatch of the
        buffer) of a permutation of its rows (``perm``, or drawn from
        ``generator``), each one optimizer step; ``noise[i]`` and ``z[i]``
        are the i-th re-run step's noise and DDGAN latents (drawn when
        None)."""
        flat = buffer.flat()
        N = flat["state"].shape[0]
        B = self.batchsize
        G = N // B if n_generator is None else int(n_generator)
        G = min(G, max(N // B, 1))
        if perm is None:
            perm = torch.randperm(N, generator=generator,
                                  device=generator.device if generator
                                  is not None else "cpu")
        perm = perm.to(flat["state"].device)
        for i in range(G):
            loss, v_term, cost, ent = self.minibatch_loss(
                flat, perm[i * B:(i + 1) * B],
                None if noise is None else noise[i], generator,
                None if z is None else z[i])
            grads = self.sampler_grads(loss)
            if self.sampler_grad_clip is not None:
                grads = clip_by_global_norm(grads, self.sampler_grad_clip)
            groups = [grads[:-1], grads[-1:]]
            if self.guard is not None:
                self.guard.step(groups)
            else:
                self.opt_net.step(groups[0])
                self.opt_betas.step(groups[1])
        return {"sampler/sampler_loss_": loss.detach(),
                "sampler/sampler_value_loss_": v_term.detach(),
                "sampler/running_cost_": cost.detach(),
                "sampler/causal_entropy_": ent.detach(),
                "per_step/sigma": torch.exp(self.sampler.log_betas.detach())}

    @property
    def nan_guard_skips(self) -> int:
        """Sampler updates the non-finite guard has skipped so far."""
        return 0 if self.guard is None else self.guard.total_notfinite


def train_step(trainer: DxMITrainer, x: torch.Tensor,
               y: Optional[torch.Tensor], generator: torch.Generator,
               n_generator: Optional[int] = None) -> Dict[str, Any]:
    """One DxMI iteration (``dxmi.py:303-336``): a trajectory of
    ``trainer.batchsize`` samples in ``trainer.sample_chunks`` chunks, the
    buffer, ``update_f_v`` on the data batch ``x`` (labels ``y`` or None),
    then ``update_sampler`` with ``n_generator`` minibatches (None: the
    trainer's own default, one for ``DxMITrainer``, the full buffer for
    ``DxMITrainerCond``). Returns the metrics of both phases and each phase's
    host seconds (after a device synchronize) under ``time/``."""
    sync = (torch.cuda.synchronize if x.device.type == "cuda"
            else (lambda: None))
    t0 = time.perf_counter()
    with torch.no_grad():
        d_sample = sample_chunked(trainer.sampler, trainer.batchsize,
                                  trainer.sample_chunks, generator)
    traj = from_d_sample(d_sample)
    sync()
    t1 = time.perf_counter()
    m_energy = trainer.update_f_v(x, traj, y=y, generator=generator)
    sync()
    t2 = time.perf_counter()
    kw = {} if n_generator is None else {"n_generator": n_generator}
    m_sampler = trainer.update_sampler(traj, generator=generator, **kw)
    sync()
    t3 = time.perf_counter()
    return {**m_energy, **m_sampler, "time/sample": t1 - t0,
            "time/update_f_v": t2 - t1, "time/update_sampler": t3 - t2}
