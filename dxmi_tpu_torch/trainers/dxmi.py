"""The DxMI trainer (``dxmi_tpu.trainers.dxmi.DxMITrainer``) in PyTorch: the
value + energy update, the policy update and value-guided sampling.

``update_f_v`` (``dxmi.py:343-581``): the adaptive velocity regularisation of
``betas_for_q`` (``adavelreg``), one contrastive energy step at the terminal
timestep (with the ``gamma`` square penalty) on the value, or on the
separate energy net ``f`` when one is set, then ``repeat_value_update``
TD sweeps, one optimizer step per sweep step, in ``value_update_order``:
``backward`` (T-1 down to 0), ``random`` (a fresh permutation of the
timesteps each repeat) or ``shuffle`` (minibatches of B rows of one
permutation of the newest trajectory's T*B rows, mixed timesteps, shared by
the repeats). The sweep stays sequential, as the reference's semantics need
(``dxmi.py:6-10``), with the ``value_grad_clip`` scaling to global norm 0.1.
With ``value_resample`` each sweep step re-runs the policy step on its
states, the net in training mode and without gradient, and its sample and
sigma take the place of the trajectory's next state and sigma
(``dxmi.py:475-488``), with fresh draws in every repeat. With ``f`` the
target of the terminal step is f(x_T) (``dxmi.py:504-515``). ``aug`` (a
callable ``aug(x, draw)``) augments the energy step's inputs and both value
inputs of each sweep step after the running cost (``dxmi.py:367-369``,
``:492-497``).

``train_step`` composes one iteration as ``_train_step_impl`` does
(``dxmi.py:303-336``): sample a trajectory (``sample_chunked``), the buffer,
``update_f_v``, ``update_sampler``.

``update_sampler`` (``dxmi.py:587-666``): a permutation of the flat buffer, G
minibatches of B rows; each re-runs one policy step with gradients and
descends V(x_{t+1}) (f at the last step when set, the next state through
``aug``) + (tau2 cost - tau1 log sigma) [t < T - skip_sampler_tau] with
the sampler optimizer (Adam or RAdam, a separate rate for ``log_betas``,
optionally the 0.1 global-norm clip and the non-finite guard).

``sample_guidance`` (``dxmi.py:672-727``): a trajectory in which each policy
step's sample moves along grad_x V(x, t+1) times ``guidance_scale`` times the
step's sigma (at the timesteps of ``t_select``, or all), from a prior
scaled by the policy's ``sigma_max``.

Torch cannot reproduce threefry draws, so every draw comes from a
``torch.Generator`` or is injected: the permutations (``perm``, ``order``),
the noise (``noise``, ``resample``; DDGAN's latents ``z``), the second
argument of each ``aug`` call (``aug_draws``), and dropout masks through
the net's ``inject_dropout_masks``: the tests replay the JAX trainer's
draws that way.

A spectral-norm value or energy (``models/igebm.py``) keeps its power
iteration in buffers, JAX's ``v_stats`` and ``f_stats``: as ``_v_apply``
and ``_f_apply`` thread them (``dxmi.py:238-270``), they are stored only by
the energy step's forward (of the value, or of f when set) and by each TD
step's forward of the value at the current state; every other forward
(the TD targets, ``update_sampler``, ``sample_guidance``) reads them.

Parameters are updated in place; the trainer keeps ``betas_for_q`` and the
optimizer states, which ``utils/train_state.py`` lays out as the JAX
package's ``DxMIState``.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from dxmi_tpu_torch.models.igebm import update_sn_stats
from dxmi_tpu_torch.samplers import sample_chunked
from dxmi_tpu_torch.samplers.var import gaussian_logp_mean
from dxmi_tpu_torch.schedules import make_beta_schedule
from dxmi_tpu_torch.trainers.buffer import TrajectoryBuffer, from_d_sample
from dxmi_tpu_torch.trainers.optim import (Adam, ApplyIfFinite, RAdam,
                                           clip_by_global_norm, global_norm)


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).mean(dim=1)


VALUE_ORDERS = ("backward", "shuffle", "random")


def _gen_device(generator: Optional[torch.Generator]):
    return generator.device if generator is not None else "cpu"


class _Draws:
    """The injected draws of one kind, taken in call order, or the
    generator's when none were given."""

    def __init__(self, injected: Optional[Sequence[Any]]):
        self.it = None if injected is None else iter(injected)

    def next(self, default: Any = None) -> Any:
        return default if self.it is None else next(self.it)


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
        if value_update_order not in VALUE_ORDERS:
            raise ValueError(f"value_update_order={value_update_order!r}")
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
        self.value_update_order = value_update_order
        self.repeat_value_update = int(repeat_value_update)
        self.aug = aug
        self.sampler_grad_clip: Optional[float] = 0.1
        self.nan_guard = False
        self.sampler_optimizer = "adam"
        self.sampler = self.value = self.energy = None
        self.guidance_scale: Optional[float] = None

    # ---- setup ----------------------------------------------------------

    def set_models(self, sampler, value, lr: float, v_lr: float,
                   beta_lr: Optional[float] = None, energy=None,
                   f_lr: Optional[float] = None) -> None:
        """Bind the sampler and value modules and build the optimizers:
        ``log_betas`` gets its own rate (the ``multi_transform`` of
        ``dxmi.py:168-176``); with ``nan_guard`` the sampler's step is
        ``apply_if_finite(..., 100)``. ``energy`` is the optional separate
        energy net f (an image -> scalar module), trained by Adam at
        ``f_lr`` (``v_lr`` when None). Also initialises ``betas_for_q``."""
        self.sampler, self.value, self.energy = sampler, value, energy
        if energy is not None:
            self.opt_f = Adam(list(energy.parameters()),
                              v_lr if f_lr is None else f_lr)
        opt = {"adam": Adam, "radam": RAdam}[self.sampler_optimizer]
        self.net_params = [p for p in sampler.net.parameters()]
        self.opt_net = opt(self.net_params, lr)
        self.opt_betas = opt([sampler.log_betas],
                             lr if beta_lr is None else beta_lr)
        self.guard = (ApplyIfFinite([self.opt_net, self.opt_betas], 100)
                      if self.nan_guard else None)
        self.opt_v = Adam(list(value.parameters()), v_lr)
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

    def _f(self, x) -> torch.Tensor:
        return self.energy(x).squeeze(-1)

    def _aug(self, x: torch.Tensor, draws: _Draws,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        return x if self.aug is None else self.aug(x, draws.next(generator))

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

    def _value_step(self, loss: torch.Tensor, clip: bool, opt=None) -> None:
        opt = self.opt_v if opt is None else opt
        grads = torch.autograd.grad(loss, opt.params)
        if clip:
            scale = torch.clamp(0.1 / (global_norm(grads) + 1e-12), max=1.0)
            grads = [g * scale for g in grads]
        opt.step(grads)

    # ---- value / energy update -------------------------------------------

    def update_f_v(self, img: torch.Tensor, buffer: TrajectoryBuffer,
                   y: Optional[torch.Tensor] = None,
                   resample: Optional[Sequence[Dict[str, Any]]] = None,
                   generator: Optional[torch.Generator] = None,
                   perm: Optional[torch.Tensor] = None,
                   order: Optional[Sequence[torch.Tensor]] = None,
                   aug_draws: Optional[Sequence[Any]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One value update from the data batch ``img`` (B, C, H, W) and the
        newest trajectory of ``buffer``; returns the JAX trainer's metrics
        (the per-step ones of the last repeat). Injected draws, each drawn
        from ``generator`` when None: ``perm`` the ``shuffle`` order's
        permutation of the T*B rows; ``order[rep]`` the ``random`` order's
        permutation of the timesteps in repeat ``rep``; under
        ``value_resample``, ``resample[rep * T + i]`` the keyword draws of
        the policy step of sweep step i of repeat ``rep`` (``noise``, and
        ``z`` for DDGANSampler); ``aug_draws`` the second argument of each
        ``aug`` call in call order (the energy step's, then each sweep
        step's state and next state)."""
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
        augs = _Draws(aug_draws)
        resamples = _Draws(resample)

        inputs = torch.cat([img, next_state[-1]], dim=0)
        t_term = torch.full((inputs.shape[0],), T, dtype=torch.long,
                            device=inputs.device)
        ys = torch.cat([y, y]) if y is not None else None
        inputs = self._aug(inputs, augs, generator)
        with update_sn_stats(self.value if self.energy is None
                             else self.energy):
            out = (self._v(inputs, t_term, ys) if self.energy is None
                   else self._f(inputs))
        pos, neg = out[:img.shape[0]], out[img.shape[0]:]
        d_loss = pos.mean() - neg.mean()
        reg = torch.zeros((), device=out.device)
        if self.gamma is not None:
            reg = (pos ** 2).mean() + (neg ** 2).mean()
            d_loss = d_loss + self.gamma * reg
        self._value_step(d_loss, clip=False,
                         opt=None if self.energy is None else self.opt_f)

        B = state.shape[1]
        traj_y = None if last.y is None else last.y[0]
        if self.value_update_order == "shuffle" and perm is None:
            perm = torch.randperm(T * B, generator=generator,
                                  device=_gen_device(generator))
        per: Dict[str, torch.Tensor] = {}
        for rep in range(self.repeat_value_update):
            rep_order = None
            if self.value_update_order == "random":
                rep_order = (order[rep] if order is not None else
                             torch.randperm(T, generator=generator,
                                            device=_gen_device(generator)))
            xs, labels = self._sweep(state, next_state, sigma, traj_y, perm,
                                     rep_order)
            steps: Dict[str, List[torch.Tensor]] = {
                k: [] for k in ("v_loss", "running_cost", "value")}
            for i in range(T):
                v_loss, cost, v = self._td_step(
                    {k: a[i] for k, a in xs.items()}, betas, y, resamples,
                    augs, generator)
                for k, val in (("v_loss", v_loss), ("running_cost", cost),
                               ("value", v)):
                    steps[k].append(val)
            per = {k: torch.stack(v) for k, v in steps.items()}
            per["t"] = labels
        self.betas_for_q = betas
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

    def _sweep(self, state, next_state, sigma, traj_y, perm, rep_order):
        """The sweep's rows in update order (``sweep_xs``,
        ``dxmi.py:437-471``): a dict of (T, B, ...) arrays whose i-th entry
        is sweep step i's rows, with each row's timestep ``tvec``, and the
        timestep labels of the metrics."""
        T, B = state.shape[:2]
        dev = state.device
        xs = {"state": state, "next_state": next_state, "sigma": sigma,
              "tvec": torch.arange(T, device=dev)[:, None].expand(T, B)}
        if traj_y is not None:
            xs["traj_y"] = traj_y
        backward = torch.arange(T - 1, -1, -1, device=dev)
        if self.value_update_order == "shuffle":
            p = perm.to(dev)
            xs = {k: a.reshape(T * B, *a.shape[2:])[p].reshape(a.shape)
                  for k, a in xs.items()}
            return xs, backward
        idx = backward if rep_order is None else rep_order.to(dev)
        return {k: a[idx] for k, a in xs.items()}, idx

    def _td_step(self, x, betas, y, resamples, augs, generator):
        """One sweep step (``td_step``, ``dxmi.py:473-545``) on the rows of
        ``x``; returns (v_loss, the running cost's mean, the value's mean),
        detached."""
        T = self.n_timesteps
        tvec = x["tvec"]
        with torch.no_grad():
            s_next, s_sigma = x["next_state"], x["sigma"]
            if self.value_resample:
                # the policy step again, dropout on (``dxmi.py:475-488``)
                d = self.sampler.sample_step(
                    x["state"], tvec, generator=generator, train=True,
                    y=x.get("traj_y"), **resamples.next({}))
                s_next, s_sigma = d["sample"], d["sigma"]
            cost = self._running_cost(betas, x["state"], s_next, tvec)
            entropy = self._entropy_of(s_sigma)
            v_state_in = self._aug(x["state"], augs, generator)
            v_next_in = self._aug(s_next, augs, generator)
            v_next = self._v(v_next_in, tvec + 1, y)
            if self.energy is not None:
                term = (tvec == T - 1).float()
                v_next = v_next * (1 - term) + self._f(v_next_in) * term
            target = v_next + self._time_cost_terms(tvec)
            if self.velocity_in_value is not None:
                nt = (tvec < T - self.velocity_in_value).float()
                target = target + cost * self.tau2 * nt
            if self.entropy_in_value is not None:
                nt = (tvec < T - int(self.entropy_in_value)).float()
                target = target - (entropy * self.tau1 * nt
                                   * self.entropy_value_scale)
        with update_sn_stats(self.value):
            v = self._v(v_state_in, tvec, y)
        v_loss = ((v - target) ** 2).mean()
        self._value_step(v_loss, clip=self.value_grad_clip)
        return v_loss.detach(), cost.mean(), v.mean().detach()

    # ---- sampler (policy) update -----------------------------------------

    def minibatch_loss(self, flat: Dict[str, torch.Tensor],
                       idx: torch.Tensor, noise: Optional[torch.Tensor],
                       generator: Optional[torch.Generator] = None,
                       z: Optional[torch.Tensor] = None,
                       aug_draw: Any = None):
        """The policy loss of one minibatch of buffer rows ``idx``, with
        gradients through the re-run step (its ``noise``, and DDGAN's
        latents ``z``, drawn when None; ``aug_draw`` the second argument of
        ``aug``, the generator when None); returns (loss, v_term mean, cost
        mean, causal entropy mean)."""
        T = self.n_timesteps
        s, t = flat["state"][idx], flat["timestep"][idx]
        yb = flat["y"][idx] if "y" in flat else None
        d = self.sampler.sample_step(s, t, noise, yb, generator, train=True,
                                     **({} if z is None else {"z": z}))
        cost = self._running_cost(self.betas_for_q.to(s.device), s,
                                  d["sample"], t)
        causal_entropy = torch.log(d["sigma"])
        nxt = d["sample"]
        if self.aug is not None:
            nxt = self.aug(nxt, generator if aug_draw is None else aug_draw)
        v_term = self._v(nxt, t + 1, yb)
        if self.energy is not None:
            term = (t == T - 1).float()
            v_term = v_term * (1 - term) + self._f(nxt) * term
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
                       z: Optional[Sequence[torch.Tensor]] = None,
                       aug_draws: Optional[Sequence[Any]] = None
                       ) -> Dict[str, torch.Tensor]:
        """G = ``n_generator`` minibatches (None: every minibatch of the
        buffer) of a permutation of its rows (``perm``, or drawn from
        ``generator``), each one optimizer step; ``noise[i]``, ``z[i]`` and
        ``aug_draws[i]`` are the i-th re-run step's noise, DDGAN latents and
        ``aug`` draw (from ``generator`` when None)."""
        flat = buffer.flat()
        N = flat["state"].shape[0]
        B = self.batchsize
        G = N // B if n_generator is None else int(n_generator)
        G = min(G, max(N // B, 1))
        if perm is None:
            perm = torch.randperm(N, generator=generator,
                                  device=_gen_device(generator))
        perm = perm.to(flat["state"].device)
        for i in range(G):
            loss, v_term, cost, ent = self.minibatch_loss(
                flat, perm[i * B:(i + 1) * B],
                None if noise is None else noise[i], generator,
                None if z is None else z[i],
                None if aug_draws is None else aug_draws[i])
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

    # ---- value-guided sampling ------------------------------------------

    def sample_guidance(self, n_sample: int,
                        guidance_scale: Optional[float] = None,
                        x0: Optional[torch.Tensor] = None,
                        t_select: Optional[Sequence[int]] = None,
                        y: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[Sequence[torch.Tensor]] = None,
                        z: Optional[Sequence[torch.Tensor]] = None
                        ) -> Dict[str, Any]:
        """Sample with value-gradient guidance (``dxmi.py:672-727``): after
        each policy step (the net in eval mode, no gradient), its sample
        moves by grad_x V(x, t+1) (the gradient of the value's sum, without
        labels) times ``guidance_scale`` (the trainer's when None) times the
        step's sigma, at the steps of ``t_select`` (all when None). ``x0``
        is the prior (N(0, I) times the policy's ``sigma_max``, 1 when it
        has none, drawn when None); ``y`` the class labels each step gets;
        ``noise[t]`` and ``z[t]`` the steps' draws. Returns JAX's dict:
        sample, l_sample (T+1, B, ...), logp and logp_on (T, B) (the
        latter of the guided sample under the step's policy), their sums
        over the steps (``logp_traj``, ``logp_on_traj``), guidance (T, B,
        ...) and y."""
        if guidance_scale is None:
            guidance_scale = self.guidance_scale
        sampler = self.sampler
        if x0 is None:
            x0 = torch.randn((n_sample, *sampler.sample_shape),
                             generator=generator,
                             device=sampler.log_betas.device) \
                * float(getattr(sampler, "sigma_max", 1.0))
        xs, logp, logp_on, guid = [x0], [], [], []
        for t in range(self.n_timesteps):
            step = self.guided_step(
                xs[-1], t, guidance_scale, None if noise is None else noise[t],
                y=y, generator=generator, z=None if z is None else z[t],
                guide=t_select is None or t in t_select)
            logp.append(step["logp"])
            logp_on.append(step["logp_on"])
            guid.append(step["guidance"])
            xs.append(step["sample"])
        logp, logp_on = torch.stack(logp), torch.stack(logp_on)
        return {"sample": xs[-1], "l_sample": torch.stack(xs),
                "logp": logp, "logp_on": logp_on,
                "logp_traj": logp.sum(dim=0),
                "logp_on_traj": logp_on.sum(dim=0),
                "guidance": torch.stack(guid), "y": y}

    def guided_step(self, x: torch.Tensor, t: int, guidance_scale: float,
                    noise: Optional[torch.Tensor] = None,
                    y: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    z: Optional[torch.Tensor] = None,
                    guide: bool = True) -> Dict[str, torch.Tensor]:
        """One step of ``sample_guidance`` from ``x`` at step ``t``: the
        policy step (eval mode, no gradient), then, with ``guide``, its
        sample moved by grad_x V(sample, t+1) * guidance_scale * sigma.
        Returns sample (the moved one), guidance, logp (the policy's) and
        logp_on (of the moved sample under the step's policy)."""
        tvec = torch.full((x.shape[0],), t, dtype=torch.long,
                          device=x.device)
        kw = {} if z is None else {"z": z}
        with torch.no_grad():
            d = self.sampler.sample_step(x, tvec, noise, y=y,
                                         generator=generator, **kw)
        nxt = d["sample"].detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(self._v(nxt, tvec + 1).sum(), nxt)
        sigma = d["sigma"].reshape(-1, *([1] * (x.dim() - 1)))
        guidance = g * guidance_scale * sigma
        nxt = nxt.detach()
        if guide:
            nxt = nxt + guidance
        return {"sample": nxt, "guidance": guidance, "logp": d["logp"],
                "logp_on": gaussian_logp_mean(nxt, d["mean"], sigma)}

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
