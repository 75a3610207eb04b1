"""Agent base: likelihood-ratio policy gradient and the train step.

Twin of ``mjrl_tpu/algos/base.py`` (``BatchREINFORCE``): the CPI surrogate
``mean(LR * adv)``, its gradient, the masked mean KL between old and new
policies, ``process_batch`` (returns, GAE, advantage normalization) and the
running-score EMA. The agent owns the policy and baseline modules; the
functional parameter dicts that the updates build go through
``torch.func.functional_call``.

``sample_mode="trajectories"`` samples one fresh episode per env row;
``"samples"`` runs the auto-reset sampler over windows of
``num_samples / num_traj`` steps, with the rows persisting across train
steps in a carry held on the agent.

Under data parallelism (``parallel/dist.py``) the agent holds this rank's
block of the ``num_traj`` rows and its carry; every mean over steps has
the global denominator (:meth:`BatchREINFORCE.valid_count`), each rank
differentiates its own numerator over it, and the gradient, the surrogate
and the KL are all-reduced outside ``torch.func``'s transforms, which
cannot trace a collective.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.func import functional_call

from mjrl_tpu_torch.envs.base import Env, EnvState
from mjrl_tpu_torch.models.baselines import Baseline
from mjrl_tpu_torch.models.gaussian_mlp import GaussianMLP
from mjrl_tpu_torch.ops.distributions import DiagGaussian
from mjrl_tpu_torch.ops.gae import compute_advantages, compute_returns, masked_mean_std
from mjrl_tpu_torch.parallel import dist
from mjrl_tpu_torch.samplers.rollout import (
    SamplerCarry,
    init_autoreset_carry,
    rollout_statistics,
    sample_autoreset,
    sample_episodes,
)
from mjrl_tpu_torch.types import TrajectoryBatch
from mjrl_tpu_torch.utils import trace

Params = Dict[str, torch.Tensor]


def masked_surrogate(new_mean: torch.Tensor, new_log_std: torch.Tensor,
                     batch: TrajectoryBatch, n: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CPI surrogate ``sum(LR * adv) / n`` over valid steps of the policy
    with outputs ``new_mean, new_log_std`` on ``batch.observations``; ``n``
    defaults to the batch's valid steps (at least 1)."""
    lr = DiagGaussian.likelihood_ratio(batch.actions, new_mean, new_log_std,
                                       batch.mean, batch.log_std)
    validf = batch.valid.to(lr.dtype)
    if n is None:
        n = torch.clamp(validf.sum(), min=1.0)
    return torch.sum(lr * batch.advantages * validf) / n


def masked_kl(old_mean: torch.Tensor, old_log_std: torch.Tensor, new_mean: torch.Tensor,
              new_log_std: torch.Tensor, valid: torch.Tensor,
              weights: Optional[torch.Tensor] = None,
              n: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sum(KL(old || new)) / n`` over the valid states, each weighted by
    ``weights`` (same shape as ``valid``) where given; ``n`` defaults to
    the sum of those weights (at least 1)."""
    kl = DiagGaussian.kl(old_mean, old_log_std, new_mean, new_log_std)
    w = valid.to(kl.dtype)
    if weights is not None:
        w = w * weights
    if n is None:
        n = torch.clamp(w.sum(), min=1.0)
    return torch.sum(kl * w) / n


class BatchREINFORCE:
    """Policy-gradient machinery shared by the agents, and the ``reinforce``
    agent itself: its ``update`` is the vanilla PG step ``params +=
    learn_rate * vpg`` (reference default ``learn_rate=0.01``); subclasses
    (NPG, TRPO, PPO) override it. Hyperparameter names and defaults follow
    the reference."""

    def __init__(self, env: Env, policy: GaussianMLP, baseline: Baseline,
                 learn_rate: float = 0.01, num_traj: int = 64, num_samples: Optional[int] = None,
                 horizon: Optional[int] = None, gamma: float = 0.995,
                 gae_lambda: Optional[float] = 0.97, sample_mode: str = "trajectories",
                 normalize_advantages: bool = True, adv_norm_eps: float = 1e-6):
        if sample_mode not in ("trajectories", "samples"):
            raise ValueError(f"sample_mode {sample_mode!r}")
        self.env = env
        self.policy = policy
        self.baseline = baseline
        self.learn_rate = learn_rate
        self.num_traj = num_traj
        self.num_samples = num_samples
        self.sample_mode = sample_mode
        self.horizon = horizon or env.spec.horizon
        self.gamma = gamma
        self.gae_lambda = gae_lambda
        self.normalize_advantages = normalize_advantages
        self.adv_norm_eps = adv_norm_eps
        self.iteration = 0
        self.running_score = torch.zeros((), device=env.device)
        # samples mode: the rows persist across train steps, so short windows
        # still visit the whole episode's states (created at first use)
        self.sampler_carry: Optional[SamplerCarry] = None

    def reset_sampler_carry(self) -> None:
        """Drop the persistent sampler carry; the next step starts the rows
        from reset."""
        self.sampler_carry = None

    # -- the train state -----------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """The full train state: policy, baseline and its optimizer (None
        for a baseline without one: the least-squares fits), iteration,
        running score and the sampler carry (None until samples mode makes
        one). Its tensors are the live ones, not copies, but for the
        carry's under data parallelism: every rank's rows, gathered (a
        collective, so every rank calls this together), so that the state
        is the single-rank run's whatever the number of ranks."""
        carry = self.sampler_carry
        optimizer = getattr(self.baseline, "optimizer", None)
        return {
            "policy": self.policy.state_dict(),
            "baseline": self.baseline.state_dict(),
            "baseline_optimizer": None if optimizer is None else optimizer.state_dict(),
            "iteration": self.iteration,
            "running_score": self.running_score,
            "sampler_carry": None if carry is None else {
                k: dist.gather_rows(v) for k, v in dict(
                    **carry.state._asdict(), obs=carry.obs, t_in_ep=carry.t_in_ep,
                    ep_return=carry.ep_return, ep_success=carry.ep_success).items()},
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """The state of :meth:`state_dict`; the carry's rows are all the
        run's, of which this rank keeps its block."""
        self.load_policy_and_baseline(state)
        self.iteration = int(state["iteration"])
        self.running_score = state["running_score"].to(self.env.device)
        c = state["sampler_carry"]
        state_type = getattr(self.env, "state_type", EnvState)
        if c is not None:
            c = {k: None if v is None else dist.local_rows(v) for k, v in c.items()}
        self.sampler_carry = None if c is None else SamplerCarry(
            state_type(*(c[f] for f in state_type._fields)), c["obs"], c["t_in_ep"],
            c["ep_return"], c.get("ep_success"))

    def load_policy_and_baseline(self, state: Dict[str, Any]) -> None:
        """The policy's parameters and buffers, the baseline's state and its
        optimizer's from a :meth:`state_dict`."""
        self.policy.load_state_dict(state["policy"])
        self.baseline.load_state_dict(state["baseline"])
        if state["baseline_optimizer"] is not None:
            self.baseline.optimizer.load_state_dict(state["baseline_optimizer"])

    # -- parameters as dicts ---------------------------------------------
    def params(self) -> Params:
        return {k: v.detach() for k, v in self.policy.named_parameters()}

    def load_params(self, params: Params) -> None:
        with torch.no_grad():
            for k, p in self.policy.named_parameters():
                p.copy_(params[k])

    def apply(self, params: Params, obs: torch.Tensor):
        return functional_call(self.policy, params, (obs,))

    # -- core math ---------------------------------------------------------
    def valid_count(self, batch: TrajectoryBatch,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The masked means' denominator: the valid steps of every rank's
        rows, each weighted by ``weights`` ``(N, T)`` where given, at
        least 1."""
        w = batch.valid.to(batch.advantages.dtype)
        if weights is not None:
            w = w * weights
        return torch.clamp(dist.all_sum(w.sum()), min=1.0)

    def local_surrogate(self, params: Params, batch: TrajectoryBatch,
                        n: torch.Tensor) -> torch.Tensor:
        """This rank's share of the surrogate: its steps' sum over ``n``."""
        return masked_surrogate(*self.apply(params, batch.observations), batch, n)

    def surrogate(self, params: Params, batch: TrajectoryBatch,
                  n: Optional[torch.Tensor] = None) -> torch.Tensor:
        """CPI surrogate ``mean(LR * adv)`` over valid steps; ``n`` is
        :meth:`valid_count` where the caller has it."""
        n = self.valid_count(batch) if n is None else n
        return dist.all_sum(self.local_surrogate(params, batch, n))

    def local_kl(self, params: Params, old_params: Params, batch: TrajectoryBatch,
                 weights: Optional[torch.Tensor], n: torch.Tensor) -> torch.Tensor:
        """This rank's share of :meth:`mean_kl`: its states' sum over ``n``."""
        new_mean, new_log_std = self.apply(params, batch.observations)
        old = {k: v.detach() for k, v in old_params.items()}
        return masked_kl(*self.apply(old, batch.observations), new_mean, new_log_std, batch.valid,
                         weights, n)

    def mean_kl(self, params: Params, old_params: Params, batch: TrajectoryBatch,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Masked mean ``KL(old || new)`` over states, weighted by
        ``weights`` ``(N, T)`` where given; ``old_params`` are constants."""
        n = self.valid_count(batch, weights)
        return dist.all_sum(self.local_kl(params, old_params, batch, weights, n))

    def vpg_grad(self, params: Params, batch: TrajectoryBatch,
                 n: Optional[torch.Tensor] = None) -> Params:
        """The surrogate's gradient: each rank's share differentiated, then
        summed over the ranks."""
        n = self.valid_count(batch) if n is None else n
        grads = torch.func.grad(self.local_surrogate)(params, batch, n)
        return dist.all_sum_dict(grads)

    # -- post-processing -----------------------------------------------------
    @torch.no_grad()
    def process_batch(self, batch: TrajectoryBatch) -> TrajectoryBatch:
        """compute_returns + compute_advantages + normalization."""
        values = self.baseline.predict(batch.observations, batch.time)
        # samples mode: a window's tail bootstraps the return with V(s_last)
        bootstrap = values[:, -1] if self.sample_mode == "samples" else None
        batch = batch.replace(returns=compute_returns(batch.rewards, batch.done, batch.valid,
                                                      self.gamma, bootstrap_value=bootstrap))
        batch = compute_advantages(batch, values, self.gamma, self.gae_lambda, normalize=False)
        if self.normalize_advantages:
            mean, std = masked_mean_std(batch.advantages, batch.valid, eps=0.0)
            adv = (batch.advantages - mean) / (std + self.adv_norm_eps)
            batch = batch.replace(advantages=adv * batch.valid.to(adv.dtype))
        return batch

    def update(self, batch: TrajectoryBatch,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One policy update on a processed batch; returns its metrics.
        ``generator`` draws whatever randomness the update has (PPO's
        minibatch order, NPG's ``hvp_sample_frac`` mask). Here the vanilla
        PG step ``params += learn_rate * vpg``, then ``project``."""
        params = self.params()
        n = self.valid_count(batch)
        surr_before = self.surrogate(params, batch, n)
        grads = self.vpg_grad(params, batch, n)
        new_params = self.policy.project({k: p + self.learn_rate * grads[k]
                                          for k, p in params.items()})
        kl_dist = self.mean_kl(new_params, params, batch)
        surr_after = self.surrogate(new_params, batch, n)
        self.load_params(new_params)
        return {
            "alpha": torch.full((), self.learn_rate, device=self.env.device),
            "kl_dist": kl_dist,
            "surr_improvement": (surr_after - surr_before).detach(),
        }

    # -- the train step ------------------------------------------------------
    def train_step(self, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One on-policy iteration: sample -> returns/GAE -> update ->
        baseline fit -> statistics. Metrics stay on the device. In samples
        mode the rows continue from the agent's carry. ``num_traj`` counts
        every rank's rows, of which this rank samples its block. Traced, the
        iteration is the root span ``train_step`` over ``sample``,
        ``process_batch``, ``update``, ``fit`` and ``statistics``."""
        with trace.span("train_step"):
            with trace.span("sample"):
                if self.sample_mode == "trajectories":
                    batch = sample_episodes(self.env, self.policy, self.num_traj, self.horizon,
                                            generator)
                else:
                    if self.sampler_carry is None:
                        self.sampler_carry = init_autoreset_carry(self.env, self.num_traj,
                                                                  generator)
                    window = -(-int(self.num_samples) // self.num_traj)
                    batch, self.sampler_carry = sample_autoreset(
                        self.env, self.policy, self.sampler_carry, window, self.horizon, generator)
            return self.finish_train_step(batch, generator=generator)

    def finish_train_step(self, batch: TrajectoryBatch,
                          generator: Optional[torch.Generator] = None,
                          fit_perms: Optional[List[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Everything after sampling; ``fit_perms`` fixes the baseline's
        minibatch order (else drawn from ``generator``)."""
        with trace.span("process_batch"):
            batch = self.process_batch(batch)
        with trace.span("update"):
            update_metrics = self.update(batch, generator=generator)
        with trace.span("fit"):
            vf_metrics = self.baseline.fit(batch, generator=generator, perms=fit_perms)
        with trace.span("statistics"):
            stats = rollout_statistics(batch)
            # the EMA seeds at the first iteration that completes an episode;
            # running_score == 0 is the unseeded sentinel
            seeded = torch.where(self.running_score == 0.0, stats.mean,
                                 0.9 * self.running_score + 0.1 * stats.mean)
            self.running_score = torch.where(stats.num_episodes > 0, seeded, self.running_score)
        self.iteration += 1
        return {
            "stoc_pol_mean": stats.mean,
            "stoc_pol_std": stats.std,
            "stoc_pol_max": stats.max,
            "stoc_pol_min": stats.min,
            "success_rate": stats.success_rate,
            "running_score": self.running_score,
            "num_samples": dist.all_sum(batch.num_valid),
            **update_metrics,
            **vf_metrics,
        }
