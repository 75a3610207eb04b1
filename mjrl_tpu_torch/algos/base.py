"""Agent base: likelihood-ratio policy gradient and the train step.

Twin of ``mjrl_tpu/algos/base.py`` (``BatchREINFORCE``, trajectories mode):
the CPI surrogate ``mean(LR * adv)``, its gradient, the masked mean KL
between old and new policies, ``process_batch`` (returns, GAE, advantage
normalization) and the running-score EMA. The agent owns the policy and
baseline modules; the functional parameter dicts that the updates build go
through ``torch.func.functional_call``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch.func import functional_call

from mjrl_tpu_torch.envs.locomotion import LocomotionEnv
from mjrl_tpu_torch.models.baselines import Baseline
from mjrl_tpu_torch.models.gaussian_mlp import GaussianMLP
from mjrl_tpu_torch.ops.distributions import DiagGaussian
from mjrl_tpu_torch.ops.gae import compute_advantages, compute_returns, masked_mean_std
from mjrl_tpu_torch.samplers.rollout import rollout_statistics, sample_episodes
from mjrl_tpu_torch.types import TrajectoryBatch

Params = Dict[str, torch.Tensor]


class BatchREINFORCE:
    """Policy-gradient machinery shared by the agents; subclasses (NPG)
    define ``update``. Hyperparameter names and defaults follow the
    reference."""

    def __init__(self, env: LocomotionEnv, policy: GaussianMLP, baseline: Baseline,
                 num_traj: int = 64, horizon: Optional[int] = None,
                 gamma: float = 0.995, gae_lambda: Optional[float] = 0.97,
                 normalize_advantages: bool = True, adv_norm_eps: float = 1e-6):
        self.env = env
        self.policy = policy
        self.baseline = baseline
        self.num_traj = num_traj
        self.horizon = horizon or env.spec.horizon
        self.gamma = gamma
        self.gae_lambda = gae_lambda
        self.normalize_advantages = normalize_advantages
        self.adv_norm_eps = adv_norm_eps
        self.iteration = 0
        self.running_score = torch.zeros((), device=env.device)

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
    def surrogate(self, params: Params, batch: TrajectoryBatch) -> torch.Tensor:
        """CPI surrogate ``mean(LR * adv)`` over valid steps."""
        new_mean, new_log_std = self.apply(params, batch.observations)
        lr = DiagGaussian.likelihood_ratio(batch.actions, new_mean, new_log_std,
                                           batch.mean, batch.log_std)
        validf = batch.valid.to(lr.dtype)
        return torch.sum(lr * batch.advantages * validf) / torch.clamp(validf.sum(), min=1.0)

    def mean_kl(self, params: Params, old_params: Params, batch: TrajectoryBatch) -> torch.Tensor:
        """Masked mean ``KL(old || new)`` over states; ``old_params`` are
        constants."""
        new_mean, new_log_std = self.apply(params, batch.observations)
        old = {k: v.detach() for k, v in old_params.items()}
        old_mean, old_log_std = self.apply(old, batch.observations)
        kl = DiagGaussian.kl(old_mean, old_log_std, new_mean, new_log_std)
        w = batch.valid.to(kl.dtype)
        return torch.sum(kl * w) / torch.clamp(w.sum(), min=1.0)

    def vpg_grad(self, params: Params, batch: TrajectoryBatch) -> Params:
        return torch.func.grad(self.surrogate)(params, batch)

    # -- post-processing -----------------------------------------------------
    @torch.no_grad()
    def process_batch(self, batch: TrajectoryBatch) -> TrajectoryBatch:
        """compute_returns + compute_advantages + normalization."""
        values = self.baseline.predict(batch.observations, batch.time)
        batch = batch.replace(returns=compute_returns(batch.rewards, batch.done, batch.valid, self.gamma))
        batch = compute_advantages(batch, values, self.gamma, self.gae_lambda, normalize=False)
        if self.normalize_advantages:
            mean, std = masked_mean_std(batch.advantages, batch.valid, eps=0.0)
            adv = (batch.advantages - mean) / (std + self.adv_norm_eps)
            batch = batch.replace(advantages=adv * batch.valid.to(adv.dtype))
        return batch

    def update(self, batch: TrajectoryBatch) -> Dict[str, torch.Tensor]:
        """One policy update on a processed batch; returns its metrics."""
        raise NotImplementedError

    # -- the train step ------------------------------------------------------
    def train_step(self, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One on-policy iteration: sample -> returns/GAE -> update ->
        baseline fit -> statistics. Metrics stay on the device."""
        batch = sample_episodes(self.env, self.policy, self.num_traj, self.horizon, generator)
        return self.finish_train_step(batch, generator=generator)

    def finish_train_step(self, batch: TrajectoryBatch,
                          generator: Optional[torch.Generator] = None,
                          fit_perms: Optional[List[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Everything after sampling; ``fit_perms`` fixes the baseline's
        minibatch order (else drawn from ``generator``)."""
        batch = self.process_batch(batch)
        update_metrics = self.update(batch)
        vf_metrics = self.baseline.fit(batch, generator=generator, perms=fit_perms)
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
            "num_samples": batch.num_valid,
            **update_metrics,
            **vf_metrics,
        }
