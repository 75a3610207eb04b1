"""PPO-clip: multi-epoch minibatch Adam on the clipped surrogate (twin of
the single-device path of ``mjrl_tpu/algos/ppo.py``).

Maximizes ``mean(min(LR * adv, clip(LR, 1 +- eps) * adv))`` over
``epochs`` passes of ``floor(m / mb_size)`` minibatches of one global
permutation of the batch's ``m`` steps each (the trailing partial
minibatch is dropped), with padded steps weighted 0. The likelihood
ratio's denominator is the behaviour policy's mean and log-std recorded in
the batch at sampling time. ``policy.project`` (the log-std floor) follows
every Adam step.

Options, off by default as in the reference: ``entropy_coef`` adds an
entropy bonus; ``norm_adv_per_minibatch`` re-standardizes the advantages
within each minibatch; ``lr_anneal_iters > 0`` scales Adam's normalized
step by ``learn_rate * clip(1 - iteration / lr_anneal_iters, 0, 1)``,
``iteration`` being the agent's.

The Adam state persists across iterations and in the checkpoint. The
sharded path of the reference (per-device shuffles under ``shard_map``)
is not ported (ROADMAP queue 1, "Env-axis data parallel").
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from mjrl_tpu_torch.algos.base import BatchREINFORCE
from mjrl_tpu_torch.ops.distributions import DiagGaussian
from mjrl_tpu_torch.types import TrajectoryBatch


class PPO(BatchREINFORCE):
    """Reference defaults: ``clip_coef=0.2, epochs=10, mb_size=64,
    learn_rate=3e-4``."""

    def __init__(self, env, policy, baseline, clip_coef: float = 0.2, epochs: int = 10,
                 mb_size: int = 64, learn_rate: float = 3e-4, entropy_coef: float = 0.0,
                 lr_anneal_iters: int = 0, norm_adv_per_minibatch: bool = False, **kwargs: Any):
        super().__init__(env, policy, baseline, **kwargs)
        self.clip_coef = clip_coef
        self.epochs = epochs
        self.mb_size = mb_size
        self.learn_rate = learn_rate
        self.entropy_coef = entropy_coef
        self.lr_anneal_iters = int(lr_anneal_iters)
        self.norm_adv_per_minibatch = norm_adv_per_minibatch
        self.optimizer = torch.optim.Adam(self.policy.parameters(), lr=learn_rate)

    def lr_now(self) -> float:
        """This iteration's learning rate."""
        if self.lr_anneal_iters <= 0:
            return self.learn_rate
        return self.learn_rate * min(max(1.0 - self.iteration / self.lr_anneal_iters, 0.0), 1.0)

    def state_dict(self) -> Dict[str, Any]:
        return {**super().state_dict(), "policy_optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        self.optimizer.load_state_dict(state["policy_optimizer"])

    def minibatch_perms(self, m: int, generator: Optional[torch.Generator] = None
                        ) -> List[torch.Tensor]:
        """One ``(num_minibatches, minibatch)`` index tensor per epoch."""
        mb = min(self.mb_size, m)
        num_mb = max(m // mb, 1)
        return [torch.randperm(m, generator=generator, device=self.env.device)[: num_mb * mb]
                .reshape(num_mb, mb) for _ in range(self.epochs)]

    def _minibatch_loss(self, obs, act, adv, old_mean, old_log_std, vf) -> torch.Tensor:
        new_mean, new_log_std = self.policy(obs)
        lr = DiagGaussian.likelihood_ratio(act, new_mean, new_log_std, old_mean, old_log_std)
        n = torch.clamp(vf.sum(), min=1.0)
        if self.norm_adv_per_minibatch:
            mu = torch.sum(adv * vf) / n
            var = torch.sum(torch.square(adv - mu) * vf) / n
            adv = (adv - mu) / (torch.sqrt(var) + 1e-6)
        clipped = torch.clamp(lr, 1.0 - self.clip_coef, 1.0 + self.clip_coef)
        obj = torch.minimum(lr * adv, clipped * adv) * vf
        if self.entropy_coef:
            obj = obj + self.entropy_coef * DiagGaussian.entropy(new_log_std) * vf
        return -torch.sum(obj) / n

    def update(self, batch: TrajectoryBatch, generator: Optional[torch.Generator] = None,
               perms: Optional[List[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """``epochs`` passes of minibatch Adam; ``perms`` (one ``(num_mb,
        mb)`` index tensor per epoch) fixes the minibatch order, else it is
        drawn from ``generator``."""
        params = {k: v.clone() for k, v in self.params().items()}  # Adam steps in place
        surr_before = self.surrogate(params, batch)
        m = batch.num_envs * batch.horizon
        obs = batch.observations.reshape(m, -1)
        act = batch.actions.reshape(m, -1)
        adv = batch.advantages.reshape(m)
        old_mean, old_log_std = batch.mean.reshape(m, -1), batch.log_std.reshape(m, -1)
        validf = batch.valid.reshape(m).to(adv.dtype)
        lr_now = self.lr_now()
        for group in self.optimizer.param_groups:
            group["lr"] = lr_now
        for perm in self.minibatch_perms(m, generator) if perms is None else perms:
            for idx in perm:
                loss = self._minibatch_loss(obs[idx], act[idx], adv[idx], old_mean[idx],
                                            old_log_std[idx], validf[idx])
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                self.optimizer.step()
                self.load_params(self.policy.project(self.params()))
        new_params = self.params()
        dev = self.env.device
        return {
            "alpha": torch.tensor(lr_now, device=dev),
            "kl_dist": self.mean_kl(new_params, params, batch).detach(),
            "surr_improvement": (self.surrogate(new_params, batch) - surr_before).detach(),
            "log_std_mean": torch.mean(new_params["log_std"]),
        }
