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

The Adam state persists across iterations and in the checkpoint.

Under data parallelism (``parallel/dist.py``, D ranks) this is the twin of
the reference's sharded path (``_minibatch_adam_sharded``): D must divide
``num_traj``; each rank shuffles its own ``m_loc = (E / D) H`` steps into
``num_mb = max(m_loc // mb_loc, 1)`` minibatches of ``mb_loc =
max(min(mb_size, E H) // D, 1)``; the minibatch moments of
``norm_adv_per_minibatch`` and the loss's denominator are over every
rank's part of the minibatch, and the gradient is summed over the ranks
before each Adam step, so the replicated parameters move together. Every
rank draws all D ranks' permutations from the generator and keeps its own,
so the generators stay in step. One rank keeps the global shuffle.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from mjrl_tpu_torch.algos.base import BatchREINFORCE
from mjrl_tpu_torch.ops.distributions import DiagGaussian
from mjrl_tpu_torch.parallel import dist
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
        if self.num_traj % dist.world_size():
            raise ValueError(f"PPO's sharded minibatches need num_traj ({self.num_traj}) to "
                             f"divide over the {dist.world_size()} ranks")

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

    def sharded_perms(self, m_loc: int, horizon: int,
                      generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """The sharded path's minibatches: one ``(num_mb, mb_loc)`` tensor
        of this rank's ``m_loc`` steps per epoch. All ranks' permutations
        are drawn, in rank order, and this rank's kept."""
        world = dist.world_size()
        mb_loc = max(min(self.mb_size, self.num_traj * horizon) // world, 1)
        num_mb = max(m_loc // mb_loc, 1)
        perms = []
        for _ in range(self.epochs):
            drawn = [torch.randperm(m_loc, generator=generator, device=self.env.device)
                     for _ in range(world)]
            perms.append(drawn[dist.rank()][: num_mb * mb_loc].reshape(num_mb, mb_loc))
        return perms

    def _minibatch_loss(self, obs, act, adv, old_mean, old_log_std, vf) -> torch.Tensor:
        """This rank's part of the minibatch's loss: its steps' sum over
        the count of every rank's valid steps (the minibatch moments too)."""
        new_mean, new_log_std = self.policy(obs)
        lr = DiagGaussian.likelihood_ratio(act, new_mean, new_log_std, old_mean, old_log_std)
        if self.norm_adv_per_minibatch:
            count, total = dist.all_sum(torch.stack([vf.sum(), torch.sum(adv * vf)]))
            n = torch.clamp(count, min=1.0)
            mu = total / n
            var = dist.all_sum(torch.sum(torch.square(adv - mu) * vf)) / n
            adv = (adv - mu) / (torch.sqrt(var) + 1e-6)
        else:
            n = torch.clamp(dist.all_sum(vf.sum()), min=1.0)
        clipped = torch.clamp(lr, 1.0 - self.clip_coef, 1.0 + self.clip_coef)
        obj = torch.minimum(lr * adv, clipped * adv) * vf
        if self.entropy_coef:
            obj = obj + self.entropy_coef * DiagGaussian.entropy(new_log_std) * vf
        return -torch.sum(obj) / n

    def update(self, batch: TrajectoryBatch, generator: Optional[torch.Generator] = None,
               perms: Optional[List[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """``epochs`` passes of minibatch Adam; ``perms`` (one ``(num_mb,
        mb)`` index tensor per epoch, into this rank's steps) fixes the
        minibatch order, else it is drawn from ``generator``."""
        params = {k: v.clone() for k, v in self.params().items()}  # Adam steps in place
        n = self.valid_count(batch)
        surr_before = self.surrogate(params, batch, n)
        m = batch.num_envs * batch.horizon
        obs = batch.observations.reshape(m, -1)
        act = batch.actions.reshape(m, -1)
        adv = batch.advantages.reshape(m)
        old_mean, old_log_std = batch.mean.reshape(m, -1), batch.log_std.reshape(m, -1)
        validf = batch.valid.reshape(m).to(adv.dtype)
        lr_now = self.lr_now()
        for group in self.optimizer.param_groups:
            group["lr"] = lr_now
        if perms is None:
            perms = (self.minibatch_perms(m, generator) if dist.world_size() == 1
                     else self.sharded_perms(m, batch.horizon, generator))
        for perm in perms:
            for idx in perm:
                loss = self._minibatch_loss(obs[idx], act[idx], adv[idx], old_mean[idx],
                                            old_log_std[idx], validf[idx])
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                dist.all_sum_grads(self.policy.parameters())
                self.optimizer.step()
                self.load_params(self.policy.project(self.params()))
        new_params = self.params()
        dev = self.env.device
        return {
            "alpha": torch.full((), lr_now, device=dev),
            "kl_dist": self.mean_kl(new_params, params, batch).detach(),
            "surr_improvement": (self.surrogate(new_params, batch, n) - surr_before).detach(),
            "log_std_mean": torch.mean(new_params["log_std"]),
        }
