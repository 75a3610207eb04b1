"""Behavior cloning: the supervised warm start on demonstrations.

Twin of ``mjrl_tpu/algos/bc.py``: the demos' masked mean and std of the
observations and actions become the policy MLP's ``in_/out_shift/scale``
buffers (each scale plus 1e-8), then ``epochs`` passes of minibatch Adam
(lr 1e-3) on the mean-squared error of the policy mean (``MSE``) or the
negative log-likelihood of the demo actions (``MLE``), with the
``min_log_std`` clamp after every step. Each pass takes ``m //
batch_size`` minibatches of a shuffle of the ``m = N * T`` demo slots
(padded slots weigh 0; the partial trailing minibatch is dropped). The
order can be injected (``perms``) or drawn from a generator; torch and
``jax.random`` streams differ.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from mjrl_tpu_torch.models.gaussian_mlp import GaussianMLP
from mjrl_tpu_torch.ops.distributions import DiagGaussian
from mjrl_tpu_torch.types import TrajectoryBatch


class BC:
    """Reference defaults: ``epochs=5, batch_size=64, lr=1e-3,
    loss_type='MSE'``."""

    def __init__(self, expert_batch: TrajectoryBatch, policy: GaussianMLP, epochs: int = 5,
                 batch_size: int = 64, lr: float = 1e-3, loss_type: str = "MSE"):
        if loss_type not in ("MSE", "MLE"):
            raise ValueError(f"loss_type {loss_type!r}")
        self.policy = policy
        self.epochs = epochs
        self.batch_size = batch_size
        self.lr = lr
        self.loss_type = loss_type
        b = expert_batch
        m = b.num_envs * b.horizon
        self.obs = b.observations.reshape(m, -1)
        self.act = b.actions.reshape(m, -1)
        self.w = b.valid.reshape(m).to(self.obs.dtype)

    def compute_transforms(self) -> Dict[str, torch.Tensor]:
        """The demos' masked shift and scale of observations and actions."""
        w = self.w
        n = torch.clamp(w.sum(), min=1.0)

        def stats(x):
            mean = torch.sum(x * w[:, None], dim=0) / n
            var = torch.sum(torch.square(x - mean) * w[:, None], dim=0) / n
            return mean, torch.sqrt(var)

        in_shift, in_scale = stats(self.obs)
        out_shift, out_scale = stats(self.act)
        return {"in_shift": in_shift, "in_scale": in_scale + 1e-8,
                "out_shift": out_shift, "out_scale": out_scale + 1e-8}

    def loss(self, obs: torch.Tensor, act: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        mean, log_std = self.policy(obs)
        if self.loss_type == "MSE":
            per = torch.sum(torch.square(mean - act), dim=-1)
        else:  # MLE: the reference's -mean_LL
            per = -DiagGaussian.log_prob(act, mean, log_std)
        return torch.sum(per * w) / torch.clamp(w.sum(), min=1.0)

    def perms(self, generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """One ``(num_minibatches, minibatch)`` index tensor per epoch."""
        m = self.w.shape[0]
        mb = min(self.batch_size, m)
        num_mb = max(m // mb, 1)
        return [torch.randperm(m, generator=generator, device=self.w.device)[: num_mb * mb]
                .reshape(num_mb, mb) for _ in range(self.epochs)]

    def train(self, generator: Optional[torch.Generator] = None,
              perms: Optional[List[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Fit the policy in place (its MLP's transforms, then its
        parameters); returns ``loss_before`` and ``loss_after`` over all
        demo steps."""
        policy = self.policy
        with torch.no_grad():
            for name, value in self.compute_transforms().items():
                getattr(policy.mlp, name).copy_(value)
            loss_before = self.loss(self.obs, self.act, self.w)
        optimizer = torch.optim.Adam(policy.parameters(), lr=self.lr)
        for perm in self.perms(generator) if perms is None else perms:
            for idx in perm:
                loss = self.loss(self.obs[idx], self.act[idx], self.w[idx])
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                optimizer.step()
                with torch.no_grad():
                    policy.log_std.clamp_(min=policy.min_log_std)
        with torch.no_grad():
            loss_after = self.loss(self.obs, self.act, self.w)
        return {"loss_before": loss_before, "loss_after": loss_after}
