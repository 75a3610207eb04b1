"""DAPG: demo-augmented natural policy gradient.

Twin of ``mjrl_tpu/algos/dapg.py``. Every demo step gets the advantage
``lam_0 * lam_1**k * max(valid normalized sampled advantages)``, ``k`` the
agent's iteration before this step; the vanilla gradient is taken on the
union surrogate ``(n_s * surr_s + n_d * surr_d) / (n_s + n_d)`` over the
sampled and the demo steps, while the Fisher products and CG use the
sampled data only (NPG's ``step_direction`` with this ``vpg_grad``). The
demo surrogate's ratio denominator is the current policy on the demo
states with its gradient stopped (demos carry no behavior distribution).
Without demos the update is NPG's. Under data parallelism ``n_s`` and the
max are over every rank's sampled steps, and the demo batch, which every
rank holds whole, adds its term on rank 0 alone, so that the all-reduced
gradient counts it once.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from mjrl_tpu_torch.algos.base import Params
from mjrl_tpu_torch.algos.npg import NPG
from mjrl_tpu_torch.ops.distributions import DiagGaussian
from mjrl_tpu_torch.parallel import dist
from mjrl_tpu_torch.types import TrajectoryBatch


class DAPG(NPG):
    """Reference defaults: ``lam_0=1.0, lam_1=0.95``."""

    def __init__(self, env, policy, baseline, demo_batch: Optional[TrajectoryBatch] = None,
                 lam_0: float = 1.0, lam_1: float = 0.95, **kwargs: Any):
        super().__init__(env, policy, baseline, **kwargs)
        self.demo_batch = demo_batch
        self.lam_0 = lam_0
        self.lam_1 = lam_1

    def demo_coef(self) -> torch.Tensor:
        """``lam_0 * lam_1**iteration`` (f32, on the env's device)."""
        dev = self.env.device
        return torch.full((), self.lam_0, device=dev) * torch.pow(
            torch.full((), self.lam_1, device=dev), float(self.iteration))

    def demo_surrogate(self, params: Params, demo_adv: torch.Tensor) -> torch.Tensor:
        """Masked mean likelihood-ratio surrogate over the demo steps."""
        d = self.demo_batch
        new_mean, new_log_std = self.apply(params, d.observations)
        lr = DiagGaussian.likelihood_ratio(d.actions, new_mean, new_log_std,
                                           new_mean.detach(), new_log_std.detach())
        w = d.valid.to(lr.dtype)
        return torch.sum(lr * demo_adv * w) / torch.clamp(w.sum(), min=1.0)

    def vpg_grad(self, params: Params, batch: TrajectoryBatch,
                 n: Optional[torch.Tensor] = None) -> Params:
        if self.demo_batch is None:
            return super().vpg_grad(params, batch, n)
        n_s = self.valid_count(batch) if n is None else n
        n_d = torch.clamp(self.demo_batch.valid.to(n_s.dtype).sum(), min=1.0)
        big = torch.finfo(batch.advantages.dtype).max
        demo_adv = self.demo_coef() * dist.all_max(
            torch.where(batch.valid, batch.advantages, -big).max())

        def union_surrogate(p):
            # this rank's share: its sampled steps, and the demos on rank 0
            union = n_s * self.local_surrogate(p, batch, n_s)
            if dist.is_main():
                union = union + n_d * self.demo_surrogate(p, demo_adv)
            return union / (n_s + n_d)

        return dist.all_sum_dict(torch.func.grad(union_surrogate)(params))

    def update(self, batch: TrajectoryBatch, generator=None) -> Dict[str, torch.Tensor]:
        metrics = super().update(batch, generator)
        if self.demo_batch is not None:
            metrics["demo_coef"] = self.demo_coef()
        return metrics
