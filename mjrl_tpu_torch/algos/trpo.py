"""TRPO: the NPG direction plus a backtracking KL line search (twin of
``mjrl_tpu/algos/trpo.py``).

Take the CG natural-gradient direction and its KL-budget step, then halve
the step until the surrogate improves and ``KL(old || new) <= kl_dist``; if
no step of the ladder qualifies, keep the old parameters. The ladder keeps
the reference's ``while_loop`` semantics: ``backtrack_iters`` counts the
probes made (1 when the first is accepted), and a rejected update logs
``alpha``, ``kl_dist`` and ``surr_improvement`` as 0.

Each probe is one forward pass of the candidate policy over the batch,
which gives both the surrogate (against the sampling policy's mean and
log-std stored in the batch) and the KL (against the old policy's mean and
log-std, computed once before the ladder), and one scalar read to decide.
Under data parallelism each probe's surrogate and KL are this rank's sums
over the global count, both summed over the ranks in one all-reduce, so
every rank takes the same decision.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from mjrl_tpu_torch.algos.base import Params, masked_kl, masked_surrogate
from mjrl_tpu_torch.algos.npg import NPG
from mjrl_tpu_torch.parallel import dist
from mjrl_tpu_torch.types import TrajectoryBatch
from mjrl_tpu_torch.utils import trace


class TRPO(NPG):
    """Reference default ``kl_dist=0.01``, passed to NPG as its normalized
    step size for the first probe's alpha."""

    def __init__(self, env, policy, baseline, kl_dist: float = 0.01,
                 backtrack_ratio: float = 0.5, max_backtracks: int = 10, **kwargs: Any):
        super().__init__(env, policy, baseline, normalized_step_size=kl_dist, **kwargs)
        self.kl_dist = kl_dist
        self.backtrack_ratio = backtrack_ratio
        self.max_backtracks = max_backtracks

    def _probe(self, params: Params, old_mean: torch.Tensor, old_log_std: torch.Tensor,
               batch: TrajectoryBatch, n: torch.Tensor):
        """``(surrogate, mean KL(old || new))`` of ``params`` from one
        forward pass, ``n`` the valid count; the same values as
        ``surrogate`` and ``mean_kl``."""
        new_mean, new_log_std = self.apply(params, batch.observations)
        surr, kl = dist.all_sum(torch.stack([
            masked_surrogate(new_mean, new_log_std, batch, n),
            masked_kl(old_mean, old_log_std, new_mean, new_log_std, batch.valid, n=n)]))
        return surr, kl

    @torch.no_grad()
    def _ladder(self, params, flat, npg_flat, alpha, unravel, surr_before, batch):
        """The backtracking probes: ``(probes, alpha, accepted, surr, kl)``."""
        old_mean, old_log_std = self.apply(params, batch.observations)
        n = self.valid_count(batch)
        k, accepted = 0, False
        surr, kl = surr_before, torch.zeros_like(surr_before)
        while k < self.max_backtracks and not accepted:
            cand = self.policy.project(unravel(flat + alpha * npg_flat))
            surr, kl = self._probe(cand, old_mean, old_log_std, batch, n)
            accepted = trace.host_read("trpo.accepted", (surr > surr_before) & (kl <= self.kl_dist))
            k += 1
            if not accepted:
                alpha = alpha * self.backtrack_ratio
        return k, alpha, accepted, surr, kl

    def update(self, batch: TrajectoryBatch, generator=None) -> Dict[str, torch.Tensor]:
        params = self.params()
        surr_before = self.surrogate(params, batch).detach()
        npg_flat, alpha0, flat, unravel = self.step_direction(params, batch, generator)
        k, alpha, accepted, surr, kl = self._ladder(params, flat, npg_flat, alpha0, unravel,
                                                    surr_before, batch)
        # rejected: the old parameters stay (alpha 0 reproduces them exactly)
        alpha = alpha if accepted else torch.zeros_like(alpha)
        self.load_params(self.policy.project(unravel(flat + alpha * npg_flat)))
        zero = torch.zeros_like(surr_before)
        dev = self.env.device
        return {
            "alpha": alpha,
            "delta": torch.full((), self.kl_dist, device=dev),
            "kl_dist": kl if accepted else zero,
            "surr_improvement": surr - surr_before if accepted else zero,
            "backtrack_iters": torch.full((), float(k), device=dev),
            "step_accepted": torch.full((), float(accepted), device=dev),
        }
