"""Natural policy gradient with CG Fisher-vector products (twin of
``mjrl_tpu/algos/npg.py``).

The Fisher matrix is never formed: CG inverts it through Fisher-vector
products, forward-over-reverse as in the reference,
``torch.func.jvp(torch.func.grad(mean_kl))`` plus damping, and the step is
scaled to the KL budget ``alpha = sqrt(2 delta / g^T F^-1 g)``.

Under data parallelism each rank's FVP differentiates its own states' KL
over the global weight (``valid_count``) and the product is all-reduced:
one all-reduce of ``n_params`` floats per CG iteration. CG itself runs on
replicated vectors, the same on every rank.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from mjrl_tpu_torch.algos.base import BatchREINFORCE, Params
from mjrl_tpu_torch.ops.cg import cg_solve
from mjrl_tpu_torch.ops.ravel import ravel
from mjrl_tpu_torch.parallel import dist
from mjrl_tpu_torch.types import TrajectoryBatch
from mjrl_tpu_torch.utils import trace


class NPG(BatchREINFORCE):
    """Reference defaults: ``normalized_step_size=0.01``,
    ``FIM_invert_args={'iters': 10, 'damping': 1e-4}``, ``hvp_sample_frac=1``.
    With ``hvp_sample_frac < 1`` the KL inside the FVP weights each step by
    a Bernoulli(``hvp_sample_frac``) draw of the rewards' shape (the
    reference's fixed-shape stand-in for subsampling states), drawn from
    the update's generator."""

    def __init__(self, env, policy, baseline, normalized_step_size: float = 0.01,
                 FIM_invert_args: Optional[Dict[str, Any]] = None, hvp_sample_frac: float = 1.0,
                 residual_tol: float = 1e-10, **kwargs: Any):
        super().__init__(env, policy, baseline, **kwargs)
        args = dict(iters=10, damping=1e-4)
        args.update(FIM_invert_args or {})
        self.normalized_step_size = normalized_step_size
        self.cg_iters = int(args["iters"])
        self.damping = float(args["damping"])
        self.hvp_sample_frac = hvp_sample_frac
        self.residual_tol = residual_tol

    def hvp_mask(self, batch: TrajectoryBatch,
                 generator: Optional[torch.Generator] = None) -> Optional[torch.Tensor]:
        """The FVP's ``(N, T)`` Bernoulli weights, or None at
        ``hvp_sample_frac >= 1`` (nothing drawn); drawn for every rank's
        rows, of which this rank keeps its block."""
        if self.hvp_sample_frac >= 1.0:
            return None
        rows = dist.block(batch.num_envs, batch.rewards.device)[1]
        p = batch.rewards.new_full((rows, batch.horizon), self.hvp_sample_frac)
        return dist.local_rows(torch.bernoulli(p, generator=generator))

    def build_fvp(self, params: Params, batch: TrajectoryBatch,
                  mask: Optional[torch.Tensor] = None):
        """Damped Fisher-vector product over the flat parameter vector, the
        KL weighted by ``mask`` (this rank's rows) where given; each rank's
        product summed over the ranks."""
        flat, unravel = ravel(params)
        n = self.valid_count(batch, mask)

        def kl_of_flat(p_flat: torch.Tensor) -> torch.Tensor:
            return self.local_kl(unravel(p_flat), params, batch, mask, n)

        grad_kl = torch.func.grad(kl_of_flat)

        def fvp(v: torch.Tensor) -> torch.Tensor:
            return dist.all_sum(torch.func.jvp(grad_kl, (flat,), (v,))[1]) + self.damping * v

        return fvp, flat, unravel

    def step_direction(self, params: Params, batch: TrajectoryBatch,
                       generator: Optional[torch.Generator] = None,
                       hvp_mask: Optional[torch.Tensor] = None):
        """VPG -> CG -> (npg direction, alpha, flat params, unravel); the
        FVP's mask is ``hvp_mask`` (every rank's rows) where given, else
        drawn from ``generator``."""
        vpg_flat, _ = ravel(self.vpg_grad(params, batch))
        hvp_mask = (self.hvp_mask(batch, generator) if hvp_mask is None
                    else dist.local_rows(hvp_mask))
        fvp, flat, unravel = self.build_fvp(params, batch, hvp_mask)
        with trace.span("npg.cg"):
            npg_flat = cg_solve(fvp, vpg_flat, cg_iters=self.cg_iters,
                                residual_tol=self.residual_tol)
        inner = torch.abs(torch.dot(vpg_flat, npg_flat))
        alpha = torch.sqrt(2.0 * self.normalized_step_size / (inner + 1e-20))
        return npg_flat, alpha, flat, unravel

    def update(self, batch: TrajectoryBatch, generator=None,
               hvp_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        params = self.params()
        n = self.valid_count(batch)
        surr_before = self.surrogate(params, batch, n)
        npg_flat, alpha, flat, unravel = self.step_direction(params, batch, generator, hvp_mask)
        new_params = self.policy.project(unravel(flat + alpha * npg_flat))
        kl_dist = self.mean_kl(new_params, params, batch)
        surr_after = self.surrogate(new_params, batch, n)
        self.load_params(new_params)
        return {
            "alpha": alpha,
            "delta": torch.full((), self.normalized_step_size, device=self.env.device),
            "kl_dist": kl_dist,
            "surr_improvement": (surr_after - surr_before).detach(),
        }
