"""Natural policy gradient with CG Fisher-vector products (twin of
``mjrl_tpu/algos/npg.py``).

The Fisher matrix is never formed: CG inverts it through Fisher-vector
products, forward-over-reverse as in the reference,
``torch.func.jvp(torch.func.grad(mean_kl))`` plus damping, and the step is
scaled to the KL budget ``alpha = sqrt(2 delta / g^T F^-1 g)``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from mjrl_tpu_torch.algos.base import BatchREINFORCE, Params
from mjrl_tpu_torch.ops.cg import cg_solve
from mjrl_tpu_torch.ops.ravel import ravel
from mjrl_tpu_torch.types import TrajectoryBatch


class NPG(BatchREINFORCE):
    """Reference defaults: ``normalized_step_size=0.01``,
    ``FIM_invert_args={'iters': 10, 'damping': 1e-4}``."""

    def __init__(self, env, policy, baseline, normalized_step_size: float = 0.01,
                 FIM_invert_args: Optional[Dict[str, Any]] = None,
                 residual_tol: float = 1e-10, **kwargs: Any):
        super().__init__(env, policy, baseline, **kwargs)
        args = dict(iters=10, damping=1e-4)
        args.update(FIM_invert_args or {})
        self.normalized_step_size = normalized_step_size
        self.cg_iters = int(args["iters"])
        self.damping = float(args["damping"])
        self.residual_tol = residual_tol

    def build_fvp(self, params: Params, batch: TrajectoryBatch):
        """Damped Fisher-vector product over the flat parameter vector."""
        flat, unravel = ravel(params)

        def kl_of_flat(p_flat: torch.Tensor) -> torch.Tensor:
            return self.mean_kl(unravel(p_flat), params, batch)

        grad_kl = torch.func.grad(kl_of_flat)

        def fvp(v: torch.Tensor) -> torch.Tensor:
            return torch.func.jvp(grad_kl, (flat,), (v,))[1] + self.damping * v

        return fvp, flat, unravel

    def step_direction(self, params: Params, batch: TrajectoryBatch):
        """VPG -> CG -> (npg direction, alpha, flat params, unravel)."""
        vpg_flat, _ = ravel(self.vpg_grad(params, batch))
        fvp, flat, unravel = self.build_fvp(params, batch)
        npg_flat = cg_solve(fvp, vpg_flat, cg_iters=self.cg_iters, residual_tol=self.residual_tol)
        inner = torch.abs(torch.dot(vpg_flat, npg_flat))
        alpha = torch.sqrt(2.0 * self.normalized_step_size / (inner + 1e-20))
        return npg_flat, alpha, flat, unravel

    def update(self, batch: TrajectoryBatch) -> Dict[str, torch.Tensor]:
        params = self.params()
        surr_before = self.surrogate(params, batch)
        npg_flat, alpha, flat, unravel = self.step_direction(params, batch)
        new_params = self.policy.project(unravel(flat + alpha * npg_flat))
        kl_dist = self.mean_kl(new_params, params, batch)
        surr_after = self.surrogate(new_params, batch)
        self.load_params(new_params)
        return {
            "alpha": alpha,
            "delta": torch.tensor(self.normalized_step_size, device=self.env.device),
            "kl_dist": kl_dist,
            "surr_improvement": (surr_after - surr_before).detach(),
        }
