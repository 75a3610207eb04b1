"""Ridge-regularized least squares for the linear and quadratic baselines.

Twin of ``mjrl_tpu/ops/lstsq.py``: an f32 Cholesky solve of the weighted
normal equations ``(F^T W F + reg I) w = F^T W y`` with one step of
iterative refinement, retried with ``reg *= 10`` (at most ``max_retries``
times) while the solution is not finite, the reference's escalating ridge.
Where ``jax.scipy.linalg.cho_factor`` returns NaNs on a matrix that is not
positive definite, ``torch.linalg.cholesky_ex`` reports it in ``info``;
a nonzero ``info`` counts as a non-finite solution. Under data
parallelism the Gram matrix and the right side are summed over the ranks'
rows (one all-reduce; the rows never move), and every rank solves the
same system.
"""

from __future__ import annotations

import torch

from mjrl_tpu_torch.parallel import dist
from mjrl_tpu_torch.utils import trace


def _chol_solve(gram: torch.Tensor, rhs: torch.Tensor, reg: torch.Tensor):
    """``(x, ok)``: the refined solution (NaN where the factor failed, as
    in the reference) and whether the factor held."""
    a = gram + reg * torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
    chol, info = torch.linalg.cholesky_ex(a)
    b = rhs[:, None]
    x = torch.cholesky_solve(b, chol)
    x = x + torch.cholesky_solve(b - a @ x, chol)
    ok = info == 0
    return torch.where(ok, x[:, 0], torch.nan), ok


def ridge_solve(features: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor,
                reg_coef: float = 1e-5, max_retries: int = 10) -> torch.Tensor:
    """``argmin_w |sqrt(W) (F w - y)|^2 + reg |w|^2`` for ``features (M,
    K)``, ``targets (M,)`` and ``weights (M,)`` (a 0/1 mask or sample
    weights), the rows those of every rank."""
    wf = weights[:, None] * features
    normal = dist.all_sum_dict({"gram": features.T @ wf, "rhs": wf.T @ targets})
    gram, rhs = normal["gram"], normal["rhs"]
    reg = torch.full((), reg_coef, dtype=gram.dtype, device=gram.device)
    x, ok = _chol_solve(gram, rhs, reg)
    for _ in range(max_retries):
        if trace.host_read("lstsq.solved", ok & torch.isfinite(x).all()):
            break
        reg = reg * 10.0
        x, ok = _chol_solve(gram, rhs, reg)
    return x
