"""Conjugate gradient for Fisher systems (twin of ``mjrl_tpu/ops/cg.py``).

Same loop order and early exit as the reference: check ``rdotr < tol`` on
entry to each iteration, update ``x``, then recompute the residual. The
exit test reads ``rdotr`` on the host once per iteration (``cg.rdotr``,
through ``utils/trace.py``'s ``host_read``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from mjrl_tpu_torch.utils import trace


def cg_solve(f_Ax: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
             x_0: Optional[torch.Tensor] = None, cg_iters: int = 10,
             residual_tol: float = 1e-10) -> torch.Tensor:
    """Solve ``A x = b`` given only the matvec ``f_Ax``."""
    x = torch.zeros_like(b) if x_0 is None else x_0
    r = b - f_Ax(x) if x_0 is not None else b.clone()
    p = r
    rdotr = torch.dot(r, r)
    for _ in range(cg_iters):
        if trace.host_read("cg.rdotr", rdotr) < residual_tol:
            break
        z = f_Ax(p)
        v = rdotr / torch.dot(p, z)
        x = x + v * p
        r = r - v * z
        newrdotr = torch.dot(r, r)
        p = r + (newrdotr / rdotr) * p
        rdotr = newrdotr
    return x
