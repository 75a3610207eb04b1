"""The benchmark's yardstick: the chip's peaks, a kernel's least time from
the frozen operation counts (``counts/<config>.json``, written by
``counts.py``), an iteration's counted f32 operations, and the Newton rows
that the frozen narrow phase finds held at a set of states.

Nothing here reads the port: a change to its physics moves none of these
numbers."""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load(rel: str) -> dict:
    with open(os.path.join(HERE, rel)) as f:
        return json.load(f)


PEAKS = load("peaks.json")


def step_ops(counts: dict, solver: str, held: Optional[Tuple[float, float]] = None) -> float:
    """f32 operations of one env-substep: the penalty count, or the Newton
    count with ``held`` (contact rows, limit rows) held per env."""
    c = counts[solver]
    if solver == "newton":
        cand, lim = held if held is not None else (0.0, 0.0)
        return c["ops_no_row"] + cand * c["ops_per_contact_row"] + lim * c["ops_per_limit_row"]
    return c["ops_per_env_substep"]


def kernel_bound_ms(counts: dict, solver: str, batch: int,
                    held: Optional[Tuple[float, float]] = None) -> Tuple[float, str]:
    """The least time of one launch (one control step of ``batch`` envs):
    the larger of its operations over the f32 peak and its bytes (the
    state and control read once, the state written once, the model's
    constants read once) over the HBM peak; and which of the two it is."""
    n_sub = counts["substeps_per_control_step"]
    t_ops = step_ops(counts, solver, held) * n_sub * batch / PEAKS["f32_flops_per_s"]
    t_bytes = (counts["io_bytes_per_env"] * batch + counts["model_bytes"]) / PEAKS["hbm_bytes_per_s"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def roofline_pct(data: dict, kernel: str) -> Optional[float]:
    """``kernel``'s share of its roofline in a traced run: the least time of
    one launch (:func:`kernel_bound_ms`; under Newton with the rows the
    frozen narrow phase finds held at states sampled from the traced
    iteration) over its device time per launch; None where the run's
    kernel is another or the trace holds no launch of it."""
    prof = data.get("profile")
    if data.get("kernel") != kernel or not prof or not prof.get("kernel_ms"):
        return None
    cell = data["cell"]
    held = data.get("held_rows") if cell.solver == "newton" else None
    bound, by = kernel_bound_ms(cell.counts, cell.solver, data["num_traj"], held)
    print(f"gpubench {kernel}_roofline: bound {bound!r} ms by {by}, held rows {held!r}",
          file=sys.stderr)
    return 100.0 * bound / prof["kernel_ms"]


def mlp_flops(sizes: Sequence[int]) -> int:
    """Multiply-adds of one row through a dense network, as 2 operations."""
    return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))


def iteration_ops(counts: dict, solver: str, num_traj: int, horizon: int, obs_dim: int,
                  act_dim: int, policy_hidden: Sequence[int], baseline_hidden: Sequence[int],
                  baseline_epochs: int, baseline_batch: int, cg_iters: int = 10,
                  held: Optional[Tuple[float, float]] = None) -> Dict[str, float]:
    """Counted f32 operations of one NPG iteration with an MLP baseline, by
    part. Physics: the frozen count per env-substep x substeps x steps.
    Policy (``P`` flops a row forward, a backward pass twice that): the
    rollout's forward, the surrogate before and after and the KL after
    (one forward each), the gradient (3P) and each CG product
    (forward-over-reverse of the KL: the old policy's forward, then the
    new one's forward and backward with their tangents, 7P). Baseline
    (``V`` a row): the prediction for GAE, the errors before and after,
    and each Adam step's forward and backward (3V a row)."""
    rows = num_traj * horizon
    P = mlp_flops((obs_dim, *policy_hidden, act_dim))
    V = mlp_flops((2 * obs_dim + 4, *baseline_hidden, 1))
    mb = min(baseline_batch, rows)
    fit_rows = baseline_epochs * max(rows // mb, 1) * mb
    return {
        "physics": step_ops(counts, solver, held) * counts["substeps_per_control_step"] * rows,
        "policy": rows * P * (1 + 3 + 1 + 1 + 1 + 7 * cg_iters),
        "baseline": rows * V * 3 + fit_rows * 3 * V,
    }


def held_rows(model, q: torch.Tensor, link_delta: Optional[torch.Tensor] = None
              ) -> Tuple[float, float]:
    """Mean Newton rows held per env at the states ``q`` (B, nq) (with
    ``link_delta`` (B, nlink, 3)): contact candidates deeper than minus
    their margin, and limited hinge or slide joints out of range, by the
    reference's frozen narrow phase."""
    from gpubench.reference.physics import soa, soa_newton
    from gpubench.reference.physics.model import HINGE, SLIDE

    qT = q.T.contiguous()
    delta = None if link_delta is None else link_delta.reshape(q.shape[0], -1).T.contiguous()
    cands = soa._contact_candidates(model, *soa._fk(model, qT, delta))
    contacts = torch.zeros(q.shape[0], dtype=torch.float64, device=q.device)
    for c in cands:
        margin = soa_newton.contact_params(model, c.gi, c.gj, c.mu)[2]
        contacts += (-c.depth - float(np.float32(margin)) < 0.0)[0].double()
    limits = torch.zeros_like(contacts)
    for i in range(model.nlink):
        if model.link_jnt_type[i] in (HINGE, SLIDE) and model.jnt_limited[i] > 0:
            lo, hi = model.jnt_range[i]
            qi = qT[model.link_qadr[i]]
            limits += ((qi < float(np.float32(lo))) | (qi > float(np.float32(hi)))).double()
    return float(contacts.mean()), float(limits.mean())
