"""States that reach the contacts between two moving links, for checks.

A random policy rarely folds a hopper far enough for its capsule-capsule
pairs (thigh, leg and foot against each other) to touch, nor a humanoid
for its sphere-sphere and sphere-capsule pairs (feet, hands and head), so
the kernel checks (the CPU tests and ``chip_smoke.py``) add states drawn
here: the root at its default pose and each limited hinge uniform in its
range, kept where some pair between two links overlaps by less than a
centimetre. ``kind_depth`` reads the deepest point of each contact kind;
``held_contact_rows`` counts the Newton rows such a pair holds.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mjrl_tpu_torch.physics import soa, soa_newton
from mjrl_tpu_torch.physics.csolve import ensure_solver_params
from mjrl_tpu_torch.physics.model import HINGE, Model
from mjrl_tpu_torch.physics.tables import pair_groups, points_per_pair


def link_pair_depth(model: Model, q: torch.Tensor) -> torch.Tensor:
    """Per env (``q`` is ``(nq, B)``), the deepest contact candidate between
    two moving links; ``-inf`` where the model has no such pair."""
    pos, quat = soa._fk(model, q)
    depths = [c.depth for c in soa._contact_candidates(model, pos, quat) if c.lj >= 0]
    if not depths:
        return torch.full((q.shape[1],), -float("inf"), device=q.device)
    return torch.cat(depths).amax(dim=0)


def kind_depth(model: Model, q: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per contact kind, the deepest of its candidates in each env (``q``
    is ``(nq, B)``): a ``(B,)`` tensor per kind, in the reference's kind
    order."""
    cands = soa._contact_candidates(model, *soa._fk(model, q))
    out, k = {}, 0
    for kind, tab in pair_groups(model).kinds:
        n = len(tab["gi"]) * points_per_pair(kind)
        out[kind] = torch.cat([c.depth for c in cands[k : k + n]]).amax(dim=0)
        k += n
    return out


def held_contact_rows(model: Model, q: torch.Tensor, between_links: bool = False) -> torch.Tensor:
    """Per env (``q`` is ``(nq, B)``), the contact candidates inside their
    margin: the rows the Newton solver holds for them (``-depth - margin <
    0``, as physics/soa_newton.py decides); with ``between_links``, only
    those between two moving links."""
    ensure_solver_params(model)
    pos, quat = soa._fk(model, q)
    held = torch.zeros(q.shape[1], dtype=torch.int64, device=q.device)
    for c in soa._contact_candidates(model, pos, quat):
        if c.lj >= 0 or not between_links:
            margin = soa_newton.contact_params(model, c.gi, c.gj, c.mu)[2]
            held += (-c.depth - float(np.float32(margin)) < 0.0)[0]
    return held


def overlapping_states(model: Model, n: int, rng: np.random.Generator):
    """``(q (nq, n), qd (nv, n))`` float32 numpy: states with a link pair
    overlapping by 0 to 1 cm, and qd uniform in +-0.1."""
    draws = 4096
    hinges = [i for i in range(model.nlink)
              if model.link_jnt_type[i] == HINGE and model.jnt_limited[i] > 0]
    kept = []
    for _ in range(64):
        q = np.tile(np.asarray(model.default_qpos, np.float32)[:, None], (1, draws))
        for i in hinges:
            lo, hi = model.jnt_range[i]
            q[model.link_qadr[i]] = rng.uniform(lo, hi, draws)
        depth = link_pair_depth(model, torch.as_tensor(q)).numpy()
        kept.append(q[:, (depth > 0) & (depth < 0.01)])
        if sum(k.shape[1] for k in kept) >= n:
            q = np.ascontiguousarray(np.concatenate(kept, axis=1)[:, :n])
            return q, rng.uniform(-0.1, 0.1, (model.nv, n)).astype(np.float32)
    raise ValueError("no overlapping link pairs found")
