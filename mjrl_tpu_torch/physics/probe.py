"""States that reach the contacts between two moving links, for checks.

A random policy rarely folds a hopper far enough for its capsule-capsule
pairs (thigh, leg and foot against each other) to touch, so the kernel
checks (the CPU tests and ``chip_smoke.py``) add states drawn here: the
root at its default pose and each limited hinge uniform in its range, kept
where some pair between two links overlaps by less than a centimetre.
"""

from __future__ import annotations

import numpy as np
import torch

from mjrl_tpu_torch.physics import soa
from mjrl_tpu_torch.physics.model import HINGE, Model


def link_pair_depth(model: Model, q: torch.Tensor) -> torch.Tensor:
    """Per env (``q`` is ``(nq, B)``), the deepest contact candidate between
    two moving links; ``-inf`` where the model has no such pair."""
    pos, quat = soa._fk(model, q)
    depths = [c.depth for c in soa._contact_candidates(model, pos, quat) if c.lj >= 0]
    if not depths:
        return torch.full((q.shape[1],), -float("inf"), device=q.device)
    return torch.cat(depths).amax(dim=0)


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
            q = np.concatenate(kept, axis=1)[:, :n]
            return q, rng.uniform(-0.1, 0.1, (model.nv, n)).astype(np.float32)
    raise ValueError("no overlapping link pairs found")
