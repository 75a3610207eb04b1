"""What the Adroit tasks share: the model from its committed ``.npz`` with
the DAPG envs' settings, the action scaling, one control step of plain
physics, and the link and site poses the observations read."""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from gpubench.reference.physics.csolve import ensure_solver_params
from gpubench.reference.physics.engine import forward_kinematics, site_positions
from gpubench.reference.physics.model import Model, load_model_npz
from gpubench.reference.physics.soa import multistep
from gpubench.reference.physics.tables import scale_limit_penalties

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
FRAME_SKIP = 5


def adroit_model(task: str, constraint_solver: str) -> Model:
    """The task's model with the DAPG envs' contact gains, one 2 ms
    substep and the per-dof limit gains (omega 60 rad/s); under Newton the
    rows' solver parameters filled at qpos0."""
    model = load_model_npz(os.path.join(ROOT, "mjrl_tpu_torch", "envs", "assets",
                                        f"adroit_{task}.npz"))
    model.constraint_solver = constraint_solver
    model.contact_stiffness = 1000.0
    model.contact_damping = 6.0
    model.contact_depth_cap = 0.01
    model.friction_vel = 0.01
    model.n_substeps = 1
    scale_limit_penalties(model, omega=60.0)
    if constraint_solver == "newton":
        ensure_solver_params(model)
    return model


class AdroitReference:
    task = ""
    frame_skip = FRAME_SKIP

    def __init__(self, constraint_solver: str = "penalty", device="cuda"):
        self.device = torch.device(device)
        self.model = model = adroit_model(self.task, constraint_solver)
        rng = np.asarray(model.act_ctrlrange, np.float64)
        self.act_mean = torch.tensor(0.5 * (rng[:, 0] + rng[:, 1]), dtype=torch.float32,
                                     device=self.device)
        self.act_rng = torch.tensor(0.5 * (rng[:, 1] - rng[:, 0]), dtype=torch.float32,
                                    device=self.device)
        self.site = {n: i for i, n in enumerate(model.site_name)}
        self.link = {n: i for i, n in enumerate(model.link_name)}

    def physics(self, st: Dict[str, torch.Tensor], action: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(q, qd)`` (batch-first) after one control step of ``frame_skip``
        frames from ``st`` under ``action`` in [-1, 1] scaled to the
        actuators' ranges."""
        ctrl = self.act_mean + torch.clamp(action, -1.0, 1.0) * self.act_rng
        q, qd = st["q"], st["qd"]
        delta = st["link_delta"].reshape(q.shape[0], -1).T.contiguous()
        q2, qd2 = multistep(self.model, q.T.contiguous(), qd.T.contiguous(),
                            ctrl.T.contiguous(), self.frame_skip, link_delta=delta)
        return q2.T, qd2.T

    def poses(self, st: Dict[str, torch.Tensor]):
        pos, quat = forward_kinematics(self.model, st["q"], st["link_delta"])
        return pos, quat, site_positions(self.model, pos, quat)

    @staticmethod
    def guard(st, reward, obs):
        """A diverged state (non-finite or |qd| >= 1e4) scores 0; non-finite
        observations read 0."""
        sane = (torch.isfinite(st["q"]).all(-1) & torch.isfinite(st["qd"]).all(-1)
                & (st["qd"].abs().amax(-1) < 1e4))
        reward = torch.where(sane, reward, torch.zeros_like(reward))
        return reward, torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
