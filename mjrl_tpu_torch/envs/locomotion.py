"""Gym-style locomotion envs on the first-party physics: Ant.

Twin of ``mjrl_tpu/envs/locomotion.py`` (``LocomotionEnv``, ``AntEnv``). The
model is compiled from the ant asset shipped in ``envs/assets/`` (Gymnasium
1.2.2's ``ant.xml``), the contact and limit gains are tuned as the
reference tunes them, and ``step`` advances all envs through one K1 call
per control step. Task conventions follow gymnasium's Ant-v4: 27-dim
observation ``[q[2:], qd]``, forward reward from the torso's x velocity,
ctrl cost 0.5, healthy reward 1 while 0.2 < z < 1.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from mjrl_tpu_torch.envs.base import Env, EnvState, StepResult, register
from mjrl_tpu_torch.physics.dispatch import make_frame_stepper
from mjrl_tpu_torch.physics.mjcf import load_mjcf
from mjrl_tpu_torch.physics.soa import check_supported
from mjrl_tpu_torch.physics.tables import scale_limit_penalties
from mjrl_tpu_torch.types import EnvSpec

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


class LocomotionEnv(Env):
    """Shared machinery of the locomotion tasks. Reset noise is uniform on
    q and normal on qd (ant's convention; the other tasks are not ported)."""

    asset: str
    frame_skip: int
    forward_reward_weight: float = 1.0
    ctrl_cost_weight: float = 1e-3
    healthy_reward: float = 0.0
    reset_noise_scale: float = 5e-3
    exclude_positions: int = 1  # leading qpos entries dropped from obs
    n_substeps: int = 1  # physics substeps per model dt (penalty stability)

    def __init__(self, horizon: int = 1000, device="cpu", asset_path: Optional[str] = None):
        self.device = torch.device(device)
        model = load_mjcf(asset_path or os.path.join(ASSETS, self.asset))
        model.n_substeps = self.n_substeps
        model.constraint_solver = "penalty"
        # penalty contact gains scaled to the body, as the reference does:
        # full weight on one contact compresses ~2 mm; near-critical damping
        # against a quarter of the body mass
        total_mass = float(model.link_mass.sum())
        model.contact_stiffness = total_mass * 9.81 / 0.002
        model.contact_damping = 2.0 * float(np.sqrt(model.contact_stiffness * total_mass / 4.0))
        model.contact_depth_cap = 0.02
        # critically damped per-dof limit gains (k = w^2 M_jj, c = 2 w M_jj)
        scale_limit_penalties(model, omega=60.0)
        check_supported(model)
        self.model = model
        self._frame_step = make_frame_stepper(model, self.frame_skip)
        self.qpos0 = torch.as_tensor(model.default_qpos, dtype=torch.float32, device=self.device)
        self.spec = EnvSpec(
            observation_dim=(model.nq - self.exclude_positions) + model.nv,
            action_dim=model.nu,
            horizon=horizon,
        )

    def _obs(self, state: EnvState) -> torch.Tensor:
        return torch.cat([state.q[:, self.exclude_positions :], state.qd], dim=-1)

    def _healthy(self, state: EnvState) -> torch.Tensor:
        return torch.ones(state.q.shape[0], dtype=torch.bool, device=state.q.device)

    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator] = None):
        """``(q_noise, qd_noise)``: uniform in +-scale on q, scale * normal on qd."""
        s = self.reset_noise_scale
        kw = dict(device=self.device, generator=generator)
        q_noise = (2.0 * torch.rand(num_envs, self.model.nq, **kw) - 1.0) * s
        return q_noise, s * torch.randn(num_envs, self.model.nv, **kw)

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        return self.reset_from_noise(*self.reset_noise(num_envs, generator))

    def reset_from_noise(self, q_noise: torch.Tensor, qd_noise: torch.Tensor) -> Tuple[EnvState, torch.Tensor]:
        """Reset with the noise given: ``q = qpos0 + q_noise``, ``qd = qd_noise``."""
        state = EnvState(q=self.qpos0 + q_noise, qd=qd_noise.clone())
        return state, self._obs(state)

    def step(self, state: EnvState, action: torch.Tensor) -> StepResult:
        x_before = state.q[:, 0]
        q2, qd2 = self._frame_step(state.q, state.qd, action)
        state = EnvState(q=q2, qd=qd2)
        x_velocity = (q2[:, 0] - x_before) / (self.model.dt * self.frame_skip)
        ctrl_cost = self.ctrl_cost_weight * torch.sum(torch.square(action), dim=-1)
        # Blow-up guard: a diverged penalty state terminates with reward 0,
        # or its NaN/1e6-scale values poison the returns of the whole batch.
        sane = (
            torch.isfinite(q2).all(dim=-1)
            & torch.isfinite(qd2).all(dim=-1)
            & (qd2.abs().amax(dim=-1) < 1e4)
        )
        healthy = self._healthy(state) & sane
        reward = (
            self.forward_reward_weight * x_velocity
            - ctrl_cost
            + self.healthy_reward * healthy.to(x_velocity.dtype)
        )
        reward = torch.where(sane, reward, torch.zeros_like(reward))
        obs = self._obs(state)
        # non-finite obs would ride through valid-masked losses as 0*nan=nan
        obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
        return state, obs, reward, ~healthy, {"x_velocity": x_velocity}


class AntEnv(LocomotionEnv):
    """Ant-v4 conventions (27-dim obs, no contact-force obs or cost)."""

    asset = "ant.xml"
    frame_skip = 5
    ctrl_cost_weight = 0.5
    healthy_reward = 1.0
    reset_noise_scale = 0.1
    exclude_positions = 2
    n_substeps = 4  # dt=0.01 with 0.04 kg limbs: penalty contacts need ~2.5 ms
    healthy_z_range = (0.2, 1.0)

    def _healthy(self, state: EnvState) -> torch.Tensor:
        z = state.q[:, 2]
        finite = torch.isfinite(state.q).all(dim=-1) & torch.isfinite(state.qd).all(dim=-1)
        lo, hi = self.healthy_z_range
        return finite & (z > lo) & (z < hi)


register("ant", AntEnv)
