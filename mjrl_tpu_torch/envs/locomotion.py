"""Gym-style locomotion envs on the first-party physics: Ant and the planar
walkers (Hopper, Walker2d, HalfCheetah).

Twin of ``mjrl_tpu/envs/locomotion.py`` (``LocomotionEnv``, ``HopperEnv``,
``Walker2dEnv``, ``HalfCheetahEnv``, ``AntEnv``). Each model is compiled
from the asset shipped in ``envs/assets/`` (Gymnasium 1.2.2's XML; the
card's machine has no gymnasium), the contact and limit gains are tuned as
the reference tunes them, and ``step`` advances all envs through one kernel
call per control step: K1 with the penalty solver, K2 with the Newton
solver. Envs live on the card unless ``device="cpu"`` is asked for. Task
conventions follow gymnasium's v4 tasks: observation ``[q[k:], clip(qd)]``,
forward reward from the root's x velocity, the task's ctrl cost, healthy
reward and termination.
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
    q, and uniform or normal on qd (``reset_vel_noise``); the obs clips qd
    to +-``clip_qvel_obs`` unless it is None."""

    asset: str
    frame_skip: int
    forward_reward_weight: float = 1.0
    ctrl_cost_weight: float = 1e-3
    healthy_reward: float = 0.0
    reset_noise_scale: float = 5e-3
    reset_vel_noise: str = "uniform"  # 'uniform' | 'normal'
    exclude_positions: int = 1  # leading qpos entries dropped from obs
    clip_qvel_obs: Optional[float] = 10.0
    n_substeps: int = 1  # physics substeps per model dt (penalty stability)

    def __init__(self, horizon: int = 1000, device="cuda", asset_path: Optional[str] = None,
                 constraint_solver: str = "penalty", n_substeps: Optional[int] = None):
        self.device = torch.device(device)
        model = load_mjcf(asset_path or os.path.join(ASSETS, self.asset))
        # the class default n_substeps is tuned for penalty stability; the
        # Newton solve is implicit in its constraints like MuJoCo's and is
        # stable at the model dt (n_substeps=1)
        if n_substeps is not None:
            self.n_substeps = int(n_substeps)
        model.n_substeps = self.n_substeps
        # 'penalty' (kernel K1) or 'newton', MuJoCo-parity soft constraints
        # (kernel K2)
        model.constraint_solver = constraint_solver
        # penalty contact gains scaled to the body, as the reference does
        # (set in both modes):
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
        qvel = state.qd
        if self.clip_qvel_obs is not None:
            qvel = torch.clamp(qvel, -self.clip_qvel_obs, self.clip_qvel_obs)
        return torch.cat([state.q[:, self.exclude_positions :], qvel], dim=-1)

    def _healthy(self, state: EnvState) -> torch.Tensor:
        return torch.ones(state.q.shape[0], dtype=torch.bool, device=state.q.device)

    def _x_pos(self, state: EnvState) -> torch.Tensor:
        return state.q[:, 0]

    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator] = None):
        """``(q_noise, qd_noise)``: uniform in +-scale on q; on qd uniform
        in +-scale, or scale * normal where ``reset_vel_noise == 'normal'``."""
        s = self.reset_noise_scale
        kw = dict(device=self.device, generator=generator)
        q_noise = (2.0 * torch.rand(num_envs, self.model.nq, **kw) - 1.0) * s
        if self.reset_vel_noise == "normal":
            return q_noise, s * torch.randn(num_envs, self.model.nv, **kw)
        return q_noise, (2.0 * torch.rand(num_envs, self.model.nv, **kw) - 1.0) * s

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        return self.reset_from_noise(*self.reset_noise(num_envs, generator))

    def reset_from_noise(self, q_noise: torch.Tensor, qd_noise: torch.Tensor) -> Tuple[EnvState, torch.Tensor]:
        """Reset with the noise given: ``q = qpos0 + q_noise``, ``qd = qd_noise``."""
        state = EnvState(q=self.qpos0 + q_noise, qd=qd_noise.clone())
        return state, self._obs(state)

    def step(self, state: EnvState, action: torch.Tensor) -> StepResult:
        x_before = self._x_pos(state)
        q2, qd2 = self._frame_step(state.q, state.qd, action)
        state = EnvState(q=q2, qd=qd2)
        x_velocity = (self._x_pos(state) - x_before) / (self.model.dt * self.frame_skip)
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


class HopperEnv(LocomotionEnv):
    """Hopper-v4 conventions."""

    asset = "hopper.xml"
    frame_skip = 4
    ctrl_cost_weight = 1e-3
    healthy_reward = 1.0
    reset_noise_scale = 5e-3

    def _healthy(self, state: EnvState) -> torch.Tensor:
        rest = torch.cat([state.q[:, 2:], state.qd], dim=-1)
        healthy_state = (rest.abs() < 100.0).all(dim=-1)
        return healthy_state & (state.q[:, 1] > 0.7) & (state.q[:, 2].abs() < 0.2)


class Walker2dEnv(LocomotionEnv):
    """Walker2d-v4 conventions."""

    asset = "walker2d.xml"
    frame_skip = 4
    ctrl_cost_weight = 1e-3
    healthy_reward = 1.0
    reset_noise_scale = 5e-3

    def _healthy(self, state: EnvState) -> torch.Tensor:
        z, angle = state.q[:, 1], state.q[:, 2]
        return (z > 0.8) & (z < 2.0) & (angle.abs() < 1.0)


class HalfCheetahEnv(LocomotionEnv):
    """HalfCheetah-v4 conventions (no termination, ctrl cost 0.1)."""

    asset = "half_cheetah.xml"
    frame_skip = 5
    ctrl_cost_weight = 0.1
    healthy_reward = 0.0
    reset_noise_scale = 0.1
    reset_vel_noise = "normal"
    clip_qvel_obs = None
    n_substeps = 2  # dt=0.01 with ~1 kg limbs needs a finer contact substep


class AntEnv(LocomotionEnv):
    """Ant-v4 conventions (27-dim obs, no contact-force obs or cost)."""

    asset = "ant.xml"
    frame_skip = 5
    ctrl_cost_weight = 0.5
    healthy_reward = 1.0
    reset_noise_scale = 0.1
    reset_vel_noise = "normal"
    exclude_positions = 2
    clip_qvel_obs = None
    n_substeps = 4  # dt=0.01 with 0.04 kg limbs: penalty contacts need ~2.5 ms
    healthy_z_range = (0.2, 1.0)

    def _healthy(self, state: EnvState) -> torch.Tensor:
        z = state.q[:, 2]
        finite = torch.isfinite(state.q).all(dim=-1) & torch.isfinite(state.qd).all(dim=-1)
        lo, hi = self.healthy_z_range
        return finite & (z > lo) & (z < hi)


register("hopper", HopperEnv)
register("walker2d", Walker2dEnv)
register("half_cheetah", HalfCheetahEnv)
register("ant", AntEnv)
