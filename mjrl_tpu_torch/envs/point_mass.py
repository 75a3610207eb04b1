"""Analytic 2-D point-mass reacher (horizon 25), the cheap env of
``examples/point_mass_npg.json``.

Twin of ``mjrl_tpu/envs/point_mass.py``: a force-controlled point mass
must reach a random target, in closed form (no physics engine, no kernel;
plain tensor ops on the env's device):

    vel' = damping * vel + dt * gain * clip(a, -1, 1)
    pos' = clip(pos + dt * vel', +-2 arena)

Reward ``-|pos' - target| - ctrl_cost * |clip(a)|^2``; ``info["success"]``
when the mass is within ``success_radius`` of the target; no termination.
Observation ``[pos, vel, target - pos]``. The reset noise is the pair
``(pos, target)``, each uniform in +-arena. The reward is a function of
the action and the next observation alone, so model-based NPG scores
imagined transitions with ``reward_from_obs``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from mjrl_tpu_torch.envs.base import Env, StepResult, register
from mjrl_tpu_torch.types import EnvSpec
from mjrl_tpu_torch.utils import trace


class PointMassState(NamedTuple):
    pos: torch.Tensor  # (B, 2)
    vel: torch.Tensor  # (B, 2)
    target: torch.Tensor  # (B, 2)


class PointMassEnv(Env):
    state_type = PointMassState

    def __init__(self, horizon: int = 25, dt: float = 0.1, gain: float = 10.0,
                 damping: float = 0.9, ctrl_cost: float = 0.1, success_radius: float = 0.1,
                 arena: float = 2.0, device="cuda"):
        self.spec = EnvSpec(observation_dim=6, action_dim=2, horizon=horizon)
        self.device = torch.device(device)
        self.dt = dt
        self.gain = gain
        self.damping = damping
        self.ctrl_cost = ctrl_cost
        self.success_radius = success_radius
        self.arena = arena

    def _obs(self, state: PointMassState) -> torch.Tensor:
        return torch.cat([state.pos, state.vel, state.target - state.pos], dim=-1)

    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator] = None):
        """``(pos, target)``, each ``(num_envs, 2)`` uniform in +-arena."""
        kw = dict(device=self.device, generator=generator)
        pos = (2.0 * torch.rand(num_envs, 2, **kw) - 1.0) * self.arena
        return pos, (2.0 * torch.rand(num_envs, 2, **kw) - 1.0) * self.arena

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        return self.reset_from_noise(*self.reset_noise(num_envs, generator))

    def reset_from_noise(self, pos: torch.Tensor,
                         target: torch.Tensor) -> Tuple[PointMassState, torch.Tensor]:
        state = PointMassState(pos=pos.clone(), vel=torch.zeros_like(pos), target=target.clone())
        return state, self._obs(state)

    @trace.spanned("env.step")
    def step(self, state: PointMassState, action: torch.Tensor) -> StepResult:
        a = torch.clamp(action, -1.0, 1.0)
        vel = self.damping * state.vel + self.dt * self.gain * a
        pos = torch.clamp(state.pos + self.dt * vel, -2.0 * self.arena, 2.0 * self.arena)
        state = PointMassState(pos=pos, vel=vel, target=state.target)
        dist = torch.linalg.vector_norm(pos - state.target, dim=-1)
        reward = -dist - self.ctrl_cost * torch.sum(torch.square(a), dim=-1)
        success = (dist < self.success_radius).to(reward.dtype)
        terminated = torch.zeros_like(dist, dtype=torch.bool)
        return state, self._obs(state), reward, terminated, {"success": success}

    # -- obs-space hooks of model-based NPG ---------------------------------
    def reward_from_obs(self, obs: torch.Tensor, action: torch.Tensor,
                        next_obs: torch.Tensor) -> torch.Tensor:
        a = torch.clamp(action, -1.0, 1.0)
        dist = torch.linalg.vector_norm(next_obs[..., 4:6], dim=-1)
        return -dist - self.ctrl_cost * torch.sum(torch.square(a), dim=-1)

    def terminated_from_obs(self, next_obs: torch.Tensor) -> torch.Tensor:
        return torch.zeros(next_obs.shape[:-1], dtype=torch.bool, device=next_obs.device)


register("point_mass", PointMassEnv)
