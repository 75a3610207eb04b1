"""Analytic classic-control envs: pendulum swing-up and cartpole balance.

Twin of ``mjrl_tpu/envs/classic.py`` (``PendulumEnv``, ``CartpoleEnv``):
closed-form dynamics, no physics engine and no kernel; plain tensor ops
over the env batch on the env's device. Cartpole terminates when the pole
falls or the cart leaves the track, so it drives the samplers'
``terminated`` masks.

- pendulum: obs ``[cos th, sin th, th_dot]``, reward ``-(th^2 + 0.1 th_dot^2
  + 0.001 u^2)`` with ``th`` wrapped to ``[-pi, pi)``, ``info["success"]``
  while ``|th| < 0.2``; reset noise ``(theta, theta_dot)``, each ``(N,)``,
  uniform in +-pi and +-1.
- cartpole: obs ``[x, x_dot, theta, theta_dot]``, reward 1 a step,
  ``info["success"]`` 1 until it terminates; reset noise ``(v, empty)``,
  ``v`` ``(N, 4)`` uniform in +-0.05 and an ``(N, 0)`` second half.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from mjrl_tpu_torch.envs.base import Env, StepResult, register
from mjrl_tpu_torch.types import EnvSpec
from mjrl_tpu_torch.utils import trace


class PendulumState(NamedTuple):
    theta: torch.Tensor  # (B,), angle from upright
    theta_dot: torch.Tensor  # (B,)


class PendulumEnv(Env):
    """Torque-limited pendulum swing-up (gym Pendulum-style reward)."""

    state_type = PendulumState

    def __init__(self, horizon: int = 200, dt: float = 0.05, g: float = 10.0, m: float = 1.0,
                 l: float = 1.0, max_torque: float = 2.0, max_speed: float = 8.0,  # noqa: E741
                 device="cuda"):
        self.spec = EnvSpec(observation_dim=3, action_dim=1, horizon=horizon)
        self.device = torch.device(device)
        self.dt, self.g, self.m, self.l = dt, g, m, l
        self.max_torque, self.max_speed = max_torque, max_speed

    def _obs(self, s: PendulumState) -> torch.Tensor:
        return torch.stack([torch.cos(s.theta), torch.sin(s.theta), s.theta_dot], dim=-1)

    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator] = None):
        kw = dict(device=self.device, generator=generator)
        theta = (2.0 * torch.rand(num_envs, **kw) - 1.0) * math.pi
        return theta, 2.0 * torch.rand(num_envs, **kw) - 1.0

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        return self.reset_from_noise(*self.reset_noise(num_envs, generator))

    def reset_from_noise(self, theta: torch.Tensor,
                         theta_dot: torch.Tensor) -> Tuple[PendulumState, torch.Tensor]:
        s = PendulumState(theta.clone(), theta_dot.clone())
        return s, self._obs(s)

    @trace.spanned("env.step")
    def step(self, s: PendulumState, action: torch.Tensor) -> StepResult:
        u = torch.clamp(action[:, 0], -self.max_torque, self.max_torque)
        th = torch.remainder(s.theta + math.pi, 2.0 * math.pi) - math.pi
        cost = th**2 + 0.1 * s.theta_dot**2 + 0.001 * u**2
        thdot = s.theta_dot + self.dt * (3.0 * self.g / (2.0 * self.l) * torch.sin(s.theta)
                                         + 3.0 / (self.m * self.l**2) * u)
        thdot = torch.clamp(thdot, -self.max_speed, self.max_speed)
        new = PendulumState(s.theta + self.dt * thdot, thdot)
        success = (th.abs() < 0.2).to(cost.dtype)
        terminated = torch.zeros_like(cost, dtype=torch.bool)
        return new, self._obs(new), -cost, terminated, {"success": success}


class CartpoleState(NamedTuple):
    x: torch.Tensor  # (B,)
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor


class CartpoleEnv(Env):
    """Continuous-force cartpole; terminates when ``|x| > x_limit`` or
    ``|theta| > theta_limit``."""

    state_type = CartpoleState

    def __init__(self, horizon: int = 200, dt: float = 0.02, gravity: float = 9.8,
                 m_cart: float = 1.0, m_pole: float = 0.1, length: float = 0.5,
                 force_mag: float = 10.0, x_limit: float = 2.4, theta_limit: float = 0.2095,
                 device="cuda"):
        self.spec = EnvSpec(observation_dim=4, action_dim=1, horizon=horizon)
        self.device = torch.device(device)
        self.dt, self.gravity = dt, gravity
        self.m_cart, self.m_pole, self.length = m_cart, m_pole, length
        self.force_mag, self.x_limit, self.theta_limit = force_mag, x_limit, theta_limit

    def _obs(self, s: CartpoleState) -> torch.Tensor:
        return torch.stack(list(s), dim=-1)

    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator] = None):
        v = (2.0 * torch.rand(num_envs, 4, device=self.device, generator=generator) - 1.0) * 0.05
        return v, v.new_zeros(num_envs, 0)

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        return self.reset_from_noise(*self.reset_noise(num_envs, generator))

    def reset_from_noise(self, v: torch.Tensor,
                         empty: Optional[torch.Tensor] = None) -> Tuple[CartpoleState, torch.Tensor]:
        s = CartpoleState(*(v[:, i].clone() for i in range(4)))
        return s, self._obs(s)

    @trace.spanned("env.step")
    def step(self, s: CartpoleState, action: torch.Tensor) -> StepResult:
        force = self.force_mag * torch.clamp(action[:, 0], -1.0, 1.0)
        total_m = self.m_cart + self.m_pole
        pm_l = self.m_pole * self.length
        cos_t, sin_t = torch.cos(s.theta), torch.sin(s.theta)
        temp = (force + pm_l * s.theta_dot**2 * sin_t) / total_m
        theta_acc = (self.gravity * sin_t - cos_t * temp) / (
            self.length * (4.0 / 3.0 - self.m_pole * cos_t**2 / total_m))
        x_acc = temp - pm_l * theta_acc * cos_t / total_m
        new = CartpoleState(x=s.x + self.dt * s.x_dot, x_dot=s.x_dot + self.dt * x_acc,
                            theta=s.theta + self.dt * s.theta_dot,
                            theta_dot=s.theta_dot + self.dt * theta_acc)
        terminated = (new.x.abs() > self.x_limit) | (new.theta.abs() > self.theta_limit)
        reward = torch.ones_like(new.x)
        return new, self._obs(new), reward, terminated, {"success": 1.0 - terminated.to(reward.dtype)}


register("pendulum", PendulumEnv)
register("cartpole", CartpoleEnv)
