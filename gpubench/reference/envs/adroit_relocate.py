"""Relocate (mj_envs relocate-v0, the DAPG paper's signs): the 39-dim
observation and the reward of a state."""

from __future__ import annotations

import torch

from gpubench.reference.envs.adroit_common import AdroitReference


class ReferenceEnv(AdroitReference):
    task = "relocate"

    def obs_reward(self, st):
        pos, quat, sites = self.poses(st)
        palm, obj, target = sites[:, self.site["S_grasp"]], pos[:, self.link["Object"]], st["target"]
        norm = lambda x: torch.linalg.vector_norm(x, dim=-1)  # noqa: E731
        goal = norm(obj - target)
        zero = torch.zeros_like(goal)
        reward = (-0.1 * norm(palm - obj)
                  + torch.where(obj[:, 2] > 0.04, 1.0 - 0.5 * norm(palm - target) - 0.5 * goal,
                                zero)
                  + torch.where(goal < 0.1, zero + 10.0, zero)
                  + torch.where(goal < 0.05, zero + 20.0, zero))
        obs = torch.cat([st["q"][:, :-6], palm - obj, palm - target, obj - target], dim=-1)
        reward, obs = self.guard(st, reward, obs)
        return obs, reward
