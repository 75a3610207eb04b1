"""Pen (mj_envs pen-v0): the 45-dim observation and the reward of a state."""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference.envs.adroit_common import AdroitReference
from gpubench.reference.physics.math3d import quat_rotate


class ReferenceEnv(AdroitReference):
    task = "pen"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        sp = self.model.site_pos
        axis = np.asarray(sp[self.site["object_top"]]) - np.asarray(sp[self.site["object_bottom"]])
        self.pen_axis = torch.tensor(axis, dtype=torch.float32, device=self.device)
        self.pen_len = float(np.linalg.norm(axis))

    def obs_reward(self, st):
        pos, quat, sites = self.poses(st)
        obj_link = self.link["Object"]
        obj, place = pos[:, obj_link], sites[:, self.site["eps_ball"]]
        orien = quat_rotate(quat[:, obj_link], self.pen_axis) / self.pen_len
        target = st["target"]
        dist = torch.linalg.vector_norm(obj - place, dim=-1)
        sim = torch.sum(orien * target, dim=-1)
        near = dist < 0.075
        zero = torch.zeros_like(dist)
        reward = (-dist + sim + torch.where(near & (sim > 0.9), zero + 10.0, zero)
                  + torch.where(near & (sim > 0.95), zero + 50.0, zero)
                  - torch.where(obj[:, 2] < 0.075, zero + 5.0, zero))
        obs = torch.cat([st["q"][:, :-6], obj, st["qd"][:, -6:], orien, target, obj - place,
                         orien - target], dim=-1)
        reward, obs = self.guard(st, reward, obs)
        return obs, reward
