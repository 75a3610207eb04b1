"""Adroit dexterous-hand tasks on the first-party physics: pen.

Twin of ``mjrl_tpu/envs/adroit.py`` (``AdroitEnv``, ``AdroitPenEnv``), the
DAPG paper's environments (Rajeswaran et al., RSS 2018) on the ADROIT MJCF
assets: a 30-dof hand and arm (24 position servos, 44 coupled-finger fixed
tendons, frictionloss on every dof) and a capsule and box contact set. The
port loads no ``mujoco``: the model is the JAX package's compilation of
the Gymnasium-Robotics asset, stored by ``tools/gen_adroit_model.py`` in
``envs/assets/adroit_<task>.npz``; the env applies the reference's
settings (contact gains, one substep, per-dof and per-tendon limit gains).

Scene randomisation is data, as in the reference: each env carries its
link offsets (``link_delta``, zeros for pen) and its task target in the
state. ``step`` advances all envs through one launch of kernel K3 per
control step, or of K4 with ``constraint_solver="newton"`` (MuJoCo-parity
soft contacts and joint limits; the tendon limits stay penalties, as in
the reference) (physics/dispatch.py); both take the offsets. Envs live on
the card unless ``device="cpu"`` is asked for. Relocate, hammer and door
are not ported yet (ROADMAP queue 1 item 3).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mjrl_tpu_torch.envs.base import Env, StepResult, register
from mjrl_tpu_torch.physics import math3d as m3
from mjrl_tpu_torch.physics.dispatch import make_frame_stepper
from mjrl_tpu_torch.physics.engine import forward_kinematics, site_positions
from mjrl_tpu_torch.physics.model import load_model_npz
from mjrl_tpu_torch.physics.soa import check_supported
from mjrl_tpu_torch.physics.tables import scale_limit_penalties
from mjrl_tpu_torch.types import EnvSpec

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


class AdroitState(NamedTuple):
    q: torch.Tensor  # (B, nq)
    qd: torch.Tensor  # (B, nv)
    link_delta: torch.Tensor  # (B, nlink, 3) per-episode body-position offsets
    target: torch.Tensor  # (B, 3) the task's target vector


def adroit_model(task: str, constraint_solver: str = "penalty"):
    """The Adroit ``task``'s model (``envs/assets/adroit_<task>.npz``) with
    the reference env's settings: the solver, the penalty tuning for
    gram-scale fingers and hectogram objects (left as the reference leaves
    it under either solver), one 2 ms substep, per-dof limit gains. The
    Newton rows' parameters are filled by the frame stepper, before the
    first launch."""
    model = load_model_npz(os.path.join(ASSETS, f"adroit_{task}.npz"))
    model.constraint_solver = constraint_solver
    model.contact_stiffness = 1000.0
    model.contact_damping = 6.0
    model.contact_depth_cap = 0.01
    model.friction_vel = 0.01
    model.n_substeps = 1
    scale_limit_penalties(model, omega=60.0)
    check_supported(model)
    return model


class AdroitEnv(Env):
    """Shared machinery: the model and its settings, action scaling, the
    blow-up guard."""

    task: str
    frame_skip: int = 5
    default_horizon: int = 200
    state_type = AdroitState

    def __init__(self, horizon: Optional[int] = None, device="cuda",
                 constraint_solver: str = "penalty"):
        self.device = torch.device(device)
        self.model = model = adroit_model(self.task, constraint_solver)
        self._frame_step = make_frame_stepper(model, self.frame_skip, with_link_delta=True)
        self._site = {n: i for i, n in enumerate(model.site_name)}
        self._link = {n: i for i, n in enumerate(model.link_name)}
        rng = np.asarray(model.act_ctrlrange, np.float64)
        self._act_mean = torch.as_tensor(0.5 * (rng[:, 0] + rng[:, 1]), dtype=torch.float32,
                                         device=self.device)
        self._act_rng = torch.as_tensor(0.5 * (rng[:, 1] - rng[:, 0]), dtype=torch.float32,
                                        device=self.device)
        self.qpos0 = torch.as_tensor(model.default_qpos, dtype=torch.float32, device=self.device)
        self.spec = EnvSpec(observation_dim=self.obs_dim, action_dim=model.nu,
                            horizon=horizon or self.default_horizon)

    @property
    def obs_dim(self) -> int:
        raise NotImplementedError

    def _scaled_ctrl(self, action: torch.Tensor) -> torch.Tensor:
        return self._act_mean + torch.clamp(action, -1.0, 1.0) * self._act_rng

    def _poses(self, st: AdroitState):
        """Link poses and site positions of ``st``, with its offsets."""
        pos, quat = forward_kinematics(self.model, st.q, st.link_delta)
        return pos, quat, site_positions(self.model, pos, quat)

    def _physics(self, st: AdroitState, ctrl: torch.Tensor) -> AdroitState:
        q, qd = self._frame_step(st.q, st.qd, ctrl, st.link_delta)
        return st._replace(q=q, qd=qd)

    def check(self) -> None:
        """Raise if the kernel flagged a fault (K4: an env-substep with more
        contact rows inside their margin than its build holds)."""
        self._frame_step.check()

    @staticmethod
    def _guard(st: AdroitState, reward, terminated, obs):
        """A diverged state (non-finite, or |qd| >= 1e4) terminates with
        reward 0, and non-finite observations become 0, as in the
        reference: one blown-up env must not poison the batch's returns."""
        sane = (torch.isfinite(st.q).all(dim=-1) & torch.isfinite(st.qd).all(dim=-1)
                & (st.qd.abs().amax(dim=-1) < 1e4))
        reward = torch.where(sane, reward, torch.zeros_like(reward))
        obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
        return reward, terminated | ~sane, obs


class AdroitPenEnv(AdroitEnv):
    """Reorient the pen in-hand to a target orientation (mj_envs pen-v0):
    45-dim observation, dense orientation reward with the reference's
    bonuses, ``info["success"]`` when the pen is within 7.5 cm of its place
    and its axis within cos 0.95 of the target."""

    task = "pen"
    default_horizon = 100

    def __init__(self, horizon: Optional[int] = None, device="cuda",
                 constraint_solver: str = "penalty"):
        super().__init__(horizon=horizon, device=device, constraint_solver=constraint_solver)
        sp = self.model.site_pos
        ot, ob = self._site["object_top"], self._site["object_bottom"]
        tt, tb = self._site["target_top"], self._site["target_bottom"]
        axis = sp[ot] - sp[ob]
        self._pen_axis = torch.as_tensor(axis, dtype=torch.float32, device=self.device)
        self._pen_len = float(np.linalg.norm(axis))
        self._tar_dir = torch.as_tensor(
            (sp[tt] - sp[tb]) / max(float(np.linalg.norm(sp[tt] - sp[tb])), 1e-9),
            dtype=torch.float32, device=self.device)
        self._obj = self._link["Object"]
        self._eps_ball = self._site["eps_ball"]

    @property
    def obs_dim(self) -> int:
        return (self.model.nq - 6) + 3 + 6 + 3 + 3 + 3 + 3  # 45 for nq=30

    def _features(self, st: AdroitState):
        """The pen's position, its place (the eps_ball site) and its unit
        axis."""
        pos, quat, sites = self._poses(st)
        orien = m3.quat_rotate(quat[:, self._obj], self._pen_axis) / self._pen_len
        return pos[:, self._obj], sites[:, self._eps_ball], orien

    def _obs(self, st: AdroitState, feats=None) -> torch.Tensor:
        obj, place, orien = feats if feats is not None else self._features(st)
        return torch.cat([st.q[:, :-6], obj, st.qd[:, -6:], orien, st.target, obj - place,
                          orien - st.target], dim=-1)

    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator] = None):
        """The reset's draws ``(angles (N, 2), (N, 0))``: the target's x and
        y rotation, uniform in +-1 rad (pen's reset draws nothing else)."""
        angles = 2.0 * torch.rand(num_envs, 2, device=self.device, generator=generator) - 1.0
        return angles, angles.new_zeros(num_envs, 0)

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        return self.reset_from_noise(*self.reset_noise(num_envs, generator))

    def reset_from_noise(self, angles: torch.Tensor, unused: Optional[torch.Tensor] = None):
        return self.reset_from_angles(angles[:, 0], angles[:, 1])

    def reset_from_angles(self, ex: torch.Tensor, ey: torch.Tensor) -> Tuple[AdroitState, torch.Tensor]:
        """The hand at qpos0, at rest, and the target axis rotated by ``ex``
        about x and then ``ey`` about y (radians; the reference goes through
        degrees and back, and so does this)."""
        n = ex.shape[0]
        rad = torch.stack([ex, ey, torch.zeros_like(ex)], dim=-1) * (180.0 / np.pi) * (np.pi / 180.0)
        eye = torch.eye(3, device=ex.device)
        qx, qy, qz = (m3.quat_from_axis_angle(eye[k], rad[:, k]) for k in range(3))
        quat = m3.quat_mul(qx, m3.quat_mul(qy, qz))
        st = AdroitState(q=self.qpos0.expand(n, -1).clone(),
                         qd=self.qpos0.new_zeros(n, self.model.nv),
                         link_delta=self.qpos0.new_zeros(n, self.model.nlink, 3),
                         target=m3.quat_rotate(quat, self._tar_dir))
        return st, self._obs(st)

    def step(self, st: AdroitState, action: torch.Tensor) -> StepResult:
        st = self._physics(st, self._scaled_ctrl(action))
        feats = self._features(st)
        obj, place, orien = feats
        goal_dist = torch.linalg.vector_norm(obj - place, dim=-1)
        similarity = torch.sum(orien * st.target, dim=-1)
        near = goal_dist < 0.075
        zero = torch.zeros_like(goal_dist)
        reward = (-goal_dist + similarity
                  + torch.where(near & (similarity > 0.9), zero + 10.0, zero)
                  + torch.where(near & (similarity > 0.95), zero + 50.0, zero)
                  - torch.where(obj[:, 2] < 0.075, zero + 5.0, zero))
        success = near & (similarity > 0.95)
        reward, terminated, obs = self._guard(st, reward, torch.zeros_like(near),
                                              self._obs(st, feats))
        return st, obs, reward, terminated, {"success": success}


def _not_ported(task: str):
    def factory(**_):
        raise NotImplementedError(f"adroit_{task} is not ported yet (ROADMAP queue 1 item 3)")
    return factory


register("adroit_pen", AdroitPenEnv)
for _task in ("relocate", "hammer", "door"):
    register(f"adroit_{_task}", _not_ported(_task))
