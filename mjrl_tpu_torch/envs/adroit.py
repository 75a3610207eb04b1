"""Adroit dexterous-hand tasks on the first-party physics: pen, relocate,
hammer and door.

Twin of ``mjrl_tpu/envs/adroit.py`` (``AdroitEnv`` and its four tasks),
the DAPG paper's environments (Rajeswaran et al., RSS 2018) on the ADROIT
MJCF assets: a 30-dof hand and arm (position servos, 44 coupled-finger
fixed tendons, frictionloss on every dof), the task's object, and a
capsule, sphere and box contact set. The env loads no ``mujoco``: each
model is the Gymnasium-Robotics asset compiled once on the host by
``physics/bridge.py`` with the reference's servo retuning
(``compile_adroit_model``) and stored in ``envs/assets/adroit_<task>.npz``
(``tools/torch_gen_adroit_model.py``); the env applies the reference's
settings (contact gains, one substep, per-dof and per-tendon limit gains).

Scene randomisation is data, as in the reference: each env carries its
link offsets (``link_delta``: the door's frame, relocate's ball and
hammer's board moved per episode; zeros for pen) and its task target in
the state. ``step`` advances all envs through one launch of kernel K3 per
control step, or of K4 with ``constraint_solver="newton"`` (MuJoCo-parity
soft contacts and joint limits; the tendon limits stay penalties, as in
the reference) (physics/dispatch.py); both take the offsets.
``use_soa=False`` (a config's ``env_kwargs.use_soa``) steps the envs on
the per-env engine instead, as the reference's runs with that setting did
(physics/engine.py: no kernel launch, the observation's included). On
the card the frame stepper's kernel path takes the observation's link
poses and sites (``_poses``: pen, relocate and door) in one launch of the
pose kernel (physics/pkernel.py ``POSES``); elsewhere they, and hammer's
kinematics and nail sensor (the contact wrench on the nail, from the
pairs that touch it: physics/contact.py), are plain PyTorch, as in the
reference. The rewards keep the DAPG paper's
signs by default (``reward_variant="dapg"``); ``"gymnasium_v1"`` flips the
sign of relocate's, hammer's and door's hand-to-object reach term, as
Gymnasium-Robotics' v1 envs do. Each reset
draws its noise first (``reset_noise``) and builds the state from it
(``reset_from_noise``), so a test can inject the reference's draws. Envs
live on the card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mjrl_tpu_torch.envs.base import Env, StepResult, register
from mjrl_tpu_torch.physics import math3d as m3
from mjrl_tpu_torch.physics.contact import contact_forces
from mjrl_tpu_torch.physics.dispatch import check_model, make_frame_stepper, uses_engine
from mjrl_tpu_torch.physics.engine import compute_kinematics, site_positions
from mjrl_tpu_torch.physics.model import Model, load_model_npz
from mjrl_tpu_torch.physics.pkernel import POSES
from mjrl_tpu_torch.physics.tables import scale_limit_penalties
from mjrl_tpu_torch.types import EnvSpec
from mjrl_tpu_torch.utils import trace

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


class AdroitState(NamedTuple):
    q: torch.Tensor  # (B, nq)
    qd: torch.Tensor  # (B, nv)
    link_delta: torch.Tensor  # (B, nlink, 3) per-episode body-position offsets
    target: torch.Tensor  # (B, 3) the task's target vector


def adroit_xml(task: str) -> str:
    """The installed Gymnasium-Robotics wheel's ``adroit_<task>.xml``."""
    import gymnasium_robotics

    return os.path.join(os.path.dirname(gymnasium_robotics.__file__), "envs", "assets",
                        "adroit_hand", f"adroit_{task}.xml")


def apply_gain_overrides(mj) -> None:
    """The servo retuning mj_envs and Gymnasium-Robotics make when they build
    an Adroit env, on a ``mujoco.MjModel``: the wrist servos kp=10, the
    finger servos kp=1 (twin of ``AdroitEnv._apply_gain_overrides``)."""
    import mujoco

    def aid(name):
        return mujoco.mj_name2id(mj, mujoco.mjtObj.mjOBJ_ACTUATOR, name)

    w0, w1 = aid("A_WRJ1"), aid("A_WRJ0")
    f0, f1 = aid("A_FFJ3"), aid("A_THJ0")
    mj.actuator_gainprm[w0 : w1 + 1, :3] = np.array([10, 0, 0])
    mj.actuator_biasprm[w0 : w1 + 1, :3] = np.array([0, -10, 0])
    mj.actuator_gainprm[f0 : f1 + 1, :3] = np.array([1, 0, 0])
    mj.actuator_biasprm[f0 : f1 + 1, :3] = np.array([0, -1, 0])


def compile_adroit_model(task: str) -> Model:
    """The ``Model`` stored in ``envs/assets/adroit_<task>.npz``: the
    wheel's asset through ``physics/bridge.py`` after the servo retuning.
    Needs ``mujoco`` and ``gymnasium_robotics`` (the host; the card's
    machine has neither and reads the stored file)."""
    from mjrl_tpu_torch.physics.bridge import load_mj_model, model_from_mujoco

    mj = load_mj_model(adroit_xml(task))
    apply_gain_overrides(mj)
    return model_from_mujoco(mj)


def adroit_model(task: str, constraint_solver: str = "penalty", use_soa: Optional[bool] = None):
    """The Adroit ``task``'s model (``envs/assets/adroit_<task>.npz``) with
    the reference env's settings: the solver, the penalty tuning for
    gram-scale fingers and hectogram objects (left as the reference leaves
    it under either solver), one 2 ms substep, per-dof limit gains. The
    Newton rows' parameters are filled by the frame stepper, before the
    first launch. ``use_soa``: the frame stepper's (physics/dispatch.py)."""
    model = load_model_npz(os.path.join(ASSETS, f"adroit_{task}.npz"))
    model.constraint_solver = constraint_solver
    model.contact_stiffness = 1000.0
    model.contact_damping = 6.0
    model.contact_depth_cap = 0.01
    model.friction_vel = 0.01
    model.n_substeps = 1
    scale_limit_penalties(model, omega=60.0)
    check_model(model, use_soa)
    return model


class AdroitEnv(Env):
    """Shared machinery: the model and its settings, the scene's root
    links and the reset's uniform draws, action scaling, the blow-up
    guard."""

    task: str
    frame_skip: int = 5
    default_horizon: int = 200
    state_type = AdroitState
    reward_variant: str = "dapg"  # or "gymnasium_v1": the reach term's sign flipped

    def __init__(self, horizon: Optional[int] = None, device="cuda",
                 constraint_solver: str = "penalty", use_soa: Optional[bool] = None,
                 reward_variant: Optional[str] = None):
        self.device = torch.device(device)
        if reward_variant is not None:
            if reward_variant not in ("dapg", "gymnasium_v1"):
                raise ValueError(f"reward_variant {reward_variant!r}")
            self.reward_variant = reward_variant
        self.model = model = adroit_model(self.task, constraint_solver, use_soa)
        self._frame_step = make_frame_stepper(model, self.frame_skip, with_link_delta=True,
                                              use_soa=use_soa)
        # the pose kernel takes the models K3 and K4 step
        self._poses_on_kernel = not uses_engine(model, use_soa)
        self._site = {n: i for i, n in enumerate(model.site_name)}
        self._link = {n: i for i, n in enumerate(model.link_name)}
        self._jnt_q = {n: model.link_qadr[i] for i, n in enumerate(model.jnt_name) if n}
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

    def _body_root_link(self, name: str) -> int:
        """The first link a (possibly multi-joint) body expands into: the
        one that carries the body's offset from its parent, where
        ``link_delta`` acts."""
        idx = self._link[name]
        while True:
            p = self.model.link_parent[idx]
            if p >= 0 and self.model.link_name[p].startswith(name + "__stage"):
                idx = p
            else:
                return idx

    def _link_pos(self, link: int) -> torch.Tensor:
        """``link``'s offset from its parent, ``(3,)`` on the device."""
        return torch.as_tensor(np.asarray(self.model.link_pos[link], np.float32),
                               device=self.device)

    def _rest_state(self, n: int) -> AdroitState:
        """``n`` envs at qpos0, at rest, with zero offsets and target."""
        return AdroitState(q=self.qpos0.expand(n, -1).clone(),
                           qd=self.qpos0.new_zeros(n, self.model.nv),
                           link_delta=self.qpos0.new_zeros(n, self.model.nlink, 3),
                           target=self.qpos0.new_zeros(n, 3))

    def _uniform(self, n: int, lo, hi, generator: Optional[torch.Generator]) -> torch.Tensor:
        """``(n, len(lo))`` draws uniform in ``[lo, hi)`` per column."""
        lo = torch.as_tensor(lo, dtype=torch.float32, device=self.device)
        hi = torch.as_tensor(hi, dtype=torch.float32, device=self.device)
        u = torch.rand(n, lo.shape[0], device=self.device, generator=generator)
        return u * (hi - lo) + lo

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        return self.reset_from_noise(*self.reset_noise(num_envs, generator))

    @property
    def _reach_sign(self) -> float:
        """The sign and weight of the hand-to-object reach term."""
        return -0.1 if self.reward_variant == "dapg" else 0.1

    def _scaled_ctrl(self, action: torch.Tensor) -> torch.Tensor:
        return self._act_mean + torch.clamp(action, -1.0, 1.0) * self._act_rng

    def _poses(self, st: AdroitState):
        """Link poses and site positions of ``st``, with its offsets: with
        the frame stepper on K3 or K4, the pose kernel's wrapper (one launch
        on the card, the plain version on the CPU); on the engine path the
        plain version."""
        if self._poses_on_kernel:
            return POSES(self.model, st.q, st.link_delta)
        return POSES.plain(self.model, st.q, st.link_delta)

    def _physics(self, st: AdroitState, ctrl: torch.Tensor) -> AdroitState:
        q, qd = self._frame_step(st.q, st.qd, ctrl, st.link_delta)
        return st._replace(q=q, qd=qd)

    def check(self) -> None:
        """Raise if the kernel flagged a fault (K4: an env-substep with more
        contact rows inside their margin than its build holds; the engine
        flags none)."""
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

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
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

    def reset_from_noise(self, angles: torch.Tensor, unused: Optional[torch.Tensor] = None):
        return self.reset_from_angles(angles[:, 0], angles[:, 1])

    def reset_from_angles(self, ex: torch.Tensor, ey: torch.Tensor) -> Tuple[AdroitState, torch.Tensor]:
        """The hand at qpos0, at rest, and the target axis rotated by ``ex``
        about x and then ``ey`` about y (radians; the reference goes through
        degrees and back, and so does this)."""
        rad = torch.stack([ex, ey, torch.zeros_like(ex)], dim=-1) * (180.0 / np.pi) * (np.pi / 180.0)
        eye = torch.eye(3, device=ex.device)
        qx, qy, qz = (m3.quat_from_axis_angle(eye[k], rad[:, k]) for k in range(3))
        quat = m3.quat_mul(qx, m3.quat_mul(qy, qz))
        st = self._rest_state(ex.shape[0])._replace(target=m3.quat_rotate(quat, self._tar_dir))
        return st, self._obs(st)

    @trace.spanned("env.step")
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


class AdroitRelocateEnv(AdroitEnv):
    """Move the blue ball to the target (mj_envs relocate-v0): 39-dim
    observation, the reach term, a lift term while the ball is over 4 cm
    and bonuses of 10 and 20 within 10 and 5 cm of the target; success
    within 10 cm. ``curriculum > 0`` starts each episode's ball part-way
    to the target (a blend ``u`` uniform in ``[0, curriculum)``)."""

    task = "relocate"

    def __init__(self, *args, curriculum: float = 0.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.curriculum = float(curriculum)
        self._obj = self._link["Object"]
        self._obj_root = self._body_root_link("Object")
        self._obj_base = self._link_pos(self._obj_root)
        self._palm = self._site["S_grasp"]

    @property
    def obs_dim(self) -> int:
        return (self.model.nq - 6) + 9  # qpos[:-6] + three 3-vectors

    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator] = None):
        """``(draws (N, 5 or 6), (N, 0))``: the ball's spawn x in +-0.15 and
        y in [-0.15, 0.3), the target in [-0.2, 0.2]^2 x [0.15, 0.35) and,
        with a curriculum, the blend ``u`` in [0, curriculum)."""
        lo, hi = [-0.15, -0.15, -0.2, -0.2, 0.15], [0.15, 0.3, 0.2, 0.2, 0.35]
        if self.curriculum > 0.0:
            lo, hi = lo + [0.0], hi + [self.curriculum]
        draws = self._uniform(num_envs, lo, hi, generator)
        return draws, draws.new_zeros(num_envs, 0)

    def reset_from_noise(self, draws: torch.Tensor, unused: Optional[torch.Tensor] = None):
        st = self._rest_state(draws.shape[0])
        dx, dy, target = draws[:, 0], draws[:, 1], draws[:, 2:5]
        base = self._obj_base
        delta = st.link_delta
        delta[:, self._obj_root, 0] = dx - base[0]
        delta[:, self._obj_root, 1] = dy - base[1]
        if self.curriculum > 0.0:
            u = draws[:, 5:6]
            spawn = torch.stack([dx, dy, base[2].expand_as(dx)], dim=-1)
            delta[:, self._obj_root] = (1.0 - u) * spawn + u * target - base
        st = st._replace(target=target.clone())
        return st, self._obs(st)

    def _features(self, st: AdroitState):
        """The palm (S_grasp site) and the ball's position."""
        pos, _, sites = self._poses(st)
        return sites[:, self._palm], pos[:, self._obj]

    def _obs(self, st: AdroitState, feats=None) -> torch.Tensor:
        palm, obj = feats if feats is not None else self._features(st)
        return torch.cat([st.q[:, :-6], palm - obj, palm - st.target, obj - st.target], dim=-1)

    @trace.spanned("env.step")
    def step(self, st: AdroitState, action: torch.Tensor) -> StepResult:
        st = self._physics(st, self._scaled_ctrl(action))
        feats = palm, obj = self._features(st)
        norm = lambda x: torch.linalg.vector_norm(x, dim=-1)  # noqa: E731
        goal_dist = norm(obj - st.target)
        zero = torch.zeros_like(goal_dist)
        reward = (self._reach_sign * norm(palm - obj)
                  + torch.where(obj[:, 2] > 0.04,
                                1.0 - 0.5 * norm(palm - st.target) - 0.5 * goal_dist, zero)
                  + torch.where(goal_dist < 0.1, zero + 10.0, zero)
                  + torch.where(goal_dist < 0.05, zero + 20.0, zero))
        success = goal_dist < 0.1
        reward, terminated, obs = self._guard(st, reward, torch.zeros_like(success),
                                              self._obs(st, feats))
        return st, obs, reward, terminated, {"success": success}


class AdroitHammerEnv(AdroitEnv):
    """Drive the nail into the board with the hammer (mj_envs hammer-v0):
    46-dim observation with the nail's touch sensor (the contact force on
    the nail, clipped at 1 N), the reach, head-to-nail, goal and velocity
    terms, a bonus of 2 while hammer and head are lifted and of 25 and 75
    within 2 and 1 cm of the goal; success within 1 cm. The board's height
    is drawn per episode. ``nail_init_max > 0`` starts each episode's nail
    already driven in by up to that share of its 0.081 m travel."""

    task = "hammer"
    _NAIL_TRAVEL = 0.081  # the nail_dir slide joint's success travel

    def __init__(self, *args, nail_init_max: float = 0.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.nail_init_max = float(nail_init_max)
        self._obj = self._link["Object"]
        self._nail = self._link["nail"]
        self._board_root = self._body_root_link("nail_board")
        self._board_base = self._link_pos(self._board_root)
        self._palm, self._target = self._site["S_grasp"], self._site["S_target"]
        self._tool, self._goal = self._site["tool"], self._site["nail_goal"]

    @property
    def obs_dim(self) -> int:
        return (self.model.nq - 6) + 6 + 3 + 3 + 3 + 3 + 1  # 46

    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator] = None):
        """``(draws (N, 1 or 2), (N, 0))``: the board's height in [0.1,
        0.25) and, with ``nail_init_max``, the nail's initial depth in [0,
        nail_init_max * 0.081)."""
        lo, hi = [0.1], [0.25]
        if self.nail_init_max > 0.0:
            lo, hi = lo + [0.0], hi + [self.nail_init_max * self._NAIL_TRAVEL]
        draws = self._uniform(num_envs, lo, hi, generator)
        return draws, draws.new_zeros(num_envs, 0)

    def reset_from_noise(self, draws: torch.Tensor, unused: Optional[torch.Tensor] = None):
        st = self._rest_state(draws.shape[0])
        st.link_delta[:, self._board_root, 2] = draws[:, 0] - self._board_base[2]
        if self.nail_init_max > 0.0:
            st.q[:, self._jnt_q["nail_dir"]] = draws[:, 1]
        return st, self._obs(st)

    def _features(self, st: AdroitState):
        """The kinematics with velocities (the sensor's contact damping
        reads them), the sites, the palm, the hammer's position and euler
        angles, the nail's head (S_target) and its touch sensor."""
        kin = compute_kinematics(self.model, st.q, st.qd, st.link_delta)
        sites = site_positions(self.model, kin.pos, kin.quat)
        f = contact_forces(self.model, kin, links=(self._nail,))[:, self._nail]
        impact = torch.clamp(torch.linalg.vector_norm(f[:, 3:], dim=-1), -1.0, 1.0)
        return (sites, sites[:, self._palm], kin.pos[:, self._obj],
                m3.quat_to_euler(kin.quat[:, self._obj]), sites[:, self._target], impact)

    def _obs(self, st: AdroitState, feats=None) -> torch.Tensor:
        _, palm, obj, obj_rot, nail, impact = feats if feats is not None else self._features(st)
        qv = torch.clamp(st.qd, -1.0, 1.0)
        return torch.cat([st.q[:, :-6], qv[:, -6:], palm, obj, obj_rot, nail, impact[:, None]],
                         dim=-1)

    @trace.spanned("env.step")
    def step(self, st: AdroitState, action: torch.Tensor) -> StepResult:
        st = self._physics(st, self._scaled_ctrl(action))
        feats = self._features(st)
        sites, palm, obj, _, nail, _ = feats
        head, goal = sites[:, self._tool], sites[:, self._goal]
        norm = lambda x: torch.linalg.vector_norm(x, dim=-1)  # noqa: E731
        goal_dist = norm(nail - goal)
        zero = torch.zeros_like(goal_dist)
        reward = (self._reach_sign * norm(palm - obj)
                  - norm(head - nail)
                  - 10.0 * goal_dist
                  - 1e-2 * norm(st.qd)
                  + torch.where((obj[:, 2] > 0.04) & (head[:, 2] > 0.04), zero + 2.0, zero)
                  + torch.where(goal_dist < 0.020, zero + 25.0, zero)
                  + torch.where(goal_dist < 0.010, zero + 75.0, zero))
        success = goal_dist < 0.01
        reward, terminated, obs = self._guard(st, reward, torch.zeros_like(success),
                                              self._obs(st, feats))
        return st, obs, reward, terminated, {"success": success}


class AdroitDoorEnv(AdroitEnv):
    """Undo the latch and swing the door open (mj_envs door-v0): 39-dim
    observation, the reach term, a pull toward 1.57 rad, a small velocity
    cost and bonuses of 2, 8 and 10 past 0.2, 1.0 and 1.35 rad; success
    past 1.35 rad. The door's frame is placed per episode."""

    task = "door"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._frame_root = self._body_root_link("frame")
        self._frame_base = self._link_pos(self._frame_root)
        self._hinge = self._jnt_q["door_hinge"]
        self._palm, self._handle = self._site["S_grasp"], self._site["S_handle"]

    @property
    def obs_dim(self) -> int:
        # qpos[1:-2] + latch + door + palm + handle + (palm - handle) + open flag
        return (self.model.nq - 3) + 1 + 1 + 3 + 3 + 3 + 1  # 39 for nq=30

    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator] = None):
        """``(frame (N, 3), (N, 0))``: the frame's position, x in [-0.3,
        -0.2), y in [0.25, 0.35), z in [0.252, 0.35)."""
        frame = self._uniform(num_envs, [-0.3, 0.25, 0.252], [-0.2, 0.35, 0.35], generator)
        return frame, frame.new_zeros(num_envs, 0)

    def reset_from_noise(self, frame: torch.Tensor, unused: Optional[torch.Tensor] = None):
        st = self._rest_state(frame.shape[0])
        st.link_delta[:, self._frame_root] = frame - self._frame_base
        return st, self._obs(st)

    def _features(self, st: AdroitState):
        """The palm (S_grasp site) and the handle (S_handle site)."""
        sites = self._poses(st)[2]
        return sites[:, self._palm], sites[:, self._handle]

    def _obs(self, st: AdroitState, feats=None) -> torch.Tensor:
        palm, handle = feats if feats is not None else self._features(st)
        q = st.q
        door = q[:, self._hinge : self._hinge + 1]
        is_open = torch.where(door > 1.0, 1.0, -1.0)
        return torch.cat([q[:, 1:-2], q[:, -1:], door, palm, handle, palm - handle, is_open],
                         dim=-1)

    @trace.spanned("env.step")
    def step(self, st: AdroitState, action: torch.Tensor) -> StepResult:
        st = self._physics(st, self._scaled_ctrl(action))
        feats = palm, handle = self._features(st)
        door = st.q[:, self._hinge]
        zero = torch.zeros_like(door)
        reward = (self._reach_sign * torch.linalg.vector_norm(palm - handle, dim=-1)
                  - 0.1 * (door - 1.57) ** 2
                  - 1e-5 * torch.sum(st.qd ** 2, dim=-1)
                  + torch.where(door > 0.2, zero + 2.0, zero)
                  + torch.where(door > 1.0, zero + 8.0, zero)
                  + torch.where(door > 1.35, zero + 10.0, zero))
        success = door > 1.35
        reward, terminated, obs = self._guard(st, reward, torch.zeros_like(success),
                                              self._obs(st, feats))
        return st, obs, reward, terminated, {"success": success}


register("adroit_relocate", AdroitRelocateEnv)
register("adroit_hammer", AdroitHammerEnv)
register("adroit_door", AdroitDoorEnv)
register("adroit_pen", AdroitPenEnv)
