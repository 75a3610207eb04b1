"""The per-env rigid-body engine, batch-first: kinematics -> CRB/RNE ->
contacts or the Newton solve -> semi-implicit Euler.

Twin of ``mjrl_tpu/physics/engine.py``. The reference advances one env per
call and ``vmap``s it; here every function takes the env batch as the
leading dim (``q (B, nq)``, ``qd (B, nv)``, ``ctrl (B, nu)``) and is one
set of ops over the batch, vectorised as the reference's is: joint poses
batched by joint type, the tree composed one depth level per step, link
velocities one matmul with the ancestor mask, the mass matrix
``sym(mask * (F cdof^T))`` of composite inertias and the bias forces one
contraction, all in one world-aligned frame about the root link's position
(``Kinematics.origin``). So the number of ops, each a launch on the card,
does not grow with the batch: humanoid's whole observation (with
physics/contact.py and comfeat.py) issues about 1350, views aside.

Two users:

- the observation of the envs stepped by kernels K1-K4
  (physics/pkernel.py): humanoid's com-based features
  (physics/comfeat.py) and contact wrenches (physics/contact.py), and
  Adroit's link and site positions;
- ``step``, the per-env stepper that physics/dispatch.py runs where the
  kernels do not: ``use_soa=False``, ball joints, planes on a moving link.
  It takes every joint type (free, ball, hinge, slide), every contact kind
  (physics/contact.py), the fluid model, gear motors and gain/bias servos,
  springs, limit penalties, frictionloss and fixed tendons, with the
  penalty solver or the Newton soft-constraint solve (physics/csolve.py).
  Forward dynamics solves ``(M + diag(armature) + dt D) qdd = tau - C - D
  qd`` by a batched Cholesky (``torch.linalg.cholesky_ex``; the
  reference's ``ops/smallchol.py`` unrolls it for the TPU), which makes
  the joint and limit dampers implicit, then integrates semi-implicitly
  with exponential-map quaternion updates for ball and free joints.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mjrl_tpu_torch.physics import math3d as m3
from mjrl_tpu_torch.physics.model import BALL, FREE, HINGE, SLIDE, Model
from mjrl_tpu_torch.physics.tables import tree_tables


class PhysicsState(NamedTuple):
    q: torch.Tensor  # (B, nq)
    qd: torch.Tensor  # (B, nv)


class Kinematics(NamedTuple):
    """World poses and world-frame spatial quantities of a batch. Spatial
    vectors are about ``origin`` (link 0's position): motion ``[omega,
    v at origin]``, force ``[torque about origin, f]``."""

    pos: torch.Tensor  # (B, nlink, 3)
    quat: torch.Tensor  # (B, nlink, 4)
    origin: torch.Tensor  # (B, 3)
    cdof: torch.Tensor  # (B, nv, 6)
    cvel: torch.Tensor  # (B, nlink, 6)
    qd: torch.Tensor  # (B, nv)


class _FKTables(NamedTuple):
    levels: Tuple[np.ndarray, ...]  # link indices per tree depth
    level_parents: Tuple[np.ndarray, ...]
    hinge_links: np.ndarray
    slide_links: np.ndarray
    ball_links: np.ndarray
    free_links: np.ndarray


def _fk_tables(model: Model) -> _FKTables:
    cached = getattr(model, "_fk_tables", None)
    if cached is not None:
        return cached
    nlink = model.nlink
    depth = np.zeros(nlink, np.int32)
    for i in range(nlink):
        p = model.link_parent[i]
        depth[i] = 0 if p < 0 else depth[p] + 1
    levels = tuple(np.flatnonzero(depth == d) for d in range(int(depth.max()) + 1))
    of = lambda t: np.asarray([i for i in range(nlink) if model.link_jnt_type[i] == t], np.int64)
    tables = _FKTables(levels=levels,
                       level_parents=tuple(np.asarray(model.link_parent)[lv] for lv in levels),
                       hinge_links=of(HINGE), slide_links=of(SLIDE), ball_links=of(BALL),
                       free_links=of(FREE))
    model._fk_tables = tables
    return tables


def const(model: Model, name: str, value, device: torch.device,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A static model array on ``device`` (f32, or an index array as
    int64), memoized on the model: a step on the card copies nothing from
    the host."""
    cache = model.__dict__.setdefault("_engine_consts", {})
    key = (name, str(device))
    t = cache.get(key)
    if t is None:
        np_dtype = np.int64 if dtype == torch.int64 else np.float32
        t = torch.as_tensor(np.asarray(value, np_dtype), device=device)
        cache[key] = t
    return t


def forward_kinematics(model: Model, q: torch.Tensor, link_pos_delta=None):
    """World link poses ``(pos (B, nlink, 3), quat (B, nlink, 4))``.
    ``link_pos_delta`` (``(B, nlink, 3)``): per-env offsets of each link's
    position in its parent's frame (Adroit's randomised scenes)."""
    tab = _fk_tables(model)
    dev, B, nlink = q.device, q.shape[0], model.nlink
    qadr = np.asarray(model.link_qadr)
    jp = q.new_zeros(B, nlink, 3)
    jq = q.new_zeros(B, nlink, 4)
    jq[..., 0] = 1.0
    H = tab.hinge_links
    if H.size:
        angles = (q[:, const(model, "qadr_h", qadr[H], dev, torch.int64)]
                  - const(model, "ref_h", model.jnt_ref[H], dev))
        Hi = const(model, "hinge_links", H, dev, torch.int64)
        anchors = const(model, "anchor_h", model.jnt_anchor[H], dev)
        quats = m3.quat_from_axis_angle(const(model, "axis_h", model.jnt_axis[H], dev), angles)
        jq[:, Hi] = quats
        jp[:, Hi] = anchors - m3.quat_rotate(quats, anchors)
    S = tab.slide_links
    if S.size:
        disp = (q[:, const(model, "qadr_s", qadr[S], dev, torch.int64)]
                - const(model, "ref_s", model.jnt_ref[S], dev))
        jp[:, const(model, "slide_links", S, dev, torch.int64)] = (
            const(model, "axis_s", model.jnt_axis[S], dev) * disp[..., None])
    Bl = tab.ball_links
    if Bl.size:
        quats = m3.quat_normalize(q[:, const(model, "qadr_b", qadr[Bl, None] + np.arange(4), dev,
                                             torch.int64)])
        anchors = const(model, "anchor_b", model.jnt_anchor[Bl], dev)
        Bi = const(model, "ball_links", Bl, dev, torch.int64)
        jq[:, Bi] = quats
        jp[:, Bi] = anchors - m3.quat_rotate(quats, anchors)
    for i in tab.free_links:
        adr = int(qadr[i])
        jp[:, i] = q[:, adr : adr + 3]
        jq[:, i] = m3.quat_normalize(q[:, adr + 3 : adr + 7])
    off_q = const(model, "link_quat", model.link_quat, dev)
    off_p = const(model, "link_pos", model.link_pos, dev)
    if link_pos_delta is not None:
        off_p = off_p + link_pos_delta
    rel_p = off_p + m3.quat_rotate(off_q, jp)
    rel_q = m3.quat_mul(off_q, jq)
    pos, quat = rel_p.clone(), rel_q.clone()
    for d in range(1, len(tab.levels)):
        lvl = const(model, f"level{d}", tab.levels[d], dev, torch.int64)
        parents = const(model, f"level_parents{d}", tab.level_parents[d], dev, torch.int64)
        pos[:, lvl] = pos[:, parents] + m3.quat_rotate(quat[:, parents], rel_p[:, lvl])
        quat[:, lvl] = m3.quat_mul(quat[:, parents], rel_q[:, lvl])
    return pos, quat


def _build_cdof(model: Model, pos: torch.Tensor, quat: torch.Tensor,
                origin: torch.Tensor) -> torch.Tensor:
    """World-frame dof subspaces about ``origin``: ``(B, nv, 6)``."""
    tab = _fk_tables(model)
    dev, B = pos.device, pos.shape[0]
    vadr = np.asarray(model.link_vadr)
    cdof = pos.new_zeros(B, model.nv, 6)
    H = tab.hinge_links
    if H.size:
        Hi = const(model, "hinge_links", H, dev, torch.int64)
        R = m3.quat_to_mat(quat[:, Hi])
        axis_w = torch.einsum("bhij,hj->bhi", R, const(model, "axis_h", model.jnt_axis[H], dev))
        anchor_w = pos[:, Hi] - origin[:, None] + torch.einsum(
            "bhij,hj->bhi", R, const(model, "anchor_h", model.jnt_anchor[H], dev))
        cdof[:, const(model, "vadr_h", vadr[H], dev, torch.int64)] = torch.cat(
            [axis_w, m3.cross(anchor_w, axis_w)], dim=-1)
    S = tab.slide_links
    if S.size:
        R = m3.quat_to_mat(quat[:, const(model, "slide_links", S, dev, torch.int64)])
        axis_w = torch.einsum("bhij,hj->bhi", R, const(model, "axis_s", model.jnt_axis[S], dev))
        cdof[:, const(model, "vadr_s", vadr[S], dev, torch.int64)] = torch.cat(
            [torch.zeros_like(axis_w), axis_w], dim=-1)
    for i in tab.ball_links:
        R = m3.quat_to_mat(quat[:, i])
        e = R.transpose(-1, -2)  # rows: the columns of R
        anchor_w = pos[:, i] - origin + R @ const(model, f"anchor_{i}", model.jnt_anchor[i], dev)
        v = int(vadr[i])
        cdof[:, v : v + 3] = torch.cat([e, m3.cross(anchor_w[:, None, :], e)], dim=-1)
    for i in tab.free_links:
        e = m3.quat_to_mat(quat[:, i]).transpose(-1, -2)  # rows: the columns of R
        p_rel = (pos[:, i] - origin)[:, None, :]
        v = int(vadr[i])
        cdof[:, v : v + 3] = torch.cat([e, m3.cross(p_rel, e)], dim=-1)
        cdof[:, v + 3 : v + 6] = torch.cat([torch.zeros_like(e), e], dim=-1)
    return cdof


def compute_kinematics(model: Model, q: torch.Tensor, qd: torch.Tensor,
                       link_pos_delta=None) -> Kinematics:
    pos, quat = forward_kinematics(model, q, link_pos_delta)
    origin = pos[:, 0]
    cdof = _build_cdof(model, pos, quat, origin)
    L = const(model, "L_mask", tree_tables(model).L_mask, q.device)
    cvel = torch.einsum("ln,bnk->blk", L, cdof * qd[..., None])
    return Kinematics(pos=pos, quat=quat, origin=origin, cdof=cdof, cvel=cvel, qd=qd)


def site_positions(model: Model, pos: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """World positions of all sites ``(B, nsite, 3)`` from the link poses;
    a world site (link -1) stays where it is."""
    dev = pos.device
    links = np.asarray(model.site_link, np.int64)
    ix = const(model, "site_ix", np.where(links < 0, model.nlink, links), dev, torch.int64)
    pos_all = torch.cat([pos, pos.new_zeros(pos.shape[0], 1, 3)], dim=1)
    ident = const(model, "quat_identity", [1.0, 0.0, 0.0, 0.0], dev).expand(quat.shape[0], 1, 4)
    quat_all = torch.cat([quat, ident], dim=1)
    return pos_all[:, ix] + m3.quat_rotate(quat_all[:, ix], const(model, "site_pos", model.site_pos, dev))


def joint_subspaces(model: Model) -> List[Optional[np.ndarray]]:
    """Static child-frame ``(6, d)`` subspaces of each link's joint (None
    for a fixed link), for oracle tests; the engine itself uses the
    world-frame ``cdof``."""
    out = []
    for i in range(model.nlink):
        t = model.link_jnt_type[i]
        anchor = np.asarray(model.jnt_anchor[i], np.float32)
        if t == -1:
            out.append(None)
        elif t == HINGE:
            a = np.asarray(model.jnt_axis[i], np.float32)
            out.append(np.concatenate([a, np.cross(anchor, a)]).reshape(6, 1))
        elif t == SLIDE:
            out.append(np.concatenate([np.zeros(3), model.jnt_axis[i]]).reshape(6, 1))
        elif t == BALL:
            s = np.zeros((6, 3), np.float32)
            s[:3] = np.eye(3)
            s[3:] = np.array([[0, -anchor[2], anchor[1]], [anchor[2], 0, -anchor[0]],
                              [-anchor[1], anchor[0], 0]], np.float32)
            out.append(s)
        else:  # FREE
            out.append(np.eye(6, dtype=np.float32))
    return out


def actuation(model: Model, ctrl: torch.Tensor,
              state: Optional[PhysicsState] = None) -> torch.Tensor:
    """Joint torques of the actuators, ``(B, nv)``, from ``ctrl`` clipped
    to the ctrl range where limited: gear motors, or with
    ``act_gainprm``/``act_biasprm`` MuJoCo's fixed-gain, affine-bias servo
    ``force = gain_0 ctrl + b_0 + b_1 gear q + b_2 gear qd`` (which reads
    ``state``); the torque on the dof is ``gear * force``."""
    dev = ctrl.device
    if model.nu == 0:
        return ctrl.new_zeros(ctrl.shape[0], model.nv)
    lo = const(model, "ctrl_lo", np.asarray(model.act_ctrlrange)[:, 0], dev)
    hi = const(model, "ctrl_hi", np.asarray(model.act_ctrlrange)[:, 1], dev)
    limited = const(model, "ctrl_limited", np.asarray(model.act_ctrllimited) > 0, dev) > 0
    c = torch.where(limited, torch.minimum(torch.maximum(ctrl, lo), hi), ctrl)
    gear = const(model, "act_gear", model.act_gear, dev)
    force = c
    if model.act_gainprm is not None:
        gain = const(model, "act_gainprm", model.act_gainprm, dev)
        bias = const(model, "act_biasprm", model.act_biasprm, dev)
        q_i = state.q[:, const(model, "act_qadr", model.act_qadr, dev, torch.int64)]
        qd_i = state.qd[:, const(model, "act_vadr", model.act_vadr, dev, torch.int64)]
        force = gain[:, 0] * c + bias[:, 0] + bias[:, 1] * (gear * q_i) + bias[:, 2] * (gear * qd_i)
    P_v = np.zeros((model.nu, model.nv), np.float32)  # one-hot rows: actuator -> dof
    P_v[np.arange(model.nu), np.asarray(model.act_vadr)] = 1.0
    return (gear * force) @ const(model, "act_sel", P_v, dev)


# ---------------------------------------------------------------------------
# Dynamics: composite inertias, the mass matrix, the bias forces.
# ---------------------------------------------------------------------------


def _link_ancestor_matrix(model: Model) -> np.ndarray:
    """``(nlink, nlink)``: ``A[l, d] = 1`` iff link l is an ancestor of
    link d or d itself."""
    cached = getattr(model, "_link_anc", None)
    if cached is None:
        n = model.nlink
        cached = np.zeros((n, n), np.float32)
        for d in range(n):
            j = d
            while j >= 0:
                cached[j, d] = 1.0
                j = model.link_parent[j]
        model._link_anc = cached
    return cached


def _world_inertias(model: Model, kin: Kinematics):
    """Each link's spatial inertia about ``kin.origin`` in world axes:
    ``mass (nlink,)``, ``h = m com (B, nlink, 3)``, ``I (B, nlink, 3, 3)``."""
    dev = kin.pos.device
    R = m3.quat_to_mat(kin.quat)
    mass = const(model, "link_mass", model.link_mass, dev)
    com_w = kin.pos - kin.origin[:, None] + torch.einsum(
        "blij,lj->bli", R, const(model, "link_com", model.link_com, dev))
    i_com_w = torch.einsum("blij,ljk,blmk->blim", R,
                           const(model, "link_inertia_com", model.link_inertia_com, dev), R)
    cx = m3.skew(com_w)
    i_org = i_com_w + mass[:, None, None] * cx @ cx.transpose(-1, -2)
    return mass, mass[:, None] * com_w, i_org


def _inertia_mul_batched(mass, h, I, v):
    """``I_spatial v`` for stacked links: motion ``v (..., 6)`` -> force:
    ``n = I w + h x lin``, ``f = m lin - h x w``."""
    w, lin = v[..., :3], v[..., 3:]
    n = torch.einsum("...ij,...j->...i", I, w) + m3.cross(h, lin)
    f = mass[..., None] * lin - m3.cross(h, w)
    return torch.cat([n, f], dim=-1)


def crba(model: Model, kin: Kinematics) -> torch.Tensor:
    """The joint-space mass matrix ``(B, nv, nv)`` (without armature) by
    composite rigid bodies: ``M[i, j] = (I_crb[link(i)] cdof_i) . cdof_j``
    on the tree's lower triangle, mirrored."""
    dev = kin.pos.device
    tables = tree_tables(model)
    mass, h, I = _world_inertias(model, kin)
    A = const(model, "link_anc", _link_ancestor_matrix(model), dev)
    c_mass = A @ mass
    c_h = torch.einsum("ld,bdi->bli", A, h)
    c_I = torch.einsum("ld,bdij->blij", A, I)
    dl = const(model, "dof_link", tables.dof_link, dev, torch.int64)
    F = _inertia_mul_batched(c_mass[dl], c_h[:, dl], c_I[:, dl], kin.cdof)
    # the lower triangle: a ball or free joint's own dof pairs stand in
    # dof_mask in both orders and would count twice in the mirror
    mask = const(model, "crba_mask",
                 np.tril(np.ones((model.nv, model.nv), np.float32)) * tables.dof_mask, dev)
    Mlow = mask * (F @ kin.cdof.transpose(-1, -2))
    return Mlow + Mlow.transpose(-1, -2) - torch.diag_embed(torch.diagonal(Mlow, dim1=-2, dim2=-1))


def rnea_bias(model: Model, kin: Kinematics,
              f_ext_world: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``C(q, qd)`` with gravity, ``(B, nv)``, minus the external wrenches
    ``f_ext_world (B, nlink, 6)`` about ``kin.origin``."""
    dev = kin.pos.device
    tables = tree_tables(model)
    L = const(model, "L_mask", tables.L_mask, dev)
    dl = const(model, "dof_link", tables.dof_link, dev, torch.int64)
    cdofdot = m3.crm(kin.cvel[:, dl], kin.cdof)  # exact for every joint type
    a0 = const(model, "gravity_acc", np.concatenate([np.zeros(3), -np.asarray(model.gravity)]), dev)
    cacc = a0 + torch.einsum("ln,bnk->blk", L, cdofdot * kin.qd[..., None])
    mass, h, I = _world_inertias(model, kin)
    Iv = _inertia_mul_batched(mass, h, I, kin.cvel)
    f = _inertia_mul_batched(mass, h, I, cacc) + m3.crf(kin.cvel, Iv)
    if f_ext_world is not None:
        f = f - f_ext_world
    G = f @ kin.cdof.transpose(-1, -2)  # (B, nlink, nv): C_j = sum_l L[l, j] f_l . cdof_j
    return torch.sum(G * L, dim=1)


# ---------------------------------------------------------------------------
# Applied forces.
# ---------------------------------------------------------------------------


def _limit_bounds(model: Model, li: np.ndarray, dev):
    """Full-width range bounds of the 1-dof joints, +-1e30 where a joint is
    unlimited (its violation is then exactly 0)."""
    limited = np.asarray(model.jnt_limited)[li] > 0
    rng = np.asarray(model.jnt_range)[li]
    return (const(model, "lim_lo", np.where(limited, rng[:, 0], -1e30), dev),
            const(model, "lim_hi", np.where(limited, rng[:, 1], 1e30), dev))


def _any_limited(model: Model, li: np.ndarray) -> bool:
    return bool(np.any(np.asarray(model.jnt_limited)[li] > 0))


def passive_forces_smooth(model: Model, state: PhysicsState) -> torch.Tensor:
    """The joint springs alone, without the limit penalties: the passive
    force where the constraint solver holds the limits (physics/csolve.py)."""
    return passive_forces(model, state, include_limits=False)


def passive_forces(model: Model, state: PhysicsState, include_limits: bool = True
                   ) -> torch.Tensor:
    """Joint springs and limit penalties of the 1-dof joints, ``(B, nv)``:
    ``-k (q - springref)``, and where a joint is past its range ``-k_l
    viol - c_l qd`` (per-dof gains where the model has them)."""
    dev = state.q.device
    tables = tree_tables(model)
    tau = state.qd.new_zeros(state.qd.shape)
    if tables.hinge_slide_q.size == 0:
        return tau
    li, hsv = tables.hinge_slide_link, tables.hinge_slide_v
    qi = state.q[:, const(model, "hs_q", tables.hinge_slide_q, dev, torch.int64)]
    vi = const(model, "hs_v", hsv, dev, torch.int64)
    qdi = state.qd[:, vi]
    f = -const(model, "hs_stiff", np.asarray(model.jnt_stiffness)[li], dev) * (
        qi - const(model, "hs_springref", np.asarray(model.jnt_springref)[li], dev))
    if include_limits and _any_limited(model, li):
        lo, hi = _limit_bounds(model, li, dev)
        if model.dof_limit_stiffness is not None:
            k = const(model, "hs_lim_k", np.asarray(model.dof_limit_stiffness)[hsv], dev)
            c = const(model, "hs_lim_c", np.asarray(model.dof_limit_damping)[hsv], dev)
        else:
            k, c = model.limit_stiffness, model.limit_damping
        viol = torch.clamp(qi - lo, max=0.0) + torch.clamp(qi - hi, min=0.0)
        f = f - k * viol - torch.where(viol.abs() > 0, c * qdi, torch.zeros_like(qdi))
    tau[:, vi] = f
    return tau


def limit_damping_diag(model: Model, q: torch.Tensor) -> torch.Tensor:
    """``(B, nv)`` limit-damping coefficients of the joints past their
    range: added times dt to the solve's diagonal, they make the limit
    damper implicit (``f = -c qd_{t+1}``), stable for any ``c``."""
    dev = q.device
    tables = tree_tables(model)
    li, hsv = tables.hinge_slide_link, tables.hinge_slide_v
    diag = q.new_zeros(q.shape[0], model.nv)
    if tables.hinge_slide_q.size == 0 or not _any_limited(model, li):
        return diag
    qi = q[:, const(model, "hs_q", tables.hinge_slide_q, dev, torch.int64)]
    lo, hi = _limit_bounds(model, li, dev)
    if model.dof_limit_stiffness is not None:
        c = const(model, "hs_lim_c", np.asarray(model.dof_limit_damping)[hsv], dev)
    else:
        c = torch.full((len(hsv),), float(model.limit_damping), device=dev)
    viol = torch.clamp(qi - lo, max=0.0) + torch.clamp(qi - hi, min=0.0)
    diag[:, const(model, "hs_v", hsv, dev, torch.int64)] = torch.where(
        viol.abs() > 0, c, torch.zeros_like(viol))
    return diag


def tendon_forces(model: Model, state: PhysicsState) -> torch.Tensor:
    """Fixed-tendon forces, ``(B, nv)``: springs, dampers and limit
    penalties on the length ``Jq q``, projected back through ``Jv^T``."""
    dev = state.q.device
    if model.tendon_Jq is None:
        return state.qd.new_zeros(state.qd.shape)
    Jv = const(model, "tendon_Jv", model.tendon_Jv, dev)
    length = state.q @ const(model, "tendon_Jq", model.tendon_Jq, dev).T
    vel = state.qd @ Jv.T
    f = (-const(model, "tendon_stiffness", model.tendon_stiffness, dev)
         * (length - const(model, "tendon_springlength", model.tendon_springlength, dev))
         - const(model, "tendon_damping", model.tendon_damping, dev) * vel)
    rng = np.asarray(model.tendon_range)
    lo = const(model, "tendon_lo", rng[:, 0], dev)
    hi = const(model, "tendon_hi", rng[:, 1], dev)
    if model.tendon_limit_stiffness is not None:
        k = const(model, "tendon_lim_k", model.tendon_limit_stiffness, dev)
        c = const(model, "tendon_lim_c", model.tendon_limit_damping, dev)
    else:
        k, c = model.limit_stiffness, model.limit_damping
    viol = torch.clamp(length - lo, max=0.0) + torch.clamp(length - hi, min=0.0)
    f_lim = -k * viol - torch.where(viol.abs() > 0, c * vel, torch.zeros_like(vel))
    f = f + const(model, "tendon_limited", model.tendon_limited, dev) * f_lim
    return f @ Jv


def fluid_forces(model: Model, kin: Kinematics) -> torch.Tensor:
    """MuJoCo's inertia-box fluid model, ``(B, nlink, 6)`` wrenches about
    ``kin.origin``: in each link's principal-inertia frame at its com,
    ``F_i = -3 pi d mu v_i - 2 rho b_j b_k |v_i| v_i`` and ``tau_i = -pi
    d^3 mu w_i - rho b_i (b_j^4 + b_k^4) |w_i| w_i / 2``, ``d = 2
    mean(b)``."""
    dev = kin.pos.device
    rho, mu = model.density, model.viscosity
    if rho == 0.0 and mu == 0.0:
        return kin.pos.new_zeros(kin.pos.shape[0], model.nlink, 6)
    R_wl = m3.quat_to_mat(kin.quat)
    R_wp = R_wl @ m3.quat_to_mat(const(model, "link_iquat", model.link_iquat, dev))
    com_w = kin.pos - kin.origin[:, None] + torch.einsum(
        "blij,lj->bli", R_wl, const(model, "link_com", model.link_com, dev))
    omega_w = kin.cvel[..., :3]
    v_com_w = kin.cvel[..., 3:] + m3.cross(omega_w, com_w)
    w_p = torch.einsum("blji,blj->bli", R_wp, omega_w)
    v_p = torch.einsum("blji,blj->bli", R_wp, v_com_w)
    b = const(model, "link_ibox", model.link_ibox, dev)
    b_j, b_k = b[:, [1, 2, 0]], b[:, [2, 0, 1]]
    d_eq = 2.0 * torch.mean(b, dim=1, keepdim=True)
    force = -3.0 * np.pi * d_eq * mu * v_p - 2.0 * rho * b_j * b_k * v_p.abs() * v_p
    torque = (-np.pi * d_eq ** 3 * mu * w_p
              - 0.5 * rho * b * (b_j ** 4 + b_k ** 4) * w_p.abs() * w_p)
    has_mass = const(model, "link_has_mass", np.asarray(model.link_mass) > 0, dev)[:, None]
    f_w = torch.einsum("blij,blj->bli", R_wp, force) * has_mass
    t_w = torch.einsum("blij,blj->bli", R_wp, torque) * has_mass
    return torch.cat([m3.cross(com_w, f_w) + t_w, f_w], dim=-1)


def friction_terms(model: Model, qd: torch.Tensor):
    """Regularised dry friction per dof (MuJoCo's ``dof_frictionloss``):
    ``(-fl tanh(qd / v_eps), fl / v_eps sech^2)``, the force and its
    velocity Jacobian (times dt on the solve's diagonal, as the dampers),
    or ``(None, None)`` for a model without frictionloss."""
    fl = getattr(model, "dof_frictionloss", None)
    if fl is None or not np.any(np.asarray(fl)):
        return None, None
    fl = const(model, "dof_frictionloss", fl, qd.device)
    v_eps = float(np.float32(model.dof_friction_vel))
    t = torch.tanh(qd / v_eps)
    return -fl * t, (fl / v_eps) * (1.0 - t * t)


def chol_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A x = b`` for a batch of SPD ``A (B, n, n)``, ``b (B, n)``; no
    host sync (``cholesky_ex`` leaves its info on the device)."""
    L = torch.linalg.cholesky_ex(A)[0]
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def forward_dynamics(model: Model, state: PhysicsState, ctrl: torch.Tensor,
                     f_ext_world: Optional[torch.Tensor] = None,
                     kin: Optional[Kinematics] = None, dt: Optional[float] = None
                     ) -> torch.Tensor:
    """``qdd (B, nv)`` under the penalty model: ``(M + diag(armature + dt
    (damping + limit damping + friction slope))) qdd = tau - C - damping
    qd + friction``."""
    dev = state.q.device
    kin = kin if kin is not None else compute_kinematics(model, state.q, state.qd)
    dt = model.dt if dt is None else dt
    M = crba(model, kin)
    C = rnea_bias(model, kin, f_ext_world)
    tau = actuation(model, ctrl, state) + passive_forces(model, state)
    if model.tendon_Jq is not None:
        tau = tau + tendon_forces(model, state)
    damping = const(model, "dof_damping", model.dof_damping, dev)
    rhs = tau - C - damping * state.qd
    diag = const(model, "dof_armature", model.dof_armature, dev) + dt * (
        damping + limit_damping_diag(model, state.q))
    f_fric, d_fric = friction_terms(model, state.qd)
    if f_fric is not None:
        rhs = rhs + f_fric
        diag = diag + dt * d_fric
    return chol_solve(M + torch.diag_embed(diag), rhs)


def integrate(model: Model, state: PhysicsState, qdd: torch.Tensor,
              dt: Optional[float] = None) -> PhysicsState:
    """Semi-implicit Euler: ``qd += dt qdd``, then the 1-dof joints move by
    ``dt qd`` and ball and free joints' quaternions by the exponential map
    of their body-frame angular velocity (a free joint's position by its
    body-frame linear velocity rotated to the world)."""
    dt = model.dt if dt is None else dt
    dev = state.q.device
    tables = tree_tables(model)
    qd = state.qd + dt * qdd
    q = state.q.clone()
    if tables.hinge_slide_q.size:
        qa = const(model, "hs_q", tables.hinge_slide_q, dev, torch.int64)
        q[:, qa] = q[:, qa] + dt * qd[:, const(model, "hs_v", tables.hinge_slide_v, dev,
                                                torch.int64)]
    for i in range(model.nlink):
        t = model.link_jnt_type[i]
        adr, vadr = int(model.link_qadr[i]), int(model.link_vadr[i])
        if t == BALL:
            q[:, adr : adr + 4] = m3.quat_integrate(q[:, adr : adr + 4], qd[:, vadr : vadr + 3], dt)
        elif t == FREE:
            quat = q[:, adr + 3 : adr + 7]
            q[:, adr : adr + 3] = q[:, adr : adr + 3] + dt * m3.quat_rotate(
                quat, qd[:, vadr + 3 : vadr + 6])
            q[:, adr + 3 : adr + 7] = m3.quat_integrate(quat, qd[:, vadr : vadr + 3], dt)
    return PhysicsState(q=q, qd=qd)


def step(model: Model, state: PhysicsState, ctrl: torch.Tensor,
         f_ext_world: Optional[torch.Tensor] = None,
         link_pos_delta: Optional[torch.Tensor] = None) -> PhysicsState:
    """One ``model.dt``: ``model.n_substeps`` substeps of kinematics, the
    penalty contacts (physics/contact.py) and the fluid, then forward
    dynamics, or the Newton soft-constraint solve of contacts and limits
    (physics/csolve.py) with ``constraint_solver="newton"``, then
    :func:`integrate`. ``link_pos_delta (B, nlink, 3)``: per-env link
    offsets in the parent's frame."""
    from mjrl_tpu_torch.physics import csolve
    from mjrl_tpu_torch.physics.contact import contact_forces

    dt = model.dt / model.n_substeps
    newton = model.constraint_solver == "newton"
    for _ in range(model.n_substeps):
        kin = compute_kinematics(model, state.q, state.qd, link_pos_delta)
        f_ext = f_ext_world
        if f_ext is None:
            if model.contact_pairs and not newton:
                f_ext = contact_forces(model, kin)
            if model.density != 0.0 or model.viscosity != 0.0:
                fluid = fluid_forces(model, kin)
                f_ext = fluid if f_ext is None else f_ext + fluid
        if newton:
            qdd = csolve.forward_qacc(model, state, ctrl, f_ext, dt=dt, kin=kin)
        else:
            qdd = forward_dynamics(model, state, ctrl, f_ext, kin=kin, dt=dt)
        state = integrate(model, state, qdd, dt)
    return state
