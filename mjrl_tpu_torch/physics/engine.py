"""Per-env kinematics and actuation, batch-first: the part of the per-env
engine that the observation needs.

Twin of ``forward_kinematics``, ``_build_cdof``, ``compute_kinematics``
and ``actuation`` of ``mjrl_tpu/physics/engine.py``, with the env batch as
the leading dim instead of ``vmap``: ``q (B, nq)``, ``qd (B, nv)``,
``ctrl (B, nu)``. The stepping itself is kernel K1 (physics/pkernel.py);
this module serves what runs outside it, as in the reference: humanoid's
com-based observation (physics/comfeat.py) and contact wrenches
(physics/contact.py), and Adroit's link and site positions.

The loops are vectorised as the reference's are: joint poses batched by
joint type, the tree composed one depth level per step, dof subspaces
batched by type, link velocities one matmul with the ancestor mask, so the
number of ops (each a launch on the card) does not grow with the batch:
humanoid's whole observation (with physics/contact.py and comfeat.py)
issues about 1350, views aside.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from mjrl_tpu_torch.physics import math3d as m3
from mjrl_tpu_torch.physics.model import FREE, HINGE, SLIDE, Model
from mjrl_tpu_torch.physics.tables import tree_tables


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
                       hinge_links=of(HINGE), slide_links=of(SLIDE), free_links=of(FREE))
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
    ident = quat.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(quat.shape[0], 1, 4)
    quat_all = torch.cat([quat, ident], dim=1)
    return pos_all[:, ix] + m3.quat_rotate(quat_all[:, ix], const(model, "site_pos", model.site_pos, dev))


def actuation(model: Model, ctrl: torch.Tensor) -> torch.Tensor:
    """Joint torques of the gear motors, ``(B, nv)``, from ``ctrl`` clipped
    to the ctrl range where limited (humanoid's observation reads them;
    its actuators are gear motors)."""
    dev = ctrl.device
    lo = const(model, "ctrl_lo", np.asarray(model.act_ctrlrange)[:, 0], dev)
    hi = const(model, "ctrl_hi", np.asarray(model.act_ctrlrange)[:, 1], dev)
    limited = const(model, "ctrl_limited", np.asarray(model.act_ctrllimited) > 0, dev) > 0
    c = torch.where(limited, torch.minimum(torch.maximum(ctrl, lo), hi), ctrl)
    P_v = np.zeros((model.nu, model.nv), np.float32)  # one-hot rows: actuator -> dof
    P_v[np.arange(model.nu), np.asarray(model.act_vadr)] = 1.0
    return (const(model, "act_gear", model.act_gear, dev) * c) @ const(model, "act_sel", P_v, dev)
