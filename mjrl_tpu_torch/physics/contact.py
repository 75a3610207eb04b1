"""Penalty contact wrenches of a batch, batched by collider kind.

Twin of ``contact_forces``, ``_collide_kind``, ``_geom_world_batch``
(here ``geom_poses``, every geom at once), ``_point_velocity`` and
``_penalty_forces`` of ``mjrl_tpu/physics/contact.py``, batch-first: each
kind's pairs are one set of ops over ``(B, P, ...)`` tensors, as the
reference's are, not one per contact point. Kernels K1 and K3 compute the
same forces inside their substep (physics/soa.py is their plain version);
this module serves what runs outside them: the per-env engine's penalty step (physics/engine.py)
and its Newton rows (physics/csolve.py), which take every kind, and the
observation: humanoid's ``cfrc_ext`` (physics/comfeat.py) and Adroit
hammer's nail sensor (envs/adroit.py), which asks for one link's wrench:
``contact_forces(..., links=...)`` then collides only the pairs that touch
those links, so their rows come out as the whole model's call gives them.
A plane may sit on a moving link: its pose and velocity are its link's.

Force model, per contact point (depth > 0 only):

    f_n = max(0, k_n * min(depth, cap) - c_n * v_n)   [capped if set]
    f_t = -mu * f_n * v_t / (|v_t| + v_reg)

Kinds (a cylinder collides as a capsule): sphere-, capsule- and box-plane
(a box's 8 corners), sphere-sphere, sphere-capsule, capsule-capsule,
sphere-box, capsule-box (three spheres along the capsule's axis) and
box-box (each box's 8 corners against the other box: two runs of 8 points
per pair, all pairs' first runs before all second runs, the order
physics/csolve.py's rows read).
"""

from __future__ import annotations

import numpy as np
import torch

from mjrl_tpu_torch.physics import math3d as m3
from mjrl_tpu_torch.physics.engine import Kinematics, const
from mjrl_tpu_torch.physics.model import Model
from mjrl_tpu_torch.physics.tables import pair_groups


def geom_poses(model: Model, kin: Kinematics):
    """World poses ``(B, ngeom, 3), (B, ngeom, 4)`` of every geom (a world
    geom takes the identity pose of a padded dump row): one batched set of
    ops that each kind's narrow phase then indexes."""
    dev, B = kin.pos.device, kin.pos.shape[0]
    pos_all = torch.cat([kin.pos, kin.pos.new_zeros(B, 1, 3)], dim=1)
    ident = const(model, "quat_ident", [[1.0, 0.0, 0.0, 0.0]], dev).expand(B, 1, 4)
    quat_all = torch.cat([kin.quat, ident], dim=1)
    links = np.asarray(model.geom_link, np.int64)
    links = const(model, "geom_links", np.where(links < 0, model.nlink, links), dev, torch.int64)
    lq = quat_all[:, links]
    gp = const(model, "geom_pos", model.geom_pos, dev)
    gq = const(model, "geom_quat", model.geom_quat, dev)
    return pos_all[:, links] + m3.quat_rotate(lq, gp), m3.quat_mul(lq, gq)


def _point_velocity(kin: Kinematics, links: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """World velocity of the link-fixed points ``points`` (origin-relative,
    ``(B, P, 3)``) on ``links``, with the world as the dump row ``nlink``,
    which stands still."""
    B = kin.cvel.shape[0]
    cvel = torch.cat([kin.cvel, kin.cvel.new_zeros(B, 1, 6)], dim=1)
    v = cvel[:, links]
    return v[..., 3:] + m3.cross(v[..., :3], points)


def _penalty_forces(model: Model, depth, n, v_rel, mu) -> torch.Tensor:
    """``(B, P)`` contacts -> ``(B, P, 3)`` world force on geom i (the
    reaction on j)."""
    v_n = torch.sum(v_rel * n, dim=-1)
    v_t = v_rel - v_n[..., None] * n
    fn = torch.clamp(model.contact_stiffness * torch.clamp(depth, max=model.contact_depth_cap)
                     - model.contact_damping * v_n, min=0.0)
    fn = torch.where(depth > 0.0, fn, torch.zeros_like(fn))
    if model.contact_force_cap_ratio > 0:
        fn = torch.clamp(fn, max=model.contact_force_cap_ratio * model.contact_stiffness
                         * model.contact_depth_cap)
    vt_norm = torch.linalg.vector_norm(v_t, dim=-1, keepdim=True)
    ft = -mu[:, None] * fn[..., None] * v_t / (vt_norm + model.friction_vel)
    return fn[..., None] * n + ft


def _sphere_sphere(c1, r1, c2, r2):
    d = c1 - c2
    dist = torch.linalg.vector_norm(d, dim=-1) + 1e-12
    nrm = d / dist[..., None]
    depth = (r1 + r2) - dist
    pts = c2 + nrm * (r2 - 0.5 * torch.clamp(depth, min=0.0))[..., None]
    return depth, nrm, pts


def _one_hot3(ax: torch.Tensor) -> torch.Tensor:
    """``(..., 1)`` axis indices -> ``(..., 3)`` f32 one-hot rows, without
    the host sync of ``one_hot``'s range check."""
    return (ax == torch.arange(3, device=ax.device)).float()


def _sphere_box(c, r, pb, qb, sb):
    """Sphere centres ``c (B, P, 3)`` with radii ``r (P,)`` against boxes at
    ``pb (B, P, 3)``, ``qb (B, P, 4)`` with half-sizes ``sb (P, 3)``:
    depth, world normal from the box, world point (on the box). A centre
    inside its box leaves through the nearest face."""
    R = m3.quat_to_mat(qb)  # box -> world
    p = torch.einsum("bpji,bpj->bpi", R, c - pb)  # the centre in the box's frame
    clamped = torch.minimum(torch.maximum(p, -sb), sb)
    delta = p - clamped
    d_out = torch.linalg.vector_norm(delta, dim=-1)
    inside = d_out < 1e-9
    n_out = delta / (d_out[..., None] + 1e-12)
    gap = sb - p.abs()  # per-face distance when inside
    ax = torch.argmin(gap, dim=-1, keepdim=True)
    sgn = torch.where(torch.gather(p, -1, ax) >= 0, 1.0, -1.0)
    n_in = _one_hot3(ax) * sgn
    depth_in = r + torch.gather(gap, -1, ax)[..., 0]
    nrm_b = torch.where(inside[..., None], n_in, n_out)
    depth = torch.where(inside, depth_in, r - d_out)
    nrm_w = torch.einsum("bpij,bpj->bpi", R, nrm_b)
    return depth, nrm_w, pb + torch.einsum("bpij,bpj->bpi", R, clamped)


_BOX_CORNERS = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                        np.float32)  # (8, 3)


def _box_corners_in_box(model: Model, pa, qa, sa, pb, qb, sb):
    """The corners of boxes a (``pa (B, P, 3)``, ``qa (B, P, 4)``,
    half-sizes ``sa (P, 3)``) against boxes b: depth ``(B, P, 8)``, > 0
    only where a corner lies inside b, by its nearest face; the world
    normal of that face ``(B, P, 8, 3)``; the corners ``(B, P, 8, 3)``."""
    corners = const(model, "box_corners", _BOX_CORNERS, pa.device)
    Ra, Rb = m3.quat_to_mat(qa), m3.quat_to_mat(qb)
    cw = pa[:, :, None, :] + torch.einsum("bpij,pkj->bpki", Ra, corners[None] * sa[:, None, :])
    p = torch.einsum("bpji,bpkj->bpki", Rb, cw - pb[:, :, None, :])  # in b's frame
    gap = sb[:, None, :] - p.abs()
    ax = torch.argmin(gap, dim=-1, keepdim=True)
    sgn = torch.where(torch.gather(p, -1, ax) >= 0, 1.0, -1.0)
    n_b = _one_hot3(ax) * sgn
    return gap.amin(dim=-1), torch.einsum("bpij,bpkj->bpki", Rb, n_b), cw


def _collide_kind(model: Model, kin: Kinematics, kind: str, tab, tag: str = "", poses=None):
    """One kind's narrow phase: per contact point ``depth (B, P)``,
    ``normal (B, P, 3)`` from j to i, world ``points (B, P, 3)``, and the
    links ``li, lj`` (numpy, -1 for the world) and frictions ``mu`` of each
    point. ``tag`` names ``tab``'s device constants when it is a subset of
    the kind's pairs; ``poses``: ``geom_poses(model, kin)``, if the caller
    has them."""
    dev = kin.pos.device
    gi, gj, li, lj = tab["gi"], tab["gj"], tab["li"], tab["lj"]
    tag = kind + tag
    mu = const(model, f"mu_{tag}", tab["mu"], dev)
    gpos, gquat = geom_poses(model, kin) if poses is None else poses
    gi_t = const(model, f"gi_{tag}", gi, dev, torch.int64)
    gj_t = const(model, f"gj_{tag}", gj, dev, torch.int64)
    pi, qi = gpos[:, gi_t], gquat[:, gi_t]
    pj, qj = gpos[:, gj_t], gquat[:, gj_t]
    si = const(model, f"size_{tag}_i", np.asarray(model.geom_size)[gi], dev)
    sj = const(model, f"size_{tag}_j", np.asarray(model.geom_size)[gj], dev)
    z = const(model, "z_axis", [0.0, 0.0, 1.0], dev)

    if kind == "sphere_plane":
        nrm = m3.quat_rotate(qj, z)
        dist = torch.sum((pi - pj) * nrm, dim=-1) - si[:, 0]
        return -dist, nrm, pi - nrm * si[:, 0:1], li, lj, mu
    if kind == "capsule_plane":
        axis = m3.quat_rotate(qi, z)
        ends = torch.stack([pi - si[:, 1:2] * axis, pi + si[:, 1:2] * axis], dim=2)  # (B, P, 2, 3)
        nrm = m3.quat_rotate(qj, z)[:, :, None, :]
        dist = torch.sum((ends - pj[:, :, None, :]) * nrm, dim=-1) - si[:, 0:1]
        pts = ends - nrm * si[:, 0:1, None]
        B, P = ends.shape[:2]
        return ((-dist).reshape(B, 2 * P), nrm.expand(B, P, 2, 3).reshape(B, 2 * P, 3),
                pts.reshape(B, 2 * P, 3), np.repeat(li, 2), np.repeat(lj, 2),
                torch.repeat_interleave(mu, 2))
    if kind == "box_plane":
        corners = const(model, "box_corners", _BOX_CORNERS, dev)
        pts = pi[:, :, None, :] + m3.quat_rotate(qi[:, :, None, :],
                                                 corners[None] * si[:, None, :3])  # (B, P, 8, 3)
        nrm = m3.quat_rotate(qj, z)[:, :, None, :]
        dist = torch.sum((pts - pj[:, :, None, :]) * nrm, dim=-1)
        B, P = pts.shape[:2]
        return ((-dist).reshape(B, 8 * P), nrm.expand(B, P, 8, 3).reshape(B, 8 * P, 3),
                pts.reshape(B, 8 * P, 3), np.repeat(li, 8), np.repeat(lj, 8),
                torch.repeat_interleave(mu, 8))
    if kind == "box_box":
        d1, n1, p1 = _box_corners_in_box(model, pi, qi, si, pj, qj, sj)
        d2, n2, p2 = _box_corners_in_box(model, pj, qj, sj, pi, qi, si)
        B, P = pi.shape[:2]
        two = lambda x: np.concatenate([np.repeat(x, 8), np.repeat(x, 8)])  # noqa: E731
        return (torch.cat([d1.reshape(B, 8 * P), d2.reshape(B, 8 * P)], dim=1),
                torch.cat([n1.reshape(B, 8 * P, 3), -n2.reshape(B, 8 * P, 3)], dim=1),
                torch.cat([p1.reshape(B, 8 * P, 3), p2.reshape(B, 8 * P, 3)], dim=1),
                two(li), two(lj), torch.repeat_interleave(mu, 8).repeat(2))
    if kind == "sphere_sphere":
        return (*_sphere_sphere(pi, si[:, 0], pj, sj[:, 0]), li, lj, mu)
    if kind == "sphere_capsule":  # geom i the sphere, geom j the capsule
        axis = m3.quat_rotate(qj, z)
        a = pj - sj[:, 1:2] * axis
        d = 2.0 * sj[:, 1:2] * axis
        t = torch.clamp(torch.sum((pi - a) * d, dim=-1) / (torch.sum(d * d, dim=-1) + 1e-12),
                        0.0, 1.0)
        return (*_sphere_sphere(pi, si[:, 0], a + t[..., None] * d, sj[:, 0]), li, lj, mu)
    if kind == "capsule_capsule":
        ax_i, ax_j = m3.quat_rotate(qi, z), m3.quat_rotate(qj, z)
        p1 = pi - si[:, 1:2] * ax_i
        d1 = 2.0 * si[:, 1:2] * ax_i
        p2 = pj - sj[:, 1:2] * ax_j
        d2 = 2.0 * sj[:, 1:2] * ax_j
        r = p1 - p2
        a = torch.sum(d1 * d1, -1) + 1e-12
        e = torch.sum(d2 * d2, -1) + 1e-12
        b = torch.sum(d1 * d2, -1)
        c = torch.sum(d1 * r, -1)
        f = torch.sum(d2 * r, -1)
        denom = a * e - b * b
        s = torch.where(denom.abs() > 1e-9, (b * f - c * e) / (denom + 1e-12),
                        torch.zeros_like(denom))
        s = torch.clamp(s, 0.0, 1.0)
        t = torch.clamp((b * s + f) / e, 0.0, 1.0)
        s = torch.clamp((b * t - c) / a, 0.0, 1.0)
        return (*_sphere_sphere(p1 + s[..., None] * d1, si[:, 0], p2 + t[..., None] * d2,
                                sj[:, 0]), li, lj, mu)
    if kind == "sphere_box":
        return (*_sphere_box(pi, si[:, 0], pj, qj, sj), li, lj, mu)
    if kind == "capsule_box":
        # three spheres along the capsule's axis, each against the box
        axis = m3.quat_rotate(qi, z)
        ts = const(model, "capsule_box_ts", [-1.0, 0.0, 1.0], dev)
        B, P = pi.shape[:2]
        centres = pi[:, :, None, :] + ts[None, None, :, None] * si[None, :, 1:2, None] * axis[
            :, :, None, :]  # (B, P, 3 spheres, 3)
        three = lambda x: x[:, :, None].expand(B, P, 3, x.shape[-1]).reshape(B, 3 * P, -1)  # noqa: E731
        return (*_sphere_box(centres.reshape(B, 3 * P, 3), torch.repeat_interleave(si[:, 0], 3),
                             three(pj), three(qj), torch.repeat_interleave(sj, 3, dim=0)),
                np.repeat(li, 3), np.repeat(lj, 3), torch.repeat_interleave(mu, 3))
    raise ValueError(kind)


def _pairs_touching(model: Model, links: tuple):
    """``pair_groups(model)``'s kinds cut to the pairs with a geom on one
    of ``links`` (kinds left with none dropped), cached on the model."""
    cache = model.__dict__.setdefault("_pairs_touching", {})
    if links not in cache:
        kinds = []
        for kind, tab in pair_groups(model).kinds:
            keep = np.isin(tab["li"], links) | np.isin(tab["lj"], links)
            if keep.any():
                kinds.append((kind, {k: v[keep] for k, v in tab.items()}))
        cache[links] = tuple(kinds)
    return cache[links]


def contact_forces(model: Model, kin: Kinematics, links=None) -> torch.Tensor:
    """``(B, nlink, 6)`` world wrenches about ``kin.origin``. With
    ``links`` (link indices), only the pairs that touch one of them are
    collided: the rows of ``links`` are the whole model's, the other rows
    hold only those pairs' share."""
    B = kin.pos.shape[0]
    f_ext = kin.pos.new_zeros(B, model.nlink + 1, 6)  # + a dump row for world geoms
    if links is None:
        kinds, tag = pair_groups(model).kinds, ""
    else:
        links = tuple(sorted(int(i) for i in links))
        kinds, tag = _pairs_touching(model, links), f"@{links}"
    poses = geom_poses(model, kin)
    for kind, tab in kinds:
        depth, n, pts, li, lj, mu = _collide_kind(model, kin, kind, tab, tag, poses)
        dev = pts.device
        li = const(model, f"li_{kind}{tag}", np.where(li < 0, model.nlink, li), dev, torch.int64)
        lj = const(model, f"lj_{kind}{tag}", np.where(lj < 0, model.nlink, lj), dev, torch.int64)
        pts_rel = pts - kin.origin[:, None]
        v_rel = _point_velocity(kin, li, pts_rel) - _point_velocity(kin, lj, pts_rel)
        f = _penalty_forces(model, depth, n, v_rel, mu)
        wrench = torch.cat([m3.cross(pts_rel, f), f], dim=-1)
        f_ext.index_add_(1, li, wrench)
        f_ext.index_add_(1, lj, -wrench)
    return f_ext[:, : model.nlink]
