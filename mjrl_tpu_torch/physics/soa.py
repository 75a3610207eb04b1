"""Plain PyTorch batch-last physics substep: the reference for kernels K1,
K2 and K3.

Twin of ``mjrl_tpu/physics/soa.py``: every per-env
scalar is a ``(1, B)`` row and every 3-vector a ``(3, B)`` tensor, and all
loops (tree walks, dof chains, contact pairs) unroll in Python over the
static tables of physics/tables.py, in the reference's order. The pipeline
per substep is kinematics -> cdof/cvel -> contacts -> composite inertias ->
sparse mass matrix -> RNE bias -> applied forces (with tendons and
frictionloss) -> sparse L^T D L solve ->
semi-implicit Euler, with fluid drag added to the link wrenches before the
bias. With the penalty solver the contacts are spring-damper wrenches and
the limits penalty springs; with the Newton solver both become
soft-constraint rows solved after the L^T D L step (physics/soa_newton.py).

This is the kernels' plain version: physics/pkernel.py runs it for tensors
on the CPU, and the tests and ``chip_smoke.py`` hold the CUDA kernels
against it. It issues thousands of tiny ops per substep, so on a card it is
launch-bound and only fit for comparisons.

Feature set (``check_supported``): free, hinge, slide and fixed links;
sphere-, capsule- and box-plane contacts against world planes and
sphere-sphere, sphere-capsule, capsule-capsule, sphere-box, capsule-box and
box-box contacts between geoms; the inertia-box fluid model (density,
viscosity); ctrl-limited gear motors and affine gain/bias servos; joint
springs; per-dof limit penalties; per-dof frictionloss (a tanh-regularised
force with its implicit diagonal); fixed tendons (springs, dampers and limit
penalties on ``Jq q``); per-env parent-frame link offsets (``link_delta``);
the penalty solver and the Newton solver.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mjrl_tpu_torch.physics.model import BALL, FREE, HINGE, JOINT_NV, SLIDE, Model
from mjrl_tpu_torch.physics.tables import (
    SoATables,
    pair_groups,
    plane_normal_point,
    soa_tables,
)

SUPPORTED_KINDS = ("sphere_plane", "capsule_plane", "box_plane", "sphere_sphere",
                   "sphere_capsule", "capsule_capsule", "sphere_box", "capsule_box", "box_box")
_PLANE_KINDS = ("sphere_plane", "capsule_plane", "box_plane")
# the box kinds: only the EXT builds (kernels K3 and K4) have them
_BOX_KINDS = ("box_plane", "sphere_box", "capsule_box", "box_box")


def has_frictionloss(model: Model) -> bool:
    fl = model.dof_frictionloss
    return fl is not None and bool(np.any(np.asarray(fl)))


def needs_ext(model: Model) -> bool:
    """True if the model uses a stage that only kernel K3's and K4's builds
    have: fixed tendons, frictionloss, gain/bias actuators or a box contact
    kind."""
    return (model.tendon_Jq is not None or has_frictionloss(model)
            or model.act_gainprm is not None
            or any(kind in _BOX_KINDS for kind, _ in pair_groups(model).kinds))


def _unsupported(model: Model) -> Optional[str]:
    """Why ``model`` is outside the kernels' feature set, or None."""
    for i in range(model.nlink):
        if model.link_jnt_type[i] not in (-1, FREE, HINGE, SLIDE):
            return f"link {i}: joint type {model.link_jnt_type[i]} is not ported"
    if model.constraint_solver not in ("penalty", "newton"):
        return f"solver {model.constraint_solver!r} is not ported"
    for kind, tab in pair_groups(model).kinds:
        if kind not in SUPPORTED_KINDS:
            return f"contact kind {kind!r} is not ported"
        if kind in _PLANE_KINDS and any(model.geom_link[int(g)] >= 0 for g in tab["gj"]):
            return "planes must be world geoms"
    return None


def soa_supported(model: Model) -> bool:
    """True if the kernels (and this plain version) step ``model``; a
    model with a ball joint or a plane on a moving link runs on the
    per-env engine instead (physics/dispatch.py)."""
    return _unsupported(model) is None


def check_supported(model: Model) -> None:
    """Raise ``NotImplementedError`` for a model outside the kernels'
    feature set, ``ValueError`` for limits without their gains."""
    reason = _unsupported(model)
    if reason is not None:
        raise NotImplementedError(reason)
    if model.dof_limit_stiffness is None and np.any(model.jnt_limited > 0):
        raise ValueError("limited joints need per-dof limit gains")
    if (model.tendon_Jq is not None and model.tendon_limit_stiffness is None
            and model.tendon_limited is not None and np.any(np.asarray(model.tendon_limited) > 0)):
        raise ValueError("limited tendons need per-tendon limit gains")


# ---------------------------------------------------------------------------
# Row algebra: vectors are (3, B), quats (4, B), spatial vectors (6, B);
# static model constants are (k, 1) columns and broadcast over the batch.
# ---------------------------------------------------------------------------


def _c(model: Model, x, device: torch.device) -> torch.Tensor:
    """Static constant column ``(k, 1)`` f32 on ``device``, memoized on the
    model so a step on a card does not copy it from the host each time."""
    v = np.ascontiguousarray(np.asarray(x, np.float32).reshape(-1, 1))
    cache = model.__dict__.setdefault("_torch_consts", {})
    key = (v.tobytes(), v.shape[0], str(device))
    t = cache.get(key)
    if t is None:
        t = torch.from_numpy(v).to(device)
        cache[key] = t
    return t


def _cross(a, b):
    return torch.cat(
        [
            a[1:2] * b[2:3] - a[2:3] * b[1:2],
            a[2:3] * b[0:1] - a[0:1] * b[2:3],
            a[0:1] * b[1:2] - a[1:2] * b[0:1],
        ],
        dim=0,
    )


def _dot(a, b):
    return torch.sum(a * b, dim=0, keepdim=True)


def _qmul(a, b):
    aw, ax, ay, az = a[0:1], a[1:2], a[2:3], a[3:4]
    bw, bx, by, bz = b[0:1], b[1:2], b[2:3], b[3:4]
    return torch.cat(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=0,
    )


def _qrot(q, v):
    """Rotate (3, B) vector by (4, B) quaternion."""
    w, qv = q[0:1], q[1:4]
    t = 2.0 * _cross(qv, v)
    return v + w * t + _cross(qv, t)


def _qnorm(q, eps=1e-12):
    return q * torch.rsqrt(torch.sum(q * q, dim=0, keepdim=True) + eps)


def _spatial_cross_motion(v, m):
    """crm: motion x motion."""
    w, lin = v[0:3], v[3:6]
    w2, l2 = m[0:3], m[3:6]
    return torch.cat([_cross(w, w2), _cross(w, l2) + _cross(lin, w2)], dim=0)


def _spatial_cross_force(v, f):
    """crf: motion x force."""
    w, lin = v[0:3], v[3:6]
    n, fl = f[0:3], f[3:6]
    return torch.cat([_cross(w, n) + _cross(lin, fl), _cross(w, fl)], dim=0)


# ---------------------------------------------------------------------------
# Pipeline stages: python lists of (rows, B) tensors keep the tree explicit.
# ---------------------------------------------------------------------------


def _fk(model: Model, q: torch.Tensor, link_delta: Optional[torch.Tensor] = None):
    """World link poses: (pos list (3, B), quat list (4, B)). ``link_delta``
    (``(3 nlink, B)``): per-env offsets of each link's position in its
    parent's frame (the randomised scenes of Adroit)."""
    dev = q.device
    pos: List[torch.Tensor] = [None] * model.nlink
    quat: List[torch.Tensor] = [None] * model.nlink
    for i in range(model.nlink):
        t = model.link_jnt_type[i]
        adr = model.link_qadr[i]
        lp, lq = _c(model, model.link_pos[i], dev), _c(model, model.link_quat[i], dev)
        if link_delta is not None:
            lp = lp + link_delta[3 * i : 3 * i + 3]
        jp = jq = None
        if t == HINGE:
            ax = _c(model, model.jnt_axis[i], dev)
            an = _c(model, model.jnt_anchor[i], dev)
            half = 0.5 * (q[adr : adr + 1] - float(model.jnt_ref[i]))
            s = torch.sin(half)
            jq = torch.cat([torch.cos(half), ax[0:1] * s, ax[1:2] * s, ax[2:3] * s], dim=0)
            jp = an - _qrot(jq, an)
        elif t == SLIDE:
            jp = _c(model, model.jnt_axis[i], dev) * (q[adr : adr + 1] - float(model.jnt_ref[i]))
        elif t == FREE:
            jp = q[adr : adr + 3]
            jq = _qnorm(q[adr + 3 : adr + 7])
        rel_p = lp if jp is None else lp + _qrot(lq, jp)
        rel_q = lq if jq is None else _qmul(lq, jq)
        p = model.link_parent[i]
        if p < 0:
            pos[i], quat[i] = rel_p, rel_q
        else:
            pos[i] = pos[p] + _qrot(quat[p], rel_p)
            quat[i] = _qmul(quat[p], rel_q)
    return pos, quat


_EYE3 = np.eye(3, dtype=np.float32)


def _cdofs(model: Model, pos, quat, origin):
    """Per-dof world motion subspaces about ``origin``: list of (6, B)."""
    dev = origin.device
    cdof: List[torch.Tensor] = [None] * model.nv
    for i in range(model.nlink):
        t = model.link_jnt_type[i]
        v = model.link_vadr[i]
        if t == HINGE:
            axis_w = _qrot(quat[i], _c(model, model.jnt_axis[i], dev))
            anchor_w = pos[i] - origin + _qrot(quat[i], _c(model, model.jnt_anchor[i], dev))
            cdof[v] = torch.cat([axis_w, _cross(anchor_w, axis_w)], dim=0)
        elif t == SLIDE:
            axis_w = _qrot(quat[i], _c(model, model.jnt_axis[i], dev))
            cdof[v] = torch.cat([torch.zeros_like(axis_w), axis_w], dim=0)
        elif t == FREE:
            p_rel = pos[i] - origin
            for k in range(3):
                e = _qrot(quat[i], _c(model, _EYE3[k], dev))
                cdof[v + k] = torch.cat([e, _cross(p_rel, e)], dim=0)
                cdof[v + 3 + k] = torch.cat([torch.zeros_like(e), e], dim=0)
    return cdof


def _cvels(model: Model, cdof, qd):
    """Per-link world spatial velocities: list of (6, B)."""
    cvel: List[torch.Tensor] = [None] * model.nlink
    for i in range(model.nlink):
        p = model.link_parent[i]
        acc = None if p < 0 else cvel[p]
        v = model.link_vadr[i]
        for k in range(JOINT_NV.get(model.link_jnt_type[i], 0)):
            term = cdof[v + k] * qd[v + k : v + k + 1]
            acc = term if acc is None else acc + term
        cvel[i] = qd.new_zeros((6, qd.shape[1])) if acc is None else acc
    return cvel


class _Inertia:
    """World spatial inertia of one link about the reference origin:
    static mass, h = m*com (3, B), I = 3x3 nested rows (1, B) about origin."""

    __slots__ = ("mass", "h", "I")

    def __init__(self, mass, h, I):
        self.mass, self.h, self.I = mass, h, I


def _world_inertias(model: Model, tab: SoATables, pos, quat, origin):
    dev = origin.device
    out: List[_Inertia] = []
    for i in range(model.nlink):
        m = float(model.link_mass[i])
        d, Q = tab.inertia_eig[i]
        com_w = pos[i] - origin + _qrot(quat[i], _c(model, model.link_com[i], dev))
        cols = [
            _qrot(quat[i], _c(model, Q[:, k], dev)) if d[k] != 0.0 else None
            for k in range(3)
        ]
        cc = _dot(com_w, com_w)
        I = [[None] * 3 for _ in range(3)]
        for a in range(3):
            for b in range(a, 3):
                val = None
                for k in range(3):
                    if cols[k] is None:
                        continue
                    term = float(d[k]) * cols[k][a : a + 1] * cols[k][b : b + 1]
                    val = term if val is None else val + term
                if m != 0.0:
                    diag = cc if a == b else 0.0
                    mterm = m * (diag - com_w[a : a + 1] * com_w[b : b + 1])
                    val = mterm if val is None else val + mterm
                if val is None:
                    val = com_w.new_zeros((1, com_w.shape[1]))
                I[a][b] = I[b][a] = val
        out.append(_Inertia(m, m * com_w, I))
    return out


def _inertia_mul(inr: _Inertia, v):
    """Spatial inertia times motion vector -> force vector (6, B)."""
    w, lin = v[0:3], v[3:6]
    n = torch.cat(
        [inr.I[a][0] * w[0:1] + inr.I[a][1] * w[1:2] + inr.I[a][2] * w[2:3] for a in range(3)],
        dim=0,
    ) + _cross(inr.h, lin)
    f = inr.mass * lin - _cross(inr.h, w)
    return torch.cat([n, f], dim=0)


def _composite_inertias(model: Model, tab: SoATables, inert):
    """CRB composites via reverse tree accumulation."""
    c_h = [inr.h for inr in inert]
    c_I = [[row[:] for row in inr.I] for inr in inert]
    for i in reversed(range(model.nlink)):
        p = model.link_parent[i]
        if p < 0:
            continue
        c_h[p] = c_h[p] + c_h[i]
        for a in range(3):
            for b in range(a, 3):
                c_I[p][a][b] = c_I[p][a][b] + c_I[i][a][b]
                c_I[p][b][a] = c_I[p][a][b]
    return [_Inertia(float(tab.c_mass[i]), c_h[i], c_I[i]) for i in range(model.nlink)]


def _mass_matrix_sparse(model: Model, tab: SoATables, cdof, crb):
    """Tree-sparse mass matrix entries M[i][j] (j in anc(i)) as (1, B) rows."""
    F = [_inertia_mul(crb[tab.dof_link[j]], cdof[j]) for j in range(model.nv)]
    M: Dict[Tuple[int, int], torch.Tensor] = {}
    for i in range(model.nv):
        for j in tab.anc[i]:
            M[(i, j)] = _dot(F[i], cdof[j])
    return M


def _bias_forces(model: Model, tab: SoATables, cdof, cvel, inert, qd, f_ext):
    """RNE bias C(q, qd) including gravity and external wrenches: (nv, B)."""
    g = model.gravity
    a0 = _c(model, [0.0, 0.0, 0.0, -g[0], -g[1], -g[2]], qd.device)
    cacc: List[torch.Tensor] = [None] * model.nlink
    for i in range(model.nlink):
        p = model.link_parent[i]
        acc = a0 if p < 0 else cacc[p]
        v = model.link_vadr[i]
        for k in range(JOINT_NV.get(model.link_jnt_type[i], 0)):
            acc = acc + _spatial_cross_motion(cvel[i], cdof[v + k]) * qd[v + k : v + k + 1]
        cacc[i] = acc
    f_acc: List[torch.Tensor] = [None] * model.nlink
    for i in range(model.nlink):
        Iv = _inertia_mul(inert[i], cvel[i])
        f = _inertia_mul(inert[i], cacc[i]) + _spatial_cross_force(cvel[i], Iv)
        if f_ext is not None and f_ext.get(i) is not None:
            f = f - f_ext[i]
        f_acc[i] = f
    for i in reversed(range(model.nlink)):
        p = model.link_parent[i]
        if p >= 0:
            f_acc[p] = f_acc[p] + f_acc[i]
    return torch.cat([_dot(f_acc[tab.dof_link[j]], cdof[j]) for j in range(model.nv)], dim=0)


def _ltdl_solve(model: Model, tab: SoATables, M, rhs, dt: float, extra_diag=None):
    """Solve (M + diag(armature + dt*damping [+ extra])) x = rhs by the
    branch-induced-sparsity L^T D L factorization (Featherstone RBDA 6.5),
    with the ancestor-chain loops in the reference's order."""
    nv = model.nv
    lam = tab.lam
    H = dict(M)
    extra = np.asarray(model.dof_armature, np.float32) + np.float32(dt) * np.asarray(
        model.dof_damping, np.float32
    )
    for k in range(nv):
        if extra[k] != 0.0:
            H[(k, k)] = H[(k, k)] + float(extra[k])
        if extra_diag is not None and extra_diag[k] is not None:
            H[(k, k)] = H[(k, k)] + extra_diag[k]
    L: Dict[Tuple[int, int], torch.Tensor] = {}
    D = [None] * nv
    for k in reversed(range(nv)):
        inv_d = 1.0 / H[(k, k)]
        i = lam[k]
        while i >= 0:
            a = H[(k, i)] * inv_d
            j = i
            while j >= 0:
                H[(i, j)] = H[(i, j)] - a * H[(k, j)]
                j = lam[j]
            L[(k, i)] = a
            i = lam[i]
        D[k] = H[(k, k)]
    x = [rhs[j : j + 1] for j in range(nv)]
    for i in reversed(range(nv)):
        j = lam[i]
        while j >= 0:
            x[j] = x[j] - L[(i, j)] * x[i]
            j = lam[j]
    for i in range(nv):
        x[i] = x[i] / D[i]
    for i in range(nv):
        j = lam[i]
        while j >= 0:
            x[i] = x[i] - L[(i, j)] * x[j]
            j = lam[j]
    return torch.cat(x, dim=0)


# ---------------------------------------------------------------------------
# Contacts (penalty model).
# ---------------------------------------------------------------------------


class _Cand:
    __slots__ = ("gi", "gj", "li", "lj", "mu", "depth", "n", "pt")

    def __init__(self, gi, gj, li, lj, mu, depth, n, pt):
        self.gi, self.gj, self.li, self.lj, self.mu = gi, gj, li, lj, mu
        self.depth, self.n, self.pt = depth, n, pt


def _contact_candidates(model: Model, pos, quat) -> List[_Cand]:
    """Narrow phase: one candidate per contact point, in the reference's
    kind / pair / sub-point order."""
    dev = pos[0].device
    out: List[_Cand] = []
    pose_cache: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    def geom_pose(g: int):
        if g not in pose_cache:
            l = model.geom_link[g]
            gp, gq = _c(model, model.geom_pos[g], dev), _c(model, model.geom_quat[g], dev)
            if l < 0:
                pose_cache[g] = (gp, gq)
            else:
                pose_cache[g] = (pos[l] + _qrot(quat[l], gp), _qmul(quat[l], gq))
        return pose_cache[g]

    def sphere_sphere(c1, r1, c2, r2):
        d = c1 - c2
        dist = torch.sqrt(_dot(d, d)) + 1e-12
        n = d / dist
        depth = float(np.float32(r1) + np.float32(r2)) - dist
        pt = c2 + n * (float(r2) - 0.5 * torch.clamp(depth, min=0.0))
        return depth, n, pt

    def min_axis_onehot(gap):
        # one-hot of the smallest of the three rows, the first on a tie
        g0, g1, g2 = gap[0:1], gap[1:2], gap[2:3]
        o0 = ((g0 <= g1) & (g0 <= g2)).to(gap.dtype)
        o1 = (1.0 - o0) * (g1 <= g2).to(gap.dtype)
        return torch.cat([o0, o1, 1.0 - o0 - o1], dim=0)

    def sphere_box(c, r, pb, qb, sb):
        """Sphere centre ``c`` (radius ``r``) against the box at ``pb``,
        ``qb`` with half-sizes ``sb``: depth, normal from the box, point."""
        sbc = _c(model, sb, dev)
        p = _qrot_inv(qb, c - pb)
        clamped = torch.minimum(torch.maximum(p, -sbc), sbc)
        delta = p - clamped
        d_out = torch.sqrt(_dot(delta, delta))
        inside = d_out < 1e-9
        n_out = delta / (d_out + 1e-12)
        gap = sbc - p.abs()
        gmin = torch.amin(gap, dim=0, keepdim=True)
        n_in = min_axis_onehot(gap) * torch.where(p >= 0, 1.0, -1.0)
        depth = torch.where(inside, float(r) + gmin, float(r) - d_out)
        return depth, _qrot(qb, torch.where(inside, n_in, n_out)), pb + _qrot(qb, clamped)

    def box_corners_in_box(pa, qa, sa, pb, qb, sb):
        """The 8 corners of box a against box b: depth, normal from b,
        the corner."""
        sbc = _c(model, sb, dev)
        for sx in (-1.0, 1.0):
            for sy in (-1.0, 1.0):
                for sz in (-1.0, 1.0):
                    corner = pa + _qrot(qa, _c(model, [sx * sa[0], sy * sa[1], sz * sa[2]], dev))
                    p = _qrot_inv(qb, corner - pb)
                    gap = sbc - p.abs()
                    n = _qrot(qb, min_axis_onehot(gap) * torch.where(p >= 0, 1.0, -1.0))
                    yield torch.amin(gap, dim=0, keepdim=True), n, corner

    Z = _c(model, [0.0, 0.0, 1.0], dev)
    for kind, tab in pair_groups(model).kinds:
        for p_i in range(len(tab["gi"])):
            gi, gj = int(tab["gi"][p_i]), int(tab["gj"][p_i])
            li, lj = int(tab["li"][p_i]), int(tab["lj"][p_i])
            mu = float(tab["mu"][p_i])
            si = np.asarray(model.geom_size[gi], np.float32)
            sj = np.asarray(model.geom_size[gj], np.float32)
            r = float(si[0])
            pi_, qi_ = geom_pose(gi)
            if kind in _PLANE_KINDS:
                nrm_np, pp_np = plane_normal_point(model, gj)
                nrm, pp = _c(model, nrm_np, dev), _c(model, pp_np, dev)
            if kind == "sphere_plane":
                dist = _dot(pi_ - pp, nrm) - r
                out.append(_Cand(gi, gj, li, lj, mu, -dist, nrm, pi_ - nrm * r))
            elif kind == "capsule_plane":
                axis = _qrot(qi_, Z)
                for sgn in (-1.0, 1.0):
                    end = pi_ + float(np.float32(sgn * si[1])) * axis
                    dist = _dot(end - pp, nrm) - r
                    out.append(_Cand(gi, gj, li, lj, mu, -dist, nrm, end - nrm * r))
            elif kind == "box_plane":
                for sx in (-1.0, 1.0):
                    for sy in (-1.0, 1.0):
                        for sz in (-1.0, 1.0):
                            corner = pi_ + _qrot(
                                qi_, _c(model, [sx * si[0], sy * si[1], sz * si[2]], dev))
                            out.append(_Cand(gi, gj, li, lj, mu, -_dot(corner - pp, nrm), nrm,
                                             corner))
            elif kind == "sphere_box":
                pj_, qj_ = geom_pose(gj)
                dep, n, pt = sphere_box(pi_, si[0], pj_, qj_, sj)
                out.append(_Cand(gi, gj, li, lj, mu, dep, n, pt))
            elif kind == "capsule_box":
                # three spheres along the axis against the box
                pj_, qj_ = geom_pose(gj)
                axis = _qrot(qi_, Z)
                for t in (-1.0, 0.0, 1.0):
                    centre = pi_ + float(np.float32(t * si[1])) * axis
                    dep, n, pt = sphere_box(centre, si[0], pj_, qj_, sj)
                    out.append(_Cand(gi, gj, li, lj, mu, dep, n, pt))
            elif kind == "box_box":
                # the corners of each box against the other, 16 points
                pj_, qj_ = geom_pose(gj)
                for dep, n, pt in box_corners_in_box(pi_, qi_, si, pj_, qj_, sj):
                    out.append(_Cand(gi, gj, li, lj, mu, dep, n, pt))
                for dep, n, pt in box_corners_in_box(pj_, qj_, sj, pi_, qi_, si):
                    out.append(_Cand(gi, gj, li, lj, mu, dep, -n, pt))
            elif kind == "capsule_capsule":
                # closest points of the two segments, then a sphere pair
                pj_, qj_ = geom_pose(gj)
                ax_i, ax_j = _qrot(qi_, Z), _qrot(qj_, Z)
                p1 = pi_ - float(si[1]) * ax_i
                d1 = float(2.0 * si[1]) * ax_i
                p2 = pj_ - float(sj[1]) * ax_j
                d2 = float(2.0 * sj[1]) * ax_j
                rr = p1 - p2
                a = _dot(d1, d1) + 1e-12
                e = _dot(d2, d2) + 1e-12
                b, c, f = _dot(d1, d2), _dot(d1, rr), _dot(d2, rr)
                denom = a * e - b * b
                s = torch.where(denom.abs() > 1e-9, (b * f - c * e) / (denom + 1e-12),
                                torch.zeros_like(denom))
                s = torch.clamp(s, 0.0, 1.0)
                t = torch.clamp((b * s + f) / e, 0.0, 1.0)
                s = torch.clamp((b * t - c) / a, 0.0, 1.0)
                dep, n, pt = sphere_sphere(p1 + s * d1, si[0], p2 + t * d2, sj[0])
                out.append(_Cand(gi, gj, li, lj, mu, dep, n, pt))
            elif kind == "sphere_sphere":
                dep, n, pt = sphere_sphere(pi_, si[0], geom_pose(gj)[0], sj[0])
                out.append(_Cand(gi, gj, li, lj, mu, dep, n, pt))
            elif kind == "sphere_capsule":
                # the sphere (geom i) against the closest point of the
                # capsule's axis segment
                pj_, qj_ = geom_pose(gj)
                axis = _qrot(qj_, Z)
                a = pj_ - float(sj[1]) * axis
                d = float(2.0 * sj[1]) * axis
                t = torch.clamp(_dot(pi_ - a, d) / (_dot(d, d) + 1e-12), 0.0, 1.0)
                dep, n, pt = sphere_sphere(pi_, si[0], a + t * d, sj[0])
                out.append(_Cand(gi, gj, li, lj, mu, dep, n, pt))
            else:  # gated by check_supported
                raise NotImplementedError(kind)
    return out


def _contact_forces(model: Model, cvel, origin, candidates: List[_Cand]):
    """Accumulated world wrenches about ``origin`` per link: dict l -> (6,B)."""
    if not candidates:
        return None
    ks = float(np.float32(model.contact_stiffness))
    kd = float(np.float32(model.contact_damping))
    cap = float(np.float32(model.contact_depth_cap))
    vreg = float(np.float32(model.friction_vel))
    ratio = model.contact_force_cap_ratio
    fcap = float(np.float32(ratio) * np.float32(ks) * np.float32(cap))

    def point_vel(l: int, p_rel):
        if l < 0:
            return torch.zeros_like(p_rel)
        v = cvel[l]
        return v[3:6] + _cross(v[0:3], p_rel)

    f_ext: Dict[int, torch.Tensor] = {}
    for cand in candidates:
        depth, n = cand.depth, cand.n
        p_rel = cand.pt - origin
        v_rel = point_vel(cand.li, p_rel) - point_vel(cand.lj, p_rel)
        v_n = _dot(v_rel, n)
        v_t = v_rel - v_n * n
        fn = torch.clamp(ks * torch.clamp(depth, max=cap) - kd * v_n, min=0.0)
        fn = torch.where(depth > 0.0, fn, torch.zeros_like(fn))
        if ratio > 0:
            fn = torch.clamp(fn, max=fcap)
        vt_norm = torch.sqrt(_dot(v_t, v_t))
        f = fn * n - cand.mu * fn * v_t / (vt_norm + vreg)
        wrench = torch.cat([_cross(p_rel, f), f], dim=0)
        for link, sign in ((cand.li, 1.0), (cand.lj, -1.0)):
            if link < 0:
                continue
            w = wrench if sign > 0 else -wrench
            f_ext[link] = w if f_ext.get(link) is None else f_ext[link] + w
    return f_ext


def _qrot_inv(q, v):
    """Rotate by the conjugate quaternion (world -> body axes)."""
    w, qv = q[0:1], -q[1:4]
    t = 2.0 * _cross(qv, v)
    return v + w * t + _cross(qv, t)


def fluid_coefficients(model: Model, i: int) -> Tuple[float, float, np.ndarray, np.ndarray]:
    """Link ``i``'s drag constants of the inertia-box fluid model, folded
    in f64 from ``link_ibox``, density and viscosity: ``(lin, ang, quad_f,
    quad_t)`` with force ``lin v - quad_f |v| v`` and torque ``ang w -
    quad_t |w| w`` in the link's principal axes (``quad_*`` are the f32
    products ``f32(2 rho) f32(b_j b_k)`` and ``f32(rho / 2) f32(b (b_j^4 +
    b_k^4))`` the plain version forms)."""
    rho, mu = float(model.density), float(model.viscosity)
    b = np.asarray(model.link_ibox[i], np.float64)
    b_j, b_k = b[[1, 2, 0]], b[[2, 0, 1]]
    d_eq = 2.0 * float(b.mean())
    quad_f = np.float32(2.0 * rho) * (b_j * b_k).astype(np.float32)
    quad_t = np.float32(0.5 * rho) * (b * (b_j**4 + b_k**4)).astype(np.float32)
    return -3.0 * np.pi * d_eq * mu, -np.pi * d_eq**3 * mu, quad_f, quad_t


def _fluid_forces(model: Model, pos, quat, cvel, origin, f_ext):
    """MuJoCo's legacy inertia-box fluid model: per-link world wrenches
    about ``origin`` added into ``f_ext`` (dict l -> (6, B), or None).
    Links with mass <= 0 feel none."""
    dev = origin.device
    out = dict(f_ext) if f_ext is not None else {}
    for i in range(model.nlink):
        if float(model.link_mass[i]) <= 0.0:
            continue
        lin, ang, quad_f, quad_t = fluid_coefficients(model, i)
        # world -> principal-inertia frame of the link
        q_wp = _qmul(quat[i], _c(model, model.link_iquat[i], dev))
        com_w = pos[i] - origin + _qrot(quat[i], _c(model, model.link_com[i], dev))
        omega_w = cvel[i][0:3]
        v_com_w = cvel[i][3:6] + _cross(omega_w, com_w)
        w_p = _qrot_inv(q_wp, omega_w)
        v_p = _qrot_inv(q_wp, v_com_w)
        force = lin * v_p - _c(model, quad_f, dev) * torch.abs(v_p) * v_p
        torque = ang * w_p - _c(model, quad_t, dev) * torch.abs(w_p) * w_p
        f_w = _qrot(q_wp, force)
        t_w = _qrot(q_wp, torque)
        wrench = torch.cat([_cross(com_w, f_w) + t_w, f_w], dim=0)
        out[i] = wrench if out.get(i) is None else out[i] + wrench
    return out


# ---------------------------------------------------------------------------
# Joint-space forces and integration.
# ---------------------------------------------------------------------------


def _limit_viol(model: Model, i: int, qi):
    lo, hi = model.jnt_range[i]
    return torch.clamp(qi - float(lo), max=0.0) + torch.clamp(qi - float(hi), min=0.0)


def _applied_forces(model: Model, q, qd, ctrl, include_limits: bool = True):
    """Actuators + joint springs + limit penalties: (nv, B) generalized
    force. An actuator is a gear motor (force = ctrl) or, with
    ``act_gainprm``, an affine servo: force = g0 ctrl + b0 + b1 (gear q) +
    b2 (gear qd). ``include_limits=False`` leaves out the limit penalties:
    the Newton solver makes limits constraint rows instead."""
    rows: List[Optional[torch.Tensor]] = [None] * model.nv

    def add(v, val):
        rows[v] = val if rows[v] is None else rows[v] + val

    for u in range(model.nu):
        v = int(model.act_vadr[u])
        cu = ctrl[u : u + 1]
        if model.act_ctrllimited[u] > 0:
            lo, hi = model.act_ctrlrange[u]
            cu = torch.clamp(cu, float(lo), float(hi))
        gear = float(np.float32(model.act_gear[u]))
        if model.act_gainprm is not None:
            g = np.asarray(model.act_gainprm[u], np.float32)
            b = np.asarray(model.act_biasprm[u], np.float32)
            qa = int(model.act_qadr[u])
            cu = (float(g[0]) * cu + float(b[0]) + float(b[1]) * (gear * q[qa : qa + 1])
                  + float(b[2]) * (gear * qd[v : v + 1]))
        add(v, gear * cu)

    for i in range(model.nlink):
        if model.link_jnt_type[i] not in (HINGE, SLIDE):
            continue
        adr, v = model.link_qadr[i], model.link_vadr[i]
        qi = q[adr : adr + 1]
        qdi = qd[v : v + 1]
        stiff = float(model.jnt_stiffness[i])
        if stiff != 0.0:
            add(v, -stiff * (qi - float(model.jnt_springref[i])))
        if include_limits and model.jnt_limited[i] > 0:
            k = float(model.dof_limit_stiffness[v])
            c = float(model.dof_limit_damping[v])
            viol = _limit_viol(model, i, qi)
            add(v, -k * viol - torch.where(viol.abs() > 0, c * qdi, torch.zeros_like(qdi)))

    zero = qd.new_zeros((1, qd.shape[1]))
    return torch.cat([r if r is not None else zero for r in rows], dim=0)


def friction_terms(model: Model, qd):
    """Regularised per-dof dry friction (``dof_frictionloss``), twin of
    ``mjrl_tpu/physics/engine.py::friction_terms``: ``(force (nv, B),
    diag (nv, B))`` with force ``-fl tanh(qd / v_eps)`` and its velocity
    Jacobian ``fl / v_eps (1 - tanh^2)``, or ``(None, None)`` without
    frictionloss."""
    if not has_frictionloss(model):
        return None, None
    fl = _c(model, model.dof_frictionloss, qd.device)
    v_eps = float(np.float32(model.dof_friction_vel))
    t = torch.tanh(qd / v_eps)
    return -fl * t, (fl / v_eps) * (1.0 - t * t)


def tendon_params(model: Model):
    """The tendon constants ``(Jq (nt, nq), Jv (nt, nv), P (8, nt))`` f32;
    ``P``'s rows: stiffness, spring length, damping, range lo, range hi,
    limit stiffness, limit damping, limited."""
    nt = np.asarray(model.tendon_Jq).shape[0]
    if model.tendon_limit_stiffness is not None:
        k = np.asarray(model.tendon_limit_stiffness, np.float32)
        c = np.asarray(model.tendon_limit_damping, np.float32)
    else:
        k = np.full(nt, model.limit_stiffness, np.float32)
        c = np.full(nt, model.limit_damping, np.float32)
    rng = np.asarray(model.tendon_range, np.float32)
    P = np.stack([np.asarray(model.tendon_stiffness, np.float32),
                  np.asarray(model.tendon_springlength, np.float32),
                  np.asarray(model.tendon_damping, np.float32), rng[:, 0], rng[:, 1], k, c,
                  np.asarray(model.tendon_limited, np.float32)])
    return (np.asarray(model.tendon_Jq, np.float32), np.asarray(model.tendon_Jv, np.float32), P)


def _tendon_forces(model: Model, q, qd):
    """Fixed-tendon passive forces ``(nv, B)``: a spring and damper on the
    length ``l = Jq q`` and the velocity ``Jv qd``, plus a limit penalty
    where limited, projected back through ``Jv^T``."""
    dev = q.device
    cache = model.__dict__.setdefault("_torch_tendon", {})
    if str(dev) not in cache:
        cache[str(dev)] = tuple(torch.from_numpy(a).to(dev) for a in tendon_params(model))
    Jq, Jv, P = cache[str(dev)]
    length = Jq @ q
    vel = Jv @ qd
    col = lambda i: P[i][:, None]
    f = -col(0) * (length - col(1)) - col(2) * vel
    viol = torch.clamp(length - col(3), max=0.0) + torch.clamp(length - col(4), min=0.0)
    f_lim = -col(5) * viol - torch.where(viol.abs() > 0, col(6) * vel, torch.zeros_like(vel))
    return Jv.T @ (f + col(7) * f_lim)


def _limit_damping_rows(model: Model, q, dt: float):
    """Per-dof dt*c_limit*active (1, B) rows (or None): the implicit-diagonal
    half of the limit damper."""
    rows: List = [None] * model.nv
    for i in range(model.nlink):
        if model.link_jnt_type[i] not in (HINGE, SLIDE) or model.jnt_limited[i] <= 0:
            continue
        adr, v = model.link_qadr[i], model.link_vadr[i]
        qi = q[adr : adr + 1]
        dtc = float(np.float32(dt) * np.float32(model.dof_limit_damping[v]))
        viol = _limit_viol(model, i, qi)
        rows[v] = torch.where(viol.abs() > 0, dtc, 0.0).to(qi.dtype)
    return rows


def _integrate(model: Model, q, qd, qdd, dt: float):
    """Semi-implicit Euler with exponential-map quaternion updates."""
    dt = float(np.float32(dt))
    qd2 = qd + dt * qdd
    q_rows: List[torch.Tensor] = [q[a : a + 1] for a in range(model.nq)]
    for i in range(model.nlink):
        t = model.link_jnt_type[i]
        adr, v = model.link_qadr[i], model.link_vadr[i]
        if t in (HINGE, SLIDE):
            q_rows[adr] = q_rows[adr] + dt * qd2[v : v + 1]
        elif t == FREE:
            pos = q[adr : adr + 3]
            quat = q[adr + 3 : adr + 7]
            omega = qd2[v : v + 3]
            vlin = qd2[v + 3 : v + 6]
            pos = pos + dt * _qrot(quat, vlin)
            angle = torch.sqrt(_dot(omega, omega))
            small = angle < 1e-9
            safe = torch.where(small, torch.ones_like(angle), angle)
            axis = omega / safe
            half = 0.5 * angle * dt
            s = torch.sin(half)
            dq = torch.cat([torch.cos(half), axis[0:1] * s, axis[1:2] * s, axis[2:3] * s], dim=0)
            ident = _c(model, [1.0, 0.0, 0.0, 0.0], q.device)
            dq = torch.where(small, ident, dq)
            quat = _qnorm(_qmul(quat, dq))
            for k in range(3):
                q_rows[adr + k] = pos[k : k + 1]
            for k in range(4):
                q_rows[adr + 3 + k] = quat[k : k + 1]
    return torch.cat(q_rows, dim=0), qd2


# ---------------------------------------------------------------------------
# The substep and the multi-step entry point.
# ---------------------------------------------------------------------------


def substep(model: Model, q: torch.Tensor, qd: torch.Tensor, ctrl: torch.Tensor, dt: float,
            picks: Optional[list] = None, link_delta: Optional[torch.Tensor] = None,
            costs: Optional[list] = None, replay: Optional[torch.Tensor] = None,
            held: Optional[list] = None):
    """One physics substep, batch-last: q (nq, B), qd (nv, B), ctrl (nu, B),
    ``link_delta`` (3 nlink, B) or None. With the Newton solver, ``picks``
    and ``costs`` (lists) collect each iteration's line-search fraction
    index and its five costs, ``held`` (a list) each env's contact rows
    inside their margin ((B,), the kernels' held rows), and ``replay``
    ((solver_iters, B) fraction indices, or None) sets the fractions it
    steps by (see ``soa_newton.constrained_qdd``)."""
    newton = model.constraint_solver == "newton"
    tab = soa_tables(model)
    pos, quat = _fk(model, q, link_delta)
    origin = pos[0]
    cdof = _cdofs(model, pos, quat, origin)
    cvel = _cvels(model, cdof, qd)
    inert = _world_inertias(model, tab, pos, quat, origin)
    candidates = _contact_candidates(model, pos, quat) if model.contact_pairs else []
    f_ext = None if newton else _contact_forces(model, cvel, origin, candidates)
    if model.density != 0.0 or model.viscosity != 0.0:
        f_ext = _fluid_forces(model, pos, quat, cvel, origin, f_ext)
    crb = _composite_inertias(model, tab, inert)
    M = _mass_matrix_sparse(model, tab, cdof, crb)
    C = _bias_forces(model, tab, cdof, cvel, inert, qd, f_ext)
    tau = _applied_forces(model, q, qd, ctrl, include_limits=not newton)
    if model.tendon_Jq is not None:
        # the full tendon force, limit penalty included, in both solver
        # modes: the tendon limits stay penalties under Newton
        tau = tau + _tendon_forces(model, q, qd)
    damping = _c(model, model.dof_damping, q.device)
    rhs = tau - C - damping * qd
    f_fric, d_fric = friction_terms(model, qd)
    fric_rows = None
    if f_fric is not None:
        rhs = rhs + f_fric
        # the friction's implicit diagonal, dt-scaled like the dampers
        dt32 = float(np.float32(dt))
        fric_rows = [dt32 * d_fric[k : k + 1] for k in range(model.nv)]
    if newton:
        from mjrl_tpu_torch.physics import soa_newton

        # the diagonal joins both the unconstrained solve and the metric
        qdd0 = _ltdl_solve(model, tab, M, rhs, dt, fric_rows)
        qdd = soa_newton.constrained_qdd(model, pos, cdof, M, q, qd, qdd0, candidates, dt,
                                         fric_diag=fric_rows, picks=picks, costs=costs,
                                         replay=replay, held=held)
    else:
        diag = _limit_damping_rows(model, q, dt)
        if fric_rows is not None:
            diag = [f if l is None else l + f for l, f in zip(diag, fric_rows)]
        qdd = _ltdl_solve(model, tab, M, rhs, dt, diag)
    return _integrate(model, q, qd, qdd, dt)


def multistep(model: Model, q: torch.Tensor, qd: torch.Tensor, ctrl: torch.Tensor,
              n_frames: int = 1, picks: Optional[list] = None,
              link_delta: Optional[torch.Tensor] = None, costs: Optional[list] = None,
              replay: Optional[torch.Tensor] = None, held: Optional[list] = None):
    """``n_frames`` control frames = ``n_frames * model.n_substeps`` substeps
    with ``ctrl`` (and ``link_delta``) held. With the Newton solver,
    ``replay`` (an int (n_frames * n_substeps * solver_iters, B) tensor, a
    kernel's ``picks``, or None) sets each iteration's line-search fraction
    (``soa_newton.constrained_qdd``); ``picks``, ``costs`` and ``held`` as
    :func:`substep`'s, over every substep."""
    dt = model.dt / model.n_substeps
    iters = int(model.solver_iters)
    for s in range(n_frames * model.n_substeps):
        q, qd = substep(model, q, qd, ctrl, dt, picks, link_delta, costs,
                        None if replay is None else replay[s * iters : (s + 1) * iters], held)
    return q, qd


def static_kinematics(model: Model, qpos: np.ndarray):
    """One configuration's dense mass matrix (f32, without armature) and
    its link poses and motion subspaces, as numpy: ``(M (nv, nv),
    pos (nlink, 3), quat (nlink, 4), cdof (nv, 6))``, subspaces about
    ``pos[0]``. Load-time input of the limit gains and the invweights. A
    model with a ball joint, which the plain version does not step, takes
    the per-env engine's (physics/engine.py)."""
    if BALL in model.link_jnt_type:
        from mjrl_tpu_torch.physics import engine

        q = torch.as_tensor(np.asarray(qpos, np.float32))[None]
        kin = engine.compute_kinematics(model, q, q.new_zeros(1, model.nv))
        return tuple(x[0].numpy() for x in (engine.crba(model, kin), kin.pos, kin.quat, kin.cdof))
    tab = soa_tables(model)
    q = torch.as_tensor(np.asarray(qpos, np.float32)).reshape(-1, 1)
    pos, quat = _fk(model, q)
    cdof = _cdofs(model, pos, quat, pos[0])
    crb = _composite_inertias(model, tab, _world_inertias(model, tab, pos, quat, pos[0]))
    Ms = _mass_matrix_sparse(model, tab, cdof, crb)
    M = np.zeros((model.nv, model.nv), np.float32)
    for (i, j), v in Ms.items():
        M[i, j] = M[j, i] = float(v)
    col = lambda xs: np.stack([x[:, 0].numpy() for x in xs])
    return M, col(pos), col(quat), col(cdof)


def mass_matrix_diag(model: Model, qpos: np.ndarray) -> np.ndarray:
    """Diagonal of the joint-space mass matrix at one configuration (f32,
    without armature): the load-time input of the limit gains."""
    return np.diag(static_kinematics(model, qpos)[0]).copy()
