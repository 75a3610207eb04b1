"""Plain PyTorch batch-last physics substep: the reference for kernel K1.

Twin of ``mjrl_tpu/physics/soa.py`` on ant's feature set: every per-env
scalar is a ``(1, B)`` row and every 3-vector a ``(3, B)`` tensor, and all
loops (tree walks, dof chains, contact pairs) unroll in Python over the
static tables of physics/tables.py, in the reference's order. The pipeline
per substep is kinematics -> cdof/cvel -> penalty contacts -> composite
inertias -> sparse mass matrix -> RNE bias -> applied forces -> sparse
L^T D L solve -> semi-implicit Euler.

This is the kernel's plain version: physics/pkernel.py runs it for tensors
on the CPU, and the tests and ``chip_smoke.py`` hold the CUDA kernel
against it. It issues thousands of tiny ops per substep, so on a card it is
launch-bound and only fit for comparisons.

Feature set (``check_supported``): free, hinge and fixed links; sphere- and
capsule-plane contacts against world planes; ctrl-limited gear motors;
joint springs; per-dof limit penalties; the penalty contact solver.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mjrl_tpu_torch.physics.model import FREE, HINGE, JOINT_NV, Model
from mjrl_tpu_torch.physics.tables import (
    SoATables,
    pair_groups,
    plane_normal_point,
    soa_tables,
)

SUPPORTED_KINDS = ("sphere_plane", "capsule_plane")


def check_supported(model: Model) -> None:
    """Raise ``NotImplementedError`` for a model outside the ported set."""
    for i in range(model.nlink):
        if model.link_jnt_type[i] not in (-1, FREE, HINGE):
            raise NotImplementedError(
                f"link {i}: joint type {model.link_jnt_type[i]} is not ported"
            )
    if model.constraint_solver != "penalty":
        raise NotImplementedError(f"solver {model.constraint_solver!r} is not ported")
    for kind, tab in pair_groups(model).kinds:
        if kind not in SUPPORTED_KINDS:
            raise NotImplementedError(f"contact kind {kind!r} is not ported")
        if any(model.geom_link[int(g)] >= 0 for g in tab["gj"]):
            raise NotImplementedError("planes must be world geoms")
    if model.tendon_Jq is not None:
        raise NotImplementedError("tendons are not ported")
    if model.density != 0.0 or model.viscosity != 0.0:
        raise NotImplementedError("fluid forces are not ported")
    fl = model.dof_frictionloss
    if fl is not None and np.any(np.asarray(fl)):
        raise NotImplementedError("frictionloss is not ported")
    if model.act_gainprm is not None:
        raise NotImplementedError("gain/bias actuators are not ported")
    if model.dof_limit_stiffness is None and np.any(model.jnt_limited > 0):
        raise ValueError("limited joints need per-dof limit gains")


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


def _fk(model: Model, q: torch.Tensor):
    """World link poses: (pos list (3, B), quat list (4, B))."""
    dev = q.device
    pos: List[torch.Tensor] = [None] * model.nlink
    quat: List[torch.Tensor] = [None] * model.nlink
    for i in range(model.nlink):
        t = model.link_jnt_type[i]
        adr = model.link_qadr[i]
        lp, lq = _c(model, model.link_pos[i], dev), _c(model, model.link_quat[i], dev)
        jp = jq = None
        if t == HINGE:
            ax = _c(model, model.jnt_axis[i], dev)
            an = _c(model, model.jnt_anchor[i], dev)
            half = 0.5 * (q[adr : adr + 1] - float(model.jnt_ref[i]))
            s = torch.sin(half)
            jq = torch.cat([torch.cos(half), ax[0:1] * s, ax[1:2] * s, ax[2:3] * s], dim=0)
            jp = an - _qrot(jq, an)
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
    __slots__ = ("li", "lj", "mu", "depth", "n", "pt")

    def __init__(self, li, lj, mu, depth, n, pt):
        self.li, self.lj, self.mu = li, lj, mu
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

    Z = _c(model, [0.0, 0.0, 1.0], dev)
    for kind, tab in pair_groups(model).kinds:
        for p_i in range(len(tab["gi"])):
            gi, gj = int(tab["gi"][p_i]), int(tab["gj"][p_i])
            li, lj = int(tab["li"][p_i]), int(tab["lj"][p_i])
            mu = float(tab["mu"][p_i])
            si = np.asarray(model.geom_size[gi], np.float32)
            nrm_np, pp_np = plane_normal_point(model, gj)
            nrm, pp = _c(model, nrm_np, dev), _c(model, pp_np, dev)
            r = float(si[0])
            pi_, qi_ = geom_pose(gi)
            if kind == "sphere_plane":
                dist = _dot(pi_ - pp, nrm) - r
                out.append(_Cand(li, lj, mu, -dist, nrm, pi_ - nrm * r))
            elif kind == "capsule_plane":
                axis = _qrot(qi_, Z)
                for sgn in (-1.0, 1.0):
                    end = pi_ + float(np.float32(sgn * si[1])) * axis
                    dist = _dot(end - pp, nrm) - r
                    out.append(_Cand(li, lj, mu, -dist, nrm, end - nrm * r))
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


# ---------------------------------------------------------------------------
# Joint-space forces and integration.
# ---------------------------------------------------------------------------


def _limit_viol(model: Model, i: int, qi):
    lo, hi = model.jnt_range[i]
    return torch.clamp(qi - float(lo), max=0.0) + torch.clamp(qi - float(hi), min=0.0)


def _applied_forces(model: Model, q, qd, ctrl):
    """Motors + joint springs + limit penalties: (nv, B) generalized force."""
    rows: List[Optional[torch.Tensor]] = [None] * model.nv

    def add(v, val):
        rows[v] = val if rows[v] is None else rows[v] + val

    for u in range(model.nu):
        v = int(model.act_vadr[u])
        cu = ctrl[u : u + 1]
        if model.act_ctrllimited[u] > 0:
            lo, hi = model.act_ctrlrange[u]
            cu = torch.clamp(cu, float(lo), float(hi))
        add(v, float(model.act_gear[u]) * cu)

    for i in range(model.nlink):
        if model.link_jnt_type[i] != HINGE:
            continue
        adr, v = model.link_qadr[i], model.link_vadr[i]
        qi = q[adr : adr + 1]
        qdi = qd[v : v + 1]
        stiff = float(model.jnt_stiffness[i])
        if stiff != 0.0:
            add(v, -stiff * (qi - float(model.jnt_springref[i])))
        if model.jnt_limited[i] > 0:
            k = float(model.dof_limit_stiffness[v])
            c = float(model.dof_limit_damping[v])
            viol = _limit_viol(model, i, qi)
            add(v, -k * viol - torch.where(viol.abs() > 0, c * qdi, torch.zeros_like(qdi)))

    zero = qd.new_zeros((1, qd.shape[1]))
    return torch.cat([r if r is not None else zero for r in rows], dim=0)


def _limit_damping_rows(model: Model, q, dt: float):
    """Per-dof dt*c_limit*active (1, B) rows (or None): the implicit-diagonal
    half of the limit damper."""
    rows: List = [None] * model.nv
    for i in range(model.nlink):
        if model.link_jnt_type[i] != HINGE or model.jnt_limited[i] <= 0:
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
        if t == HINGE:
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


def substep(model: Model, q: torch.Tensor, qd: torch.Tensor, ctrl: torch.Tensor, dt: float):
    """One physics substep, batch-last: q (nq, B), qd (nv, B), ctrl (nu, B)."""
    tab = soa_tables(model)
    pos, quat = _fk(model, q)
    origin = pos[0]
    cdof = _cdofs(model, pos, quat, origin)
    cvel = _cvels(model, cdof, qd)
    inert = _world_inertias(model, tab, pos, quat, origin)
    candidates = _contact_candidates(model, pos, quat) if model.contact_pairs else []
    f_ext = _contact_forces(model, cvel, origin, candidates)
    crb = _composite_inertias(model, tab, inert)
    M = _mass_matrix_sparse(model, tab, cdof, crb)
    C = _bias_forces(model, tab, cdof, cvel, inert, qd, f_ext)
    tau = _applied_forces(model, q, qd, ctrl)
    damping = _c(model, model.dof_damping, q.device)
    rhs = tau - C - damping * qd
    qdd = _ltdl_solve(model, tab, M, rhs, dt, _limit_damping_rows(model, q, dt))
    return _integrate(model, q, qd, qdd, dt)


def multistep(model: Model, q: torch.Tensor, qd: torch.Tensor, ctrl: torch.Tensor,
              n_frames: int = 1):
    """``n_frames`` control frames = ``n_frames * model.n_substeps`` substeps
    with ``ctrl`` held."""
    dt = model.dt / model.n_substeps
    for _ in range(n_frames * model.n_substeps):
        q, qd = substep(model, q, qd, ctrl, dt)
    return q, qd


def mass_matrix_diag(model: Model, qpos: np.ndarray) -> np.ndarray:
    """Diagonal of the joint-space mass matrix at one configuration (f32,
    without armature): the load-time input of the limit gains."""
    tab = soa_tables(model)
    q = torch.as_tensor(np.asarray(qpos, np.float32)).reshape(-1, 1)
    pos, quat = _fk(model, q)
    cdof = _cdofs(model, pos, quat, pos[0])
    crb = _composite_inertias(model, tab, _world_inertias(model, tab, pos, quat, pos[0]))
    M = _mass_matrix_sparse(model, tab, cdof, crb)
    return np.asarray([float(M[(i, i)]) for i in range(model.nv)], np.float32)
