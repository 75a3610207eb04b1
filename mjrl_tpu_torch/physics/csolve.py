"""MuJoCo-style soft constraints: the solver's parameters, and the per-env
engine's rows and Newton solve.

Twin of ``mjrl_tpu/physics/csolve.py``. Its first part (numpy) fills what
the MJCF left unset, once, at load time; the Newton rows of the kernels'
plain version (physics/soa_newton.py), of kernels K2 and K4, and of the
engine below read solref, solimp, margin, torsional friction and the
invweights from the model:

- ``dof_invweight0 = diag(M^-1)`` at qpos0, with M the joint-space mass
  matrix plus armature;
- ``geom_invweight0 = tr(Jp M^-1 Jp^T) / 3`` with Jp the point Jacobian of
  the owning link's centre of mass (0 for world geoms).

M comes from the port's own plain mass matrix (physics/soa.py; the
engine's ``crba`` for a model with ball joints) in f32 and is inverted in
float64, as the reference inverts its f32 ``crba``.

The second part is the per-env engine's constrained forward dynamics
(``forward_qacc``, called by ``engine.step`` under the Newton solver),
batch-first like physics/engine.py: every joint limit and every contact
point is a row at every step, a row far from violation deactivates itself
(its ``D`` is 0 unless ``pos < 0``, and it is active in a Newton iteration
only while ``J x - aref < 0``), and a fixed number of Newton iterations
minimises

    cost(x) = 1/2 (x - qdd0)^T M (x - qdd0) + 1/2 sum_i act_i D_i (J_i x - aref_i)^2

with MuJoCo's impedance ``d(pos)`` from solimp, ``k, b`` from solref,
``aref = -b J qd - k d pos`` and ``R = (1 - d) / d * invweight`` (times
``2 mu^2 (1 + mu^2)`` on the pyramid's facets). Contact rows: condim 1 (the
normal), 3 (four facets ``n +- mu t_1``, ``n +- mu t_2``) or 4 (two more,
``n +- mu_tor`` about the normal), per pair where the model says so, with
``includemargin`` (the two geoms' margins). Each kind's points are one set
of ops over ``(B, P)``, and the rows come out in the reference's order:
limits, then each kind's points in turn, each point's facets together.
It is a separate implementation from the plain version's rows
(physics/soa_newton.py), so the engine is a second oracle for K2 and K4.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mjrl_tpu_torch.physics import math3d as m3
from mjrl_tpu_torch.physics.engine import (
    Kinematics,
    PhysicsState,
    actuation,
    chol_solve,
    compute_kinematics,
    const,
    crba,
    friction_terms,
    passive_forces_smooth,
    rnea_bias,
    tendon_forces,
)
from mjrl_tpu_torch.physics.model import Model
from mjrl_tpu_torch.physics.tables import pair_groups, points_per_pair, tree_tables

_DEF_SOLREF = np.array([0.02, 1.0], np.float32)
_DEF_SOLIMP = np.array([0.9, 0.95, 0.001, 0.5, 2.0], np.float32)
_MINVAL = 1e-10
_ALPHAS = (1.0, 0.5, 0.25, 0.0625, 0.0)  # the line search's fixed fractions


def ensure_solver_params(model: Model) -> None:
    """Fill MuJoCo-default solref/solimp/margin/torsional friction and
    compute the invweight0 arrays at qpos0 (idempotent)."""
    if getattr(model, "_solver_ready", False):
        return
    if model.jnt_solref is None:
        model.jnt_solref = np.tile(_DEF_SOLREF, (model.nlink, 1))
    if model.jnt_solimp is None:
        model.jnt_solimp = np.tile(_DEF_SOLIMP, (model.nlink, 1))
    if model.geom_solref is None:
        model.geom_solref = np.tile(_DEF_SOLREF, (model.ngeom, 1))
    if model.geom_solimp is None:
        model.geom_solimp = np.tile(_DEF_SOLIMP, (model.ngeom, 1))
    if model.geom_margin is None:
        model.geom_margin = np.zeros(model.ngeom, np.float32)
    if model.geom_friction_tor is None:
        model.geom_friction_tor = np.full(model.ngeom, 0.005, np.float32)
    if model.dof_invweight0 is None or model.geom_invweight0 is None:
        _compute_invweights(model)
    model._solver_ready = True


def _compute_invweights(model: Model) -> None:
    from mjrl_tpu_torch.physics import soa

    M, pos, quat, cdof = soa.static_kinematics(model, model.default_qpos)
    M = M.astype(np.float64) + np.diag(np.asarray(model.dof_armature, np.float64))
    Minv = np.linalg.inv(M)
    if model.dof_invweight0 is None:
        model.dof_invweight0 = np.diag(Minv).astype(np.float32)
    if model.geom_invweight0 is None:
        anc = tree_tables(model).L_mask
        cdof = cdof.astype(np.float64)  # (nv, 6): [angular; linear at origin]
        origin = pos[0]
        inv_g = np.zeros(model.ngeom, np.float32)
        for g in range(model.ngeom):
            l = model.geom_link[g]
            if l < 0:
                continue  # world-static
            # the point MuJoCo uses: the owning body's centre of mass
            r = pos[l] + _rot_np(quat[l], np.asarray(model.link_com[l])) - origin
            Jp = np.zeros((3, model.nv))
            for j in np.flatnonzero(anc[l] > 0):
                Jp[:, j] = cdof[j, 3:] + np.cross(cdof[j, :3], r)
            inv_g[g] = float(np.trace(Jp @ Minv @ Jp.T) / 3.0)
        model.geom_invweight0 = inv_g


def _rot_np(q, v):
    w, x, y, z = q
    R = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    return R @ np.asarray(v)


# ---------------------------------------------------------------------------
# The engine's rows and Newton solve.
# ---------------------------------------------------------------------------


class Rows(NamedTuple):
    J: torch.Tensor  # (B, nrows, nv)
    aref: torch.Tensor  # (B, nrows)
    D: torch.Tensor  # (B, nrows) = 1 / R where the row is instantiated, else 0


def _impedance(solimp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """MuJoCo's impedance spline ``d(|pos| / width)``; ``solimp (rows,
    5)`` against ``pos (B, rows)``."""
    dmin, dmax, width, mid, power = solimp.unbind(-1)
    x = pos.abs() / torch.clamp(width, min=_MINVAL)
    a = (1.0 / torch.pow(mid, power - 1.0)) * torch.pow(x, power)
    b = 1.0 - (1.0 / torch.pow(1.0 - mid, power - 1.0)) * torch.pow(torch.clamp(1.0 - x, min=0.0),
                                                                      power)
    y = torch.where(x < mid, a, b)
    d = torch.minimum(torch.maximum(dmin + y * (dmax - dmin), dmin), dmax)
    return torch.where(x >= 1.0, dmax.expand_as(d), d)


def _kb(solref: torch.Tensor, solimp: torch.Tensor):
    """Stiffness and damping from ``solref (rows, 2)``; a negative entry
    gives them directly (MuJoCo's convention)."""
    tc, dr = solref.unbind(-1)
    dmax = solimp[:, 1]
    k = 1.0 / torch.clamp(dmax * dmax * tc * tc * dr * dr, min=_MINVAL)
    b = 2.0 / torch.clamp(dmax * tc, min=_MINVAL)
    return torch.where(tc < 0, -tc, k), torch.where(dr < 0, -dr, b)


def _point_jacobian(kin: Kinematics, p_world: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """``(B, P, k, nv)``: the velocity of each point ``p_world (B, P, 3)``
    along each of its directions ``dirs (B, P, k, 3)`` per unit velocity of
    each dof, ``d . (v_j + w_j x r) = d . v_j + (r x d) . w_j`` about
    ``kin.origin``. Times a point's chain mask (:func:`_chain_mask`) it is
    its world Jacobian on that link along ``d``."""
    B, P, k, _ = dirs.shape
    r = (p_world - kin.origin[:, None])[:, :, None, :]
    lin = dirs.reshape(B, P * k, 3) @ kin.cdof[..., 3:].transpose(1, 2)
    ang = m3.cross(r, dirs).reshape(B, P * k, 3) @ kin.cdof[..., :3].transpose(1, 2)
    return (lin + ang).reshape(B, P, k, -1)


def _chain_mask(model: Model, links: np.ndarray) -> np.ndarray:
    """``(P, nv)``: 1 where the dof is on the chain of the point's link
    (none for the world, -1)."""
    L = np.concatenate([tree_tables(model).L_mask, np.zeros((1, model.nv), np.float32)])
    return L[np.where(np.asarray(links) < 0, model.nlink, links)]


def _tangent_frame(model: Model, n: torch.Tensor):
    """Deterministic orthonormal tangents of the normals ``n (..., 3)``."""
    ref = torch.where(n[..., 2:3].abs() < 0.99, const(model, "z_axis", [0.0, 0.0, 1.0], n.device),
                      const(model, "x_axis", [1.0, 0.0, 0.0], n.device))
    t1 = torch.linalg.cross(ref.expand_as(n), n, dim=-1)
    t1 = t1 / (torch.linalg.vector_norm(t1, dim=-1, keepdim=True) + 1e-12)
    return t1, torch.linalg.cross(n, t1, dim=-1)


class _KindRows(NamedTuple):
    """One contact kind's static row tables: per point, then per row."""

    chain: np.ndarray  # (P, nv) i's chain mask minus j's: the relative Jacobian's
    margin: np.ndarray  # (P,) includemargin: the two geoms' margins
    point: np.ndarray  # (rows,) the point of each row
    # (rows, 4): each row's J over its point's [n, t1, t2 and the normal's
    # rotation]: n alone (condim 1), n +- mu t_1, n +- mu t_2 (the pyramid),
    # n +- mu_tor (condim 4's torsional facets)
    coef: np.ndarray


class _RowTables(NamedTuple):
    lim_q: np.ndarray  # limited 1-dof joints: qpos address, range, dof (one-hot rows)
    lim_lo: np.ndarray
    lim_hi: np.ndarray
    lim_dof: np.ndarray  # (limits, nv)
    kinds: Tuple[Tuple[str, Dict[str, np.ndarray], _KindRows], ...]
    solref: np.ndarray  # (rows, 2), all rows: limits, then each kind's
    solimp: np.ndarray  # (rows, 5)
    invw: np.ndarray  # (rows,)
    pyramidal: np.ndarray  # (rows,) 1 on a pyramid's facet
    mu: np.ndarray  # (rows,)


def _points(x: np.ndarray, kind: str, n_points: int) -> np.ndarray:
    """Per-pair ``x`` expanded to the kind's points, as
    physics/contact.py's ``_collide_kind`` orders them."""
    x = np.asarray(x)
    if kind == "box_box":
        return np.concatenate([np.repeat(x, 8, axis=0)] * 2)
    return np.repeat(x, n_points // len(x), axis=0)


def _row_tables(model: Model) -> _RowTables:
    """The static part of every row (cached on the model): which joints
    and points make rows, each point's condim and facets, and every row's
    solref, solimp, invweight and friction, as the reference's
    ``build_rows`` assembles them."""
    cached = getattr(model, "_engine_rows", None)
    if cached is not None:
        return cached
    ensure_solver_params(model)
    tables = tree_tables(model)
    li_all = np.asarray(tables.hinge_slide_link)
    lim = (np.flatnonzero(np.asarray(model.jnt_limited)[li_all] > 0) if li_all.size
           else np.zeros(0, np.int64))
    la = li_all[lim]
    lim_v = np.asarray(tables.hinge_slide_v)[lim]
    solref = [np.asarray(model.jnt_solref, np.float32)[la]]
    solimp = [np.asarray(model.jnt_solimp, np.float32)[la]]
    invw = [np.asarray(model.dof_invweight0, np.float32)[lim_v]]
    pyr = [np.zeros(len(la), np.float32)]
    mus = [np.zeros(len(la), np.float32)]
    kinds = []
    if model.contact_pairs:
        pair_condim = model.pair_condim or {}
        gcd = (np.asarray(model.geom_condim) if model.geom_condim is not None
               else np.full(model.ngeom, 3, np.int32))
        tor = np.asarray(model.geom_friction_tor, np.float32)
        for kind, tab in pair_groups(model).kinds:
            P = len(tab["gi"]) * points_per_pair(kind)
            gi, gj = _points(tab["gi"], kind, P), _points(tab["gj"], kind, P)
            mu_pt = _points(tab["mu"], kind, P).astype(np.float32)
            condim = [1 if mu_pt[p] == 0.0 else
                      pair_condim.get((a, b), pair_condim.get((b, a), max(gcd[a], gcd[b])))
                      for p, (a, b) in enumerate(zip(gi, gj))]
            mu_tor = np.maximum(tor[gi], tor[gj])
            point, coef = [], []
            for p, c in enumerate(condim):
                m, t = float(mu_pt[p]), float(mu_tor[p])
                rows = ([[1, 0, 0, 0]] if c == 1 else
                        [[1, m, 0, 0], [1, -m, 0, 0], [1, 0, m, 0], [1, 0, -m, 0]]
                        + ([[1, 0, 0, t], [1, 0, 0, -t]] if c >= 4 else []))
                point += [p] * len(rows)
                coef += rows
            point, coef = np.asarray(point, np.int64), np.asarray(coef, np.float32)
            facet = np.asarray([condim[p] != 1 for p in point])
            ref = 0.5 * (np.asarray(model.geom_solref, np.float32)[gi]
                         + np.asarray(model.geom_solref, np.float32)[gj])
            imp = 0.5 * (np.asarray(model.geom_solimp, np.float32)[gi]
                         + np.asarray(model.geom_solimp, np.float32)[gj])
            iw = (np.asarray(model.geom_invweight0, np.float32)[gi]
                  + np.asarray(model.geom_invweight0, np.float32)[gj])
            kinds.append((kind, tab, _KindRows(
                chain=(_chain_mask(model, _points(tab["li"], kind, P))
                       - _chain_mask(model, _points(tab["lj"], kind, P))),
                margin=(np.asarray(model.geom_margin, np.float32)[gi]
                        + np.asarray(model.geom_margin, np.float32)[gj]),
                point=point, coef=coef)))
            solref.append(ref[point])
            solimp.append(imp[point])
            invw.append(iw[point])
            pyr.append(facet.astype(np.float32))
            mus.append(np.where(facet, mu_pt[point], 0.0).astype(np.float32))
    rng = np.asarray(model.jnt_range, np.float32)[la].reshape(-1, 2)
    lim_dof = np.zeros((len(la), model.nv), np.float32)
    lim_dof[np.arange(len(la)), lim_v] = 1.0
    cached = _RowTables(lim_q=np.asarray(tables.hinge_slide_q)[lim].astype(np.int64),
                        lim_lo=rng[:, 0], lim_hi=rng[:, 1], lim_dof=lim_dof, kinds=tuple(kinds),
                        solref=np.concatenate(solref), solimp=np.concatenate(solimp),
                        invw=np.concatenate(invw), pyramidal=np.concatenate(pyr),
                        mu=np.concatenate(mus))
    model._engine_rows = cached
    return cached


def _contact_rows(model: Model, kin: Kinematics, kind: str, tab, kr: _KindRows, poses):
    """One kind's rows: ``J (B, rows, nv)`` and ``pos (B, rows)``;
    ``poses``: ``contact.geom_poses``."""
    from mjrl_tpu_torch.physics.contact import _collide_kind

    dev = kin.pos.device
    depth, n, pts, _, _, _ = _collide_kind(model, kin, kind, tab, poses=poses)
    dist = -depth - const(model, f"rows_margin_{kind}", kr.margin, dev)
    # MuJoCo's contact point is the middle of the penetration, the narrow
    # phase's a surface point
    pts = pts + 0.5 * torch.clamp(depth, min=0.0)[..., None] * n
    t1, t2 = _tangent_frame(model, n)
    # the point's Jacobian on li's chain minus on lj's: the same per-dof
    # velocities at the point, masked by the difference of the two chains;
    # with the rotation about the normal (the relative angular velocity's)
    lin = _point_jacobian(kin, pts, torch.stack([n, t1, t2], dim=2))  # (B, P, 3, nv)
    tor = n @ kin.cdof[..., :3].transpose(1, 2)  # (B, P, nv)
    basis = torch.cat([lin, tor[:, :, None]], dim=2) * const(model, f"rows_chain_{kind}",
                                                              kr.chain, dev)[:, None, :]
    point = const(model, f"rows_point_{kind}", kr.point, dev, torch.int64)
    J = (const(model, f"rows_coef_{kind}", kr.coef, dev)[:, None, :] @ basis[:, point])[:, :, 0]
    return J, dist[:, point]


def build_rows(model: Model, kin: Kinematics, state: PhysicsState) -> Optional[Rows]:
    """Every constraint row of the batch: the limited joints', then each
    contact kind's points' (None if the model has neither)."""
    rt = _row_tables(model)
    dev = state.q.device
    Js, pos = [], []
    if rt.lim_q.size:
        qi = state.q[:, const(model, "rows_lim_q", rt.lim_q, dev, torch.int64)]
        d_lo = qi - const(model, "rows_lim_lo", rt.lim_lo, dev)
        d_hi = const(model, "rows_lim_hi", rt.lim_hi, dev) - qi
        use_lo = d_lo <= d_hi  # the nearer bound
        Js.append(torch.where(use_lo, 1.0, -1.0)[..., None]
                  * const(model, "rows_lim_dof", rt.lim_dof, dev))
        pos.append(torch.where(use_lo, d_lo, d_hi))
    if rt.kinds:
        from mjrl_tpu_torch.physics.contact import geom_poses

        poses = geom_poses(model, kin)
    for kind, tab, kr in rt.kinds:
        J, p = _contact_rows(model, kin, kind, tab, kr, poses)
        Js.append(J)
        pos.append(p)
    if not Js:
        return None
    J, pos = torch.cat(Js, dim=1), torch.cat(pos, dim=1)
    solimp = const(model, "rows_solimp", rt.solimp, dev)
    d = _impedance(solimp, pos)
    k, b = _kb(const(model, "rows_solref", rt.solref, dev), solimp)
    vel = torch.einsum("brv,bv->br", J, state.qd)
    aref = -b * vel - k * d * pos
    R = (1.0 - d) / torch.clamp(d, min=_MINVAL) * const(model, "rows_invw", rt.invw, dev)
    mu = const(model, "rows_mu", rt.mu, dev)
    pyr = const(model, "rows_pyramidal", rt.pyramidal, dev) > 0
    R = torch.where(pyr, R * 2.0 * mu * mu * (1.0 + mu * mu), R)
    D = 1.0 / torch.clamp(R, min=_MINVAL)
    # MuJoCo instantiates a row only inside its margin (pos < 0): an
    # approaching, separated contact must not brake
    return Rows(J=J, aref=aref, D=torch.where(pos < 0.0, D, torch.zeros_like(D)))


def newton_solve(M: torch.Tensor, qdd0: torch.Tensor, rows: Rows, iters: int = 10,
                 alphas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Minimise the primal soft-constraint cost from ``qdd0`` in ``iters``
    Newton iterations, each step scaled by the best of the fixed fractions
    ``_ALPHAS`` (the first on a tie); ``alphas``: those fractions on the
    device already (a copy from pageable host memory waits for the card)."""
    J, aref, D = rows
    nv = qdd0.shape[-1]
    JT = J.transpose(1, 2)
    eye = 1e-8 * torch.eye(nv, dtype=M.dtype, device=M.device)
    if alphas is None:
        alphas = torch.as_tensor(np.asarray(_ALPHAS, np.float32), device=M.device)
    x = qdd0
    for _ in range(iters):
        jar = (J @ x[..., None])[..., 0] - aref
        w = (jar < 0).to(x.dtype) * D
        g = (M @ (x - qdd0)[..., None] + JT @ (w * jar)[..., None])[..., 0]
        H = M + (JT * w[:, None, :]) @ J + eye
        dx = -chol_solve(H, g)
        xs = x[:, None] + alphas[:, None] * dx[:, None]  # (B, alphas, nv)
        jar_a = xs @ JT - aref[:, None]
        dxs = xs - qdd0[:, None]
        cost = 0.5 * torch.sum(dxs * (dxs @ M), dim=-1) + 0.5 * torch.sum(
            (jar_a < 0).to(x.dtype) * D[:, None] * jar_a * jar_a, dim=-1)
        x = x + alphas[torch.argmin(cost, dim=1)][:, None] * dx
    return x


def forward_qacc(model: Model, state: PhysicsState, ctrl: torch.Tensor,
                 f_ext_world: Optional[torch.Tensor] = None, iters: Optional[int] = None,
                 dt: float = 0.0, kin: Optional[Kinematics] = None) -> torch.Tensor:
    """Constrained forward dynamics, ``qacc (B, nv)``. With ``dt == 0``
    the joint damping is explicit and frictionloss is left out, MuJoCo's
    ``mj_forward`` surface (where frictionloss is a constraint row, so a
    model with frictionloss parts from ``d.qacc`` there); with ``dt > 0``
    (integration) ``dt`` times the damping and the frictionloss slope join
    the metric, and the tanh frictionloss force the right-hand side, as in
    the penalty path. ``f_ext_world``: further smooth wrenches (the
    fluid)."""
    ensure_solver_params(model)
    dev = state.q.device
    kin = kin if kin is not None else compute_kinematics(model, state.q, state.qd)
    damping = const(model, "dof_damping", model.dof_damping, dev)
    f_fric, d_fric = friction_terms(model, state.qd) if dt > 0 else (None, None)
    diag = const(model, "dof_armature", model.dof_armature, dev) + dt * damping
    if f_fric is not None:
        diag = diag + dt * d_fric
    M = crba(model, kin) + torch.diag_embed(diag.expand(state.qd.shape))
    C = rnea_bias(model, kin, f_ext_world)
    tau = actuation(model, ctrl, state) + passive_forces_smooth(model, state)
    if model.tendon_Jq is not None:
        tau = tau + tendon_forces(model, state)
    rhs = tau - C - damping * state.qd
    if f_fric is not None:
        rhs = rhs + f_fric
    qdd0 = chol_solve(M, rhs)
    rows = build_rows(model, kin, state)
    if rows is None:
        return qdd0
    if iters is None:
        iters = int(getattr(model, "solver_iters", 10))
    return newton_solve(M, qdd0, rows, iters, const(model, "line_search", _ALPHAS, dev))
