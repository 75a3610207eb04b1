"""Plain PyTorch batch-last Newton soft-constraint solve: kernels K2's and
K4's reference.

Twin of ``mjrl_tpu/physics/soa_newton.py:44-330,338-514`` on its held-rows
path. Contacts and joint limits are one-sided soft constraints with
MuJoCo's solref/solimp semantics, and ``constrained_qdd`` minimizes the
primal cost

    1/2 (x - qdd0)^T M (x - qdd0) + 1/2 sum_r active_r D_r (J_r x - aref_r)^2

over the accelerations ``x`` with ``model.solver_iters`` Newton steps, each
safeguarded by the exact search over the fractions ``_ALPHAS``, evaluated
in closed form. Every per-env scalar is a ``(1, B)`` row; a contact's 4
(condim 3) or 6 (condim 4) pyramid facets share one ``(k, B)`` row set,
whose J maps each dof of the contact's chain to a ``(k, B)`` tensor.
All solver parameters are static per row and enter as f32 literals.

Rows are built only for the contact candidates inside their margin in
some env of the batch (``_in_margin_somewhere``): a row outside it in
every env has D = 0 there and adds exactly nothing, so dropping it is
exact, as the reference's ``prune_to_active_pairs`` argues, and Adroit's
406-760 candidates shrink to the few the batch touches.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gpubench.reference.physics.csolve import ensure_solver_params
from gpubench.reference.physics.model import Model
from gpubench.reference.physics.tables import tree_tables

_MINVAL = 1e-10
_ALPHAS = (1.0, 0.5, 0.25, 0.0625, 0.0)  # the safeguarded step fractions


class _Row(NamedTuple):
    J: Dict[int, torch.Tensor]  # dof -> (k, B)
    aref: torch.Tensor  # (k, B)
    D: torch.Tensor  # (1, B); 0 where the row is out of margin (pos >= 0)


def _f32(x) -> float:
    return float(np.float32(x))


def _impedance_static(solimp, pos: torch.Tensor) -> torch.Tensor:
    """MuJoCo's impedance spline d(|pos| / width) with static solimp."""
    dmin, dmax, width, mid, power = (float(v) for v in solimp)
    x = torch.abs(pos) / _f32(max(width, _MINVAL))
    if power == 2.0:
        xp = x * x
        rp = torch.clamp(1.0 - x, min=0.0)
        rpp = rp * rp
    else:
        xp = torch.pow(x, _f32(power))
        rpp = torch.pow(torch.clamp(1.0 - x, min=0.0), _f32(power))
    a = _f32(1.0 / mid ** (power - 1.0)) * xp
    b = 1.0 - _f32(1.0 / (1.0 - mid) ** (power - 1.0)) * rpp
    y = torch.where(x < _f32(mid), a, b)
    d = torch.clamp(_f32(dmin) + y * _f32(dmax - dmin), _f32(dmin), _f32(dmax))
    return torch.where(x >= 1.0, torch.full_like(d, _f32(dmax)), d)


def _kb_static(solref, solimp) -> Tuple[float, float]:
    """Stiffness and damping of the reference acceleration from solref."""
    tc, dr = float(solref[0]), float(solref[1])
    dmax = float(solimp[1])
    k = 1.0 / max(dmax * dmax * tc * tc * dr * dr, _MINVAL)
    b = 2.0 / max(dmax * tc, _MINVAL)
    if tc < 0:
        k = -tc
    if dr < 0:
        b = -dr
    return k, b


def _chain(model: Model, link: int) -> List[int]:
    """The dofs on the kinematic chain of ``link``, ascending (world: [])."""
    if link < 0:
        return []
    return [int(j) for j in np.flatnonzero(tree_tables(model).L_mask[link])]


def pyramid_scale(mu: float) -> float:
    """The pyramidal cone's R factor ``2 mu^2 (1 + mu^2)``."""
    return 2.0 * mu * mu * (1.0 + mu * mu)


def _finish_row(J, pos, vel, solref, solimp, invw: float, mu: float, pyramidal: bool) -> _Row:
    d = _impedance_static(solimp, pos)
    k, b = _kb_static(solref, solimp)
    aref = -_f32(b) * vel - _f32(k) * d * pos
    R = (1.0 - d) / torch.clamp(d, min=_MINVAL) * _f32(max(invw, 0.0))
    if pyramidal:
        R = R * _f32(pyramid_scale(mu))
    D = 1.0 / torch.clamp(R, min=_MINVAL)
    # a row exists only inside the margin (pos < 0)
    D = torch.where(pos < 0.0, D, torch.zeros_like(D))
    return _Row(J=J, aref=aref, D=D)


def _limit_rows(model: Model, q: torch.Tensor, qd: torch.Tensor) -> List[_Row]:
    """One row per limited hinge or slide joint, against its nearer bound."""
    tables = tree_tables(model)
    rows: List[_Row] = []
    for link, qadr, vadr in zip(tables.hinge_slide_link, tables.hinge_slide_q,
                                tables.hinge_slide_v):
        link, qadr, vadr = int(link), int(qadr), int(vadr)
        if model.jnt_limited[link] <= 0:
            continue
        lo, hi = model.jnt_range[link]
        qi = q[qadr : qadr + 1]
        d_lo = qi - _f32(lo)
        d_hi = _f32(hi) - qi
        use_lo = d_lo <= d_hi
        dist = torch.where(use_lo, d_lo, d_hi)
        sign = torch.where(use_lo, torch.ones_like(qi), -torch.ones_like(qi))
        vel = sign * qd[vadr : vadr + 1]
        rows.append(_finish_row({vadr: sign}, dist, vel, model.jnt_solref[link],
                                model.jnt_solimp[link], float(model.dof_invweight0[vadr]),
                                0.0, pyramidal=False))
    return rows


def _point_jac(model: Model, cdof, link: int, r) -> Dict[int, torch.Tensor]:
    """dof -> (3, B) world point-Jacobian column for the point origin + r."""
    from gpubench.reference.physics.soa import _cross

    return {j: cdof[j][3:6] + _cross(cdof[j][0:3], r) for j in _chain(model, link)}


def contact_params(model: Model, gi: int, gj: int, mu: float
                   ) -> Tuple[np.ndarray, np.ndarray, float, float, int]:
    """A geom pair's static row constants: (solref, solimp, margin,
    invweight, condim), mixed over the pair as the reference mixes them."""
    gcd = (model.geom_condim if model.geom_condim is not None
           else np.full(model.ngeom, 3, np.int32))
    pair_condim = model.pair_condim or {}
    solref = 0.5 * (model.geom_solref[gi] + model.geom_solref[gj])
    solimp = 0.5 * (model.geom_solimp[gi] + model.geom_solimp[gj])
    margin = float(model.geom_margin[gi] + model.geom_margin[gj])
    invw = float(model.geom_invweight0[gi] + model.geom_invweight0[gj])
    condim = 1 if mu == 0.0 else pair_condim.get(
        (gi, gj), pair_condim.get((gj, gi), int(max(gcd[gi], gcd[gj]))))
    return solref, solimp, margin, invw, condim


def _contact_rows(model: Model, pos, cdof, qd, candidates) -> List[_Row]:
    from gpubench.reference.physics.soa import _cross, _dot

    tor = np.asarray(model.geom_friction_tor)
    origin = pos[0]
    rows: List[_Row] = []
    for cand in candidates:
        li, lj, mu = cand.li, cand.lj, cand.mu
        solref, solimp, margin, invw, condim = contact_params(model, cand.gi, cand.gj, mu)
        n = cand.n
        dist = -cand.depth - _f32(margin)
        # the midpoint of the penetration interval
        pt = cand.pt + 0.5 * torch.clamp(cand.depth, min=0.0) * n
        r = pt - origin
        Ji = _point_jac(model, cdof, li, r)
        Jj = _point_jac(model, cdof, lj, r)
        dofs = sorted(set(Ji) | set(Jj))
        Jrel = {}
        for j in dofs:
            a, b = Ji.get(j), Jj.get(j)
            Jrel[j] = a - b if (a is not None and b is not None) else (a if a is not None else -b)
        Jn = {j: _dot(n, Jrel[j]) for j in dofs}
        if condim == 1:
            vel = None
            for j in dofs:
                t = Jn[j] * qd[j : j + 1]
                vel = t if vel is None else vel + t
            if vel is None:
                vel = torch.zeros_like(dist)
            rows.append(_finish_row(Jn, dist, vel, solref, solimp, invw, 0.0, pyramidal=False))
            continue
        # tangent frame from the normal
        near_z = torch.abs(n[2:3]) < 0.99
        one, zero = torch.ones_like(n[0:1]), torch.zeros_like(n[0:1])
        ref = torch.cat([torch.where(near_z, zero, one), zero, torch.where(near_z, one, zero)], dim=0)
        t1 = _cross(ref, n)
        t1 = t1 * torch.rsqrt(_dot(t1, t1) + 1e-12)
        t2 = _cross(n, t1)
        Jt1 = {j: _dot(t1, Jrel[j]) for j in dofs}
        Jt2 = {j: _dot(t2, Jrel[j]) for j in dofs}
        mu_f = _f32(mu)
        per_dof = {
            j: [Jn[j] + mu_f * Jt1[j], Jn[j] - mu_f * Jt1[j],
                Jn[j] + mu_f * Jt2[j], Jn[j] - mu_f * Jt2[j]]
            for j in dofs
        }
        if condim >= 4:
            # torsional facets: relative angular rate about the normal
            mu_tor = _f32(max(tor[cand.gi], tor[cand.gj]))
            ci, cj = _chain(model, li), _chain(model, lj)
            for j in dofs:
                w = None
                if j in ci:
                    w = cdof[j][0:3]
                if j in cj:
                    w = -cdof[j][0:3] if w is None else w - cdof[j][0:3]
                jt = _dot(n, w) if w is not None else None
                per_dof[j] += ([Jn[j] + mu_tor * jt, Jn[j] - mu_tor * jt]
                               if jt is not None else [Jn[j], Jn[j]])
        Jp = {j: torch.cat(parts, dim=0) for j, parts in per_dof.items()}
        vel = None
        for j in dofs:
            t = Jp[j] * qd[j : j + 1]
            vel = t if vel is None else vel + t
        rows.append(_finish_row(Jp, dist, vel, solref, solimp, invw, mu, pyramidal=True))
    return rows


def _in_margin_somewhere(model: Model, candidates) -> list:
    """The candidates whose row is inside its margin (``pos < 0``) or
    non-finite in some env: every other one has D = 0 in every env. One
    read of a ``(n, 1)`` mask from the device per substep."""
    if not candidates:
        return candidates
    margin = [_f32(contact_params(model, c.gi, c.gj, c.mu)[2]) for c in candidates]
    depth = torch.cat([c.depth for c in candidates])
    m = torch.tensor(margin, dtype=depth.dtype, device=depth.device)[:, None]
    keep = (~(-depth - m >= 0.0)).any(dim=1).tolist()
    return [c for c, k in zip(candidates, keep) if k]


def _sum0(a: torch.Tensor) -> torch.Tensor:
    """A packed ``(k, B)`` row set's contribution as one ``(1, B)`` row."""
    return a if a.shape[0] == 1 else torch.sum(a, dim=0, keepdim=True)


def _chol_solve_rows(H, g: List[torch.Tensor], nv: int) -> List[torch.Tensor]:
    """Solve ``H x = g`` by dense Cholesky; H is a 2D list of (1, B) rows
    (lower triangle read; None = structural zero)."""
    L = [[None] * nv for _ in range(nv)]
    dinv: List[Optional[torch.Tensor]] = [None] * nv
    for j in range(nv):
        s = H[j][j]
        for k in range(j):
            if L[j][k] is not None:
                s = s - L[j][k] * L[j][k]
        inv = torch.rsqrt(torch.clamp(s, min=_MINVAL))
        dinv[j] = inv
        for i in range(j + 1, nv):
            t = H[i][j]
            for k in range(j):
                if L[i][k] is not None and L[j][k] is not None:
                    t = (t if t is not None else 0.0) - L[i][k] * L[j][k]
            if t is not None:
                L[i][j] = t * inv
    y: List[torch.Tensor] = [None] * nv
    for i in range(nv):
        s = g[i]
        for k in range(i):
            if L[i][k] is not None:
                s = s - L[i][k] * y[k]
        y[i] = s * dinv[i]
    x: List[torch.Tensor] = [None] * nv
    for i in reversed(range(nv)):
        s = y[i]
        for k in range(i + 1, nv):
            if L[k][i] is not None:
                s = s - L[k][i] * x[k]
        x[i] = s * dinv[i]
    return x


def constrained_qdd(model: Model, pos, cdof, M: Dict[Tuple[int, int], torch.Tensor],
                    q: torch.Tensor, qd: torch.Tensor, qdd0: torch.Tensor, candidates,
                    dt: float, fric_diag: Optional[list] = None,
                    picks: Optional[list] = None, costs: Optional[list] = None,
                    replay: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Newton solve of the primal soft-constraint problem, batch-last.

    ``M`` is the sparse mass matrix of soa._mass_matrix_sparse; the metric
    adds armature + dt * damping on its diagonal, and ``fric_diag`` (a
    per-dof list of dt-scaled ``(1, B)`` frictionloss rows, or None) after
    it. ``qdd0`` is the unconstrained acceleration (nv, B). The rows are
    built once from the substep's entry state and held across the
    ``model.solver_iters`` iterations (no early exit). ``picks``, when a
    list, receives each iteration's chosen fraction as an index into
    ``_ALPHAS`` (int (1, B)), and ``costs`` each iteration's cost at the
    five fractions ((5, B)). ``replay``, an int (solver_iters, B) tensor of
    fraction indices (a kernel's ``picks``), makes iteration i step by
    ``_ALPHAS[replay[i]]`` instead of its own pick, in each env where it
    is not negative; ``picks`` still receives the solve's own picks.
    """
    ensure_solver_params(model)
    nv = model.nv
    rows = _limit_rows(model, q, qd) + _contact_rows(
        model, pos, cdof, qd, _in_margin_somewhere(model, candidates))
    if not rows:
        return qdd0
    extra = np.asarray(model.dof_armature, np.float32) + np.float32(dt) * np.asarray(
        model.dof_damping, np.float32)
    Mfull = [[None] * nv for _ in range(nv)]
    for (i, j), v in M.items():
        Mfull[i][j] = v
    for k in range(nv):
        if extra[k] != 0.0:
            Mfull[k][k] = Mfull[k][k] + float(extra[k])
        if fric_diag is not None and fric_diag[k] is not None:
            Mfull[k][k] = Mfull[k][k] + fric_diag[k]

    def mat_vec(xs: List[torch.Tensor]) -> List[torch.Tensor]:
        out: List[Optional[torch.Tensor]] = [None] * nv
        for i in range(nv):
            for j in range(i + 1):
                mij = Mfull[i][j]
                if mij is None:
                    continue
                t = mij * xs[j]
                out[i] = t if out[i] is None else out[i] + t
                if i != j:
                    t = mij * xs[i]
                    out[j] = t if out[j] is None else out[j] + t
        zero = torch.zeros_like(xs[0])
        return [o if o is not None else zero for o in out]

    x = qdd0
    if replay is not None:
        alphas = torch.tensor(_ALPHAS, dtype=qdd0.dtype, device=qdd0.device)
    for it in range(int(model.solver_iters)):
        xs = [x[j : j + 1] for j in range(nv)]
        d0 = [xs[j] - qdd0[j : j + 1] for j in range(nv)]
        Md0 = mat_vec(d0)
        # residuals and active weights per row
        jar, w = [], []
        for row in rows:
            s = None
            for j, Jj in row.J.items():
                t = Jj * xs[j]
                s = t if s is None else s + t
            jr = (s if s is not None else 0.0) - row.aref
            jar.append(jr)
            w.append(torch.where(jr < 0.0, row.D, torch.zeros_like(jr)))
        # gradient M d0 + J^T (w jar)
        g = list(Md0)
        for r, row in enumerate(rows):
            wj = w[r] * jar[r]
            for j, Jj in row.J.items():
                g[j] = g[j] + _sum0(Jj * wj)
        # Hessian M + J^T diag(w) J + 1e-8 I (lower triangle)
        H = [[Mfull[i][j] for j in range(nv)] for i in range(nv)]
        for r, row in enumerate(rows):
            dofs = sorted(row.J)
            for a_i, i in enumerate(dofs):
                wJi = w[r] * row.J[i]
                for j in dofs[: a_i + 1]:
                    t = _sum0(wJi * row.J[j])
                    H[i][j] = t if H[i][j] is None else H[i][j] + t
        for k in range(nv):
            H[k][k] = (H[k][k] + _f32(1e-8) if H[k][k] is not None
                       else torch.full_like(xs[0], _f32(1e-8)))
        dx = [-v for v in _chol_solve_rows(H, g, nv)]
        # exact line search along x + a dx; the smooth term in closed form,
        # 1/2 (d0 + a dx)^T M (d0 + a dx) = 1/2 (c0 + 2 a c1 + a^2 c2)
        Mdx = mat_vec(dx)
        c0 = c1 = c2 = None
        for j in range(nv):
            t0, t1, t2 = d0[j] * Md0[j], d0[j] * Mdx[j], dx[j] * Mdx[j]
            c0 = t0 if c0 is None else c0 + t0
            c1 = t1 if c1 is None else c1 + t1
            c2 = t2 if c2 is None else c2 + t2
        jd = []
        for row in rows:
            s = None
            for j, Jj in row.J.items():
                t = Jj * dx[j]
                s = t if s is None else s + t
            jd.append(s if s is not None else torch.zeros_like(row.aref))

        def cost(a: float):
            c = 0.5 * (c0 + (2.0 * a) * c1 + (a * a) * c2)
            for r, row in enumerate(rows):
                ja = jar[r] + _f32(a) * jd[r]
                c = c + _sum0(0.5 * torch.where(ja < 0.0, row.D, torch.zeros_like(ja)) * ja * ja)
            return c

        all_c = [cost(a) for a in _ALPHAS]
        best_c = all_c[0]
        best_a = torch.full_like(best_c, _ALPHAS[0])
        best_k = torch.zeros(best_c.shape, dtype=torch.int32, device=best_c.device)
        for k, a in enumerate(_ALPHAS[1:], start=1):
            ca = all_c[k]
            pick = ca < best_c
            best_c = torch.where(pick, ca, best_c)
            best_a = torch.where(pick, torch.full_like(best_a, a), best_a)
            best_k = torch.where(pick, torch.full_like(best_k, k), best_k)
        if picks is not None:
            picks.append(best_k)
        if costs is not None:
            costs.append(torch.cat(all_c))
        if replay is not None:
            given = replay[it : it + 1].to(qdd0.device).long()
            best_a = torch.where(given >= 0, alphas[given.clamp(min=0)], best_a)
        x = x + best_a * torch.cat(dx, dim=0)
    return x
