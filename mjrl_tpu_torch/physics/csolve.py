"""Soft-constraint solver parameters: MuJoCo defaults and invweight0.

Twin of ``ensure_solver_params``, ``_compute_invweights`` and ``_rot_np``
(``mjrl_tpu/physics/csolve.py:55-140``), numpy only. The Newton rows
(physics/soa_newton.py and kernel K2) read solref, solimp, margin,
torsional friction and the invweights from the model; this fills what the
MJCF left unset, once, at load time:

- ``dof_invweight0 = diag(M^-1)`` at qpos0, with M the joint-space mass
  matrix plus armature;
- ``geom_invweight0 = tr(Jp M^-1 Jp^T) / 3`` with Jp the point Jacobian of
  the owning link's centre of mass (0 for world geoms).

M comes from the port's own plain mass matrix (physics/soa.py) in f32 and
is inverted in float64, as the reference inverts its f32 ``crba``.
"""

from __future__ import annotations

import numpy as np

from mjrl_tpu_torch.physics.model import Model
from mjrl_tpu_torch.physics.tables import tree_tables

_DEF_SOLREF = np.array([0.02, 1.0], np.float32)
_DEF_SOLIMP = np.array([0.9, 0.95, 0.001, 0.5, 2.0], np.float32)


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
