"""Physics model description: kinematic tree, inertia, geoms, actuators.

A numpy-only copy of the port's ``physics/model.py``: the ``Model``
dataclass and the loader of the committed ``.npz`` assets. A ``Model``
holds:

- the EXPANDED kinematic tree: MuJoCo allows several joints per body
  (e.g. the planar locomotion root: slide-x, slide-z, hinge-y); the builder
  expands each such body into a chain of internal "links", one joint each,
  with all inertia/geoms on the last link. Featherstone propagation then
  needs exactly one joint transform per link. Massless intermediate links
  are harmless because every real body carries mass below them.
- per-link static metadata (parent index, joint type, q/v addresses) as
  Python tuples, and numeric fields as numpy arrays. physics/tables.py
  derives the static tables the plain stepper and the CUDA kernel read.

Conventions: quaternions (w, x, y, z); joint axes/anchors constant in the
CHILD link frame (Featherstone's requirement, matches MJCF semantics);
free-joint qpos ``[p(3), quat(4)]``, qvel ``[omega_body(3), v_body(3)]``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


# Joint types
FREE, BALL, HINGE, SLIDE = 0, 1, 2, 3
JOINT_NQ = {FREE: 7, BALL: 4, HINGE: 1, SLIDE: 1}
JOINT_NV = {FREE: 6, BALL: 3, HINGE: 1, SLIDE: 1}

# Geom types
PLANE, SPHERE, CAPSULE, BOX, CYLINDER = 0, 1, 2, 3, 4


@dataclasses.dataclass
class Model:
    """Physics model. Numeric fields are numpy f32 arrays; structural fields
    are Python ints/tuples."""

    # --- tree structure (static) ---
    nlink: int
    nq: int
    nv: int
    nu: int
    ngeom: int
    link_parent: Tuple[int, ...]  # -1 = world
    link_jnt_type: Tuple[int, ...]
    link_qadr: Tuple[int, ...]
    link_vadr: Tuple[int, ...]
    # --- link frames & joints (numeric) ---
    link_pos: np.ndarray  # (nlink, 3) fixed offset from parent link frame
    link_quat: np.ndarray  # (nlink, 4)
    jnt_axis: np.ndarray  # (nlink, 3) in child frame
    jnt_anchor: np.ndarray  # (nlink, 3) in child frame
    jnt_range: np.ndarray  # (nlink, 2)
    jnt_limited: np.ndarray  # (nlink,) 0/1
    jnt_ref: np.ndarray  # (nlink,) reference pose: displacement = q - ref
    jnt_stiffness: np.ndarray  # (nlink,)
    jnt_springref: np.ndarray  # (nlink,)
    # --- per-dof (numeric) ---
    dof_damping: np.ndarray  # (nv,)
    dof_armature: np.ndarray  # (nv,)
    # --- inertia (numeric, per link, about link frame) ---
    link_mass: np.ndarray  # (nlink,)
    link_com: np.ndarray  # (nlink, 3)
    link_inertia_com: np.ndarray  # (nlink, 3, 3) about com, link frame
    # --- actuators (numeric) ---
    act_vadr: np.ndarray  # (nu,) target dof address
    act_gear: np.ndarray  # (nu,)
    act_ctrlrange: np.ndarray  # (nu, 2)
    act_ctrllimited: np.ndarray  # (nu,)
    # --- geoms (numeric + static type/body) ---
    geom_link: Tuple[int, ...]  # -1 = world/static
    geom_type: Tuple[int, ...]
    geom_size: np.ndarray  # (ngeom, 3)
    geom_pos: np.ndarray  # (ngeom, 3) in link frame
    geom_quat: np.ndarray  # (ngeom, 4)
    geom_friction: np.ndarray  # (ngeom,) sliding friction coef
    # --- contact pairs (static list of geom index pairs) ---
    contact_pairs: Tuple[Tuple[int, int], ...]
    # --- fluid model (precomputed equivalent inertia boxes) ---
    link_ibox: Optional[np.ndarray] = None  # (nlink, 3) half-sizes
    link_iquat: Optional[np.ndarray] = None  # (nlink, 4) link->principal
    # --- affine actuator gain/bias (MuJoCo <general>/<position> servos):
    # force = gainprm[0]*ctrl + b0 + b1*(gear*q) + b2*(gear*qd); tau = gear*force.
    # None => pure torque motors (force = ctrl), the pre-existing behavior.
    act_gainprm: Optional[np.ndarray] = None  # (nu, 3)
    act_biasprm: Optional[np.ndarray] = None  # (nu, 3)
    act_qadr: Optional[np.ndarray] = None  # (nu,) qpos address of target joint
    # --- fixed tendons (linear joint couplings; MuJoCo <tendon><fixed>):
    # length = Jq @ qpos, velocity = Jv @ qvel, tau += Jv^T * f(length, vel)
    tendon_Jq: Optional[np.ndarray] = None  # (ntendon, nq)
    tendon_Jv: Optional[np.ndarray] = None  # (ntendon, nv)
    tendon_range: Optional[np.ndarray] = None  # (ntendon, 2)
    tendon_limited: Optional[np.ndarray] = None  # (ntendon,) 0/1
    tendon_stiffness: Optional[np.ndarray] = None  # (ntendon,)
    tendon_damping: Optional[np.ndarray] = None  # (ntendon,)
    tendon_springlength: Optional[np.ndarray] = None  # (ntendon,)
    # --- sites (world-pose markers used by task observations/rewards) ---
    site_link: Tuple[int, ...] = ()  # -1 = world-static
    site_pos: Optional[np.ndarray] = None  # (nsite, 3) in link frame
    site_quat: Optional[np.ndarray] = None  # (nsite, 4)
    site_name: Tuple[str, ...] = ()
    # --- per-pair sliding-friction overrides (MuJoCo explicit <pair>
    # elements / condim=1 frictionless pairs): {(gi, gj): mu} ---
    pair_mu: Optional[Dict[Tuple[int, int], float]] = None
    # --- per-dof / per-tendon limit-penalty gains. The scalar
    # limit_stiffness/damping are fine for ~kg-scale locomotion links, but a
    # dexterous hand mixes 4 kg arm dofs with 1e-5 kg m^2 fingertip dofs: a
    # shared spring constant is either mush for the arm or violently
    # unstable for the fingers. When set (see ``scale_limit_penalties``),
    # k_j = omega^2 * M_jj(qpos0) gives every joint the same limit-response
    # frequency. ---
    dof_limit_stiffness: Optional[np.ndarray] = None  # (nv,)
    dof_limit_damping: Optional[np.ndarray] = None  # (nv,)
    tendon_limit_stiffness: Optional[np.ndarray] = None  # (ntendon,)
    tendon_limit_damping: Optional[np.ndarray] = None  # (ntendon,)
    # --- soft-constraint solver parameters (MuJoCo solref/solimp model;
    # used by physics/csolve.py when constraint_solver == "newton").
    # None => MuJoCo defaults filled in lazily. invweight0 arrays are the
    # diagonal task-space inverse inertia at qpos0 (verified == MuJoCo's
    # dof_invweight0 / body_invweight0[:, 0]). ---
    jnt_solref: Optional[np.ndarray] = None  # (nlink, 2)
    jnt_solimp: Optional[np.ndarray] = None  # (nlink, 5)
    geom_solref: Optional[np.ndarray] = None  # (ngeom, 2)
    geom_solimp: Optional[np.ndarray] = None  # (ngeom, 5)
    geom_margin: Optional[np.ndarray] = None  # (ngeom,)
    geom_condim: Optional[np.ndarray] = None  # (ngeom,) contact dim 1/3
    dof_invweight0: Optional[np.ndarray] = None  # (nv,)
    geom_invweight0: Optional[np.ndarray] = None  # (ngeom,) owning-body trn
    pair_condim: Optional[Dict[Tuple[int, int], int]] = None
    geom_friction_tor: Optional[np.ndarray] = None  # (ngeom,) torsional mu
    constraint_solver: str = "penalty"  # 'penalty' | 'newton'
    # Newton iterations for constraint_solver == 'newton'. MuJoCo's solver
    # terminates early on convergence (usually < 5 iters); with fixed-shape
    # iteration the count trades throughput for tail accuracy.
    solver_iters: int = 10
    # --- options ---
    dt: float = 0.002
    # physics substeps per dt — penalty contacts need dt_sub small enough
    # that sqrt(k/m_min) < 2/dt_sub for the lightest contacting link
    # (envs with coarse timesteps + light limbs, e.g. ant, set this > 1)
    n_substeps: int = 1
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    density: float = 0.0  # medium density (fluid drag); MuJoCo <option density>
    viscosity: float = 0.0  # medium viscosity; MuJoCo <option viscosity>
    # contact penalty parameters (engine-specific; see physics/contact.py)
    contact_stiffness: float = 10_000.0
    contact_damping: float = 100.0
    contact_depth_cap: float = 0.02  # clamp spring term: k * min(depth, cap)
    # Normal-force ceiling, as a multiple of the saturated spring force
    # k*cap. The damping term k_d*v_n is unbounded in approach speed; with
    # dt*k_d/m > 2 for a light link the explicit contact force is
    # explosively unstable (one fast deep impact -> inf in ~15 substeps).
    # MuJoCo's constraint solver bounds contact impulses; this cap is the
    # penalty-model analogue. <= 0 disables.
    contact_force_cap_ratio: float = 4.0
    friction_vel: float = 0.1
    # Per-dof dry friction (MuJoCo dof_frictionloss — what holds e.g. the
    # hammer task's nail in its board: frictionloss=2.5 N, reference
    # adroit_hammer.xml). MuJoCo implements it as constraint-solver rows;
    # here it is a regularized passive force f = -fl*tanh(qd/v_eps) whose
    # Jacobian fl/v_eps*sech^2 is folded into the semi-implicit diagonal
    # (same treatment both engine and SoA paths, so parity holds; the
    # tanh regularization means slow creep under sub-threshold load is the
    # documented divergence from MuJoCo's exact stiction). None = zeros,
    # and every apply site skips the term entirely (HLO unchanged for
    # frictionless models — locomotion programs stay cache-identical).
    dof_frictionloss: Optional[np.ndarray] = None  # (nv,)
    dof_friction_vel: float = 0.01
    limit_stiffness: float = 500.0
    limit_damping: float = 10.0
    # name maps for introspection / env reward code
    link_name: Tuple[str, ...] = ()
    jnt_name: Tuple[str, ...] = ()  # per link; "" when jointless/unnamed
    qpos0: Optional[np.ndarray] = None  # reference configuration

    @property
    def default_qpos(self) -> np.ndarray:
        if self.qpos0 is not None:
            return self.qpos0
        q = np.zeros(self.nq, np.float32)
        for i in range(self.nlink):
            t = self.link_jnt_type[i]
            if t in (FREE, BALL):
                q[self.link_qadr[i] + (3 if t == FREE else 0)] = 1.0  # unit quat
        return q


def load_model_npz(path: str) -> Model:
    """A ``Model`` from the arrays the port's ``save_model_npz`` stores (and
    ``tools/gen_adroit_model.py``, the same format): one entry per set
    field, the geom-pair dicts as ``<name>__keys`` and ``<name>__values``.
    Tuples, ints, floats and strings come back as the dataclass declares
    them."""
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    kw = {}
    for f in dataclasses.fields(Model):
        if f"{f.name}__keys" in data:
            keys, vals = data[f"{f.name}__keys"], data[f"{f.name}__values"]
            kw[f.name] = {(int(a), int(b)): v.item() for (a, b), v in zip(keys, vals)}
        elif f.name in data:
            v = data[f.name]
            if f.type.startswith("Tuple[str"):
                kw[f.name] = tuple(str(s) for s in v)
            elif f.type.startswith("Tuple[Tuple[int"):
                kw[f.name] = tuple((int(a), int(b)) for a, b in v.reshape(-1, 2))
            elif f.type.startswith("Tuple[int"):
                kw[f.name] = tuple(int(s) for s in v)
            elif f.type.startswith("Tuple[float"):
                kw[f.name] = tuple(float(s) for s in v)
            elif f.type == "int":
                kw[f.name] = int(v)
            elif f.type == "float":
                kw[f.name] = float(v)
            elif f.type == "str":
                kw[f.name] = str(v)
            else:
                kw[f.name] = v
    return Model(**kw)
