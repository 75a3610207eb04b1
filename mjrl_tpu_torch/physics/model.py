"""Physics model description: kinematic tree, inertia, geoms, actuators.

A numpy-only twin of ``mjrl_tpu/physics/model.py``, so the PyTorch port loads
models without JAX. A ``Model`` is built either programmatically
(:class:`ModelBuilder`) or from an MJCF subset (physics/mjcf.py) and holds:

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
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

def _mat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix (columns = frame axes) -> quaternion (w, x, y, z)."""
    t = np.trace(R)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        return np.array(
            [0.25 / s, (R[2, 1] - R[1, 2]) * s, (R[0, 2] - R[2, 0]) * s,
             (R[1, 0] - R[0, 1]) * s]
        )
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * np.sqrt(max(1e-12, 1.0 + R[i, i] - R[j, j] - R[k, k]))
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


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


class ModelBuilder:
    """Programmatic model construction (the MJCF loader drives this too)."""

    def __init__(
        self,
        dt: float = 0.002,
        gravity: Sequence[float] = (0.0, 0.0, -9.81),
    ):
        self.dt = dt
        self.gravity = tuple(gravity)
        self._links: List[Dict] = []
        self._geoms: List[Dict] = []
        self._acts: List[Dict] = []
        self._name_to_link: Dict[str, int] = {}
        self._qpos0: List[float] = []
        self.options: Dict[str, float] = {}

    # -- bodies --------------------------------------------------------------
    def add_body(
        self,
        name: str,
        parent: Optional[str] = None,
        pos=(0, 0, 0),
        quat=(1, 0, 0, 0),
        joints: Sequence[Dict] = (),
        mass: float = 0.0,
        com=(0, 0, 0),
        inertia_com=None,
    ) -> str:
        """Add a body with 0+ joints; expands to one link per joint (or a
        jointless fixed link)."""
        parent_idx = -1 if parent is None else self._name_to_link[parent]
        joints = list(joints)
        if not joints:
            joints = [dict(type=None)]
        for k, j in enumerate(joints):
            last = k == len(joints) - 1
            link = dict(
                parent=parent_idx,
                pos=np.asarray(pos if k == 0 else (0, 0, 0), np.float32),
                quat=np.asarray(quat if k == 0 else (1, 0, 0, 0), np.float32),
                jnt_type=j.get("type"),
                jnt_axis=np.asarray(j.get("axis", (0, 0, 1)), np.float32),
                jnt_anchor=np.asarray(j.get("pos", (0, 0, 0)), np.float32),
                jnt_range=np.asarray(j.get("range", (0, 0)), np.float32),
                jnt_limited=float(j.get("limited", False)),
                damping=float(j.get("damping", 0.0)),
                frictionloss=float(j.get("frictionloss", 0.0)),
                armature=float(j.get("armature", 0.0)),
                stiffness=float(j.get("stiffness", 0.0)),
                springref=float(j.get("springref", 0.0)),
                mass=float(mass) if last else 0.0,
                com=np.asarray(com, np.float32) if last else np.zeros(3, np.float32),
                inertia_com=(
                    np.asarray(
                        inertia_com if inertia_com is not None else np.zeros((3, 3)),
                        np.float32,
                    )
                    if last
                    else np.zeros((3, 3), np.float32)
                ),
                name=name if last else f"{name}__stage{k}",
                ref=float(j.get("ref", 0.0)),
            )
            self._links.append(link)
            parent_idx = len(self._links) - 1
        self._name_to_link[name] = parent_idx
        return name

    # -- geoms ---------------------------------------------------------------
    def add_geom(
        self,
        body: Optional[str],
        gtype: int,
        size=(0, 0, 0),
        pos=(0, 0, 0),
        quat=(1, 0, 0, 0),
        friction: float = 1.0,
    ) -> int:
        self._geoms.append(
            dict(
                link=-1 if body is None else self._name_to_link[body],
                type=gtype,
                size=np.asarray(size, np.float32),
                pos=np.asarray(pos, np.float32),
                quat=np.asarray(quat, np.float32),
                friction=float(friction),
            )
        )
        return len(self._geoms) - 1

    # -- actuators -----------------------------------------------------------
    def add_motor(
        self, body: str, gear: float = 1.0, ctrlrange=None
    ) -> None:
        """Torque motor on the (single) joint dof of ``body``'s last link."""
        self.add_motor_link(self._name_to_link[body], gear, ctrlrange)

    def add_motor_link(self, link: int, gear: float = 1.0, ctrlrange=None) -> None:
        """Torque motor addressed by expanded-link index (MJCF loader path,
        where actuators target joints by name)."""
        self._acts.append(
            dict(
                link=link,
                gear=float(gear),
                ctrlrange=np.asarray(
                    ctrlrange if ctrlrange is not None else (0, 0), np.float32
                ),
                ctrllimited=float(ctrlrange is not None),
            )
        )

    # -- finalize ------------------------------------------------------------
    def finalize(
        self,
        contact_pairs: str = "ground",
        explicit_pairs: Optional[Sequence[Tuple[int, int]]] = None,
    ) -> Model:
        """``contact_pairs``: 'ground' pairs every non-plane geom with every
        plane geom; 'all' also pairs movable geoms with each other (except
        same-link and parent-child); 'none' disables contacts.
        ``explicit_pairs`` overrides with a precomputed geom-pair list (the
        MJCF loader computes MuJoCo's contype/conaffinity filtering)."""
        n = len(self._links)
        qadr, vadr = [], []
        nq = nv = 0
        jnt_types = []
        for l in self._links:
            t = l["jnt_type"]
            qadr.append(nq)
            vadr.append(nv)
            if t is not None:
                jnt_types.append(t)
                nq += JOINT_NQ[t]
                nv += JOINT_NV[t]
            else:
                jnt_types.append(-1)

        dof_damping = np.zeros(nv, np.float32)
        dof_armature = np.zeros(nv, np.float32)
        dof_frictionloss = np.zeros(nv, np.float32)
        qpos0 = np.zeros(nq, np.float32)
        for i, l in enumerate(self._links):
            t = l["jnt_type"]
            if t is None:
                continue
            d = JOINT_NV[t]
            dof_damping[vadr[i] : vadr[i] + d] = l["damping"]
            dof_armature[vadr[i] : vadr[i] + d] = l["armature"]
            dof_frictionloss[vadr[i] : vadr[i] + d] = l.get("frictionloss", 0.0)
            if t == FREE:
                qpos0[qadr[i] + 3] = 1.0
            elif t == BALL:
                qpos0[qadr[i]] = 1.0
            else:
                qpos0[qadr[i]] = l["ref"]

        acts = self._acts
        act_vadr = np.asarray([vadr[a["link"]] for a in acts], np.int32)

        geoms = self._geoms
        pairs: List[Tuple[int, int]] = []
        if explicit_pairs is not None:
            pairs = [tuple(p) for p in explicit_pairs]
        elif contact_pairs != "none":
            for i, gi in enumerate(geoms):
                for j, gj in enumerate(geoms):
                    if j <= i:
                        continue
                    static_i = gi["type"] == PLANE or gi["link"] < 0
                    static_j = gj["type"] == PLANE or gj["link"] < 0
                    if static_i and static_j:
                        continue
                    if gi["link"] == gj["link"]:
                        continue
                    if contact_pairs == "ground" and not (static_i or static_j):
                        continue
                    li, lj = gi["link"], gj["link"]
                    if li >= 0 and lj >= 0:
                        # skip parent-child adjacent links (MuJoCo default)
                        if self._links[lj]["parent"] == li or (
                            self._links[li]["parent"] == lj
                        ):
                            continue
                    # order: plane/static second
                    pairs.append((j, i) if static_i else (i, j))

        # Equivalent inertia boxes + principal frames (for the fluid model):
        # half-size b_i = 0.5*sqrt(6*(I_j + I_k - I_i)/m) in the principal
        # inertia frame (verified numerically against MuJoCo).
        link_ibox = np.zeros((n, 3), np.float32)
        link_iquat = np.zeros((n, 4), np.float32)
        link_iquat[:, 0] = 1.0
        for i, l in enumerate(self._links):
            m = l["mass"]
            if m <= 0:
                continue
            icom = np.asarray(l["inertia_com"], np.float64)
            # Scrub f32 noise so degenerate eigenspaces (e.g. axis-aligned
            # capsules) don't get arbitrarily rotated axes — the per-axis
            # |v_i| v_i quadratic drag is NOT invariant under such rotations,
            # and MuJoCo's principal frame stays geom-aligned here.
            scale = max(np.abs(icom).max(), 1e-12)
            icom = np.where(np.abs(icom) < 1e-5 * scale, 0.0, icom)
            icom = 0.5 * (icom + icom.T)
            w, V = np.linalg.eigh(icom)
            snapped = np.where(np.abs(V) < 1e-6, 0.0, np.where(V > 1 - 1e-6, 1.0, V))
            snapped = np.where(snapped < -1 + 1e-6, -1.0, snapped)
            if np.allclose(snapped @ snapped.T, np.eye(3), atol=1e-6):
                V = snapped
            if np.linalg.det(V) < 0:
                V[:, 0] = -V[:, 0]
            eye = w[[1, 2, 0]] + w[[2, 0, 1]] - w
            link_ibox[i] = 0.5 * np.sqrt(np.maximum(eye, 1e-12) * 6.0 / m)
            link_iquat[i] = _mat_to_quat(V)

        return Model(
            nlink=n,
            nq=nq,
            nv=nv,
            nu=len(acts),
            ngeom=len(geoms),
            link_parent=tuple(l["parent"] for l in self._links),
            link_jnt_type=tuple(jnt_types),
            link_qadr=tuple(qadr),
            link_vadr=tuple(vadr),
            link_pos=np.stack([l["pos"] for l in self._links]) if n else np.zeros((0, 3), np.float32),
            link_quat=np.stack([l["quat"] for l in self._links]) if n else np.zeros((0, 4), np.float32),
            jnt_axis=np.stack([l["jnt_axis"] for l in self._links]),
            jnt_anchor=np.stack([l["jnt_anchor"] for l in self._links]),
            jnt_range=np.stack([l["jnt_range"] for l in self._links]),
            jnt_limited=np.asarray([l["jnt_limited"] for l in self._links], np.float32),
            jnt_ref=np.asarray([l["ref"] for l in self._links], np.float32),
            jnt_stiffness=np.asarray([l["stiffness"] for l in self._links], np.float32),
            jnt_springref=np.asarray([l["springref"] for l in self._links], np.float32),
            dof_damping=dof_damping,
            dof_armature=dof_armature,
            dof_frictionloss=(
                dof_frictionloss if np.any(dof_frictionloss) else None
            ),
            link_mass=np.asarray([l["mass"] for l in self._links], np.float32),
            link_com=np.stack([l["com"] for l in self._links]),
            link_inertia_com=np.stack([l["inertia_com"] for l in self._links]),
            act_vadr=act_vadr,
            act_gear=np.asarray([a["gear"] for a in acts], np.float32),
            act_ctrlrange=(
                np.stack([a["ctrlrange"] for a in acts])
                if acts
                else np.zeros((0, 2), np.float32)
            ),
            act_ctrllimited=np.asarray(
                [a["ctrllimited"] for a in acts], np.float32
            ),
            geom_link=tuple(g["link"] for g in geoms),
            geom_type=tuple(g["type"] for g in geoms),
            geom_size=(
                np.stack([g["size"] for g in geoms])
                if geoms
                else np.zeros((0, 3), np.float32)
            ),
            geom_pos=(
                np.stack([g["pos"] for g in geoms])
                if geoms
                else np.zeros((0, 3), np.float32)
            ),
            geom_quat=(
                np.stack([g["quat"] for g in geoms])
                if geoms
                else np.zeros((0, 4), np.float32)
            ),
            geom_friction=np.asarray([g["friction"] for g in geoms], np.float32),
            contact_pairs=tuple(pairs),
            link_ibox=link_ibox,
            link_iquat=link_iquat,
            dt=self.dt,
            gravity=self.gravity,
            link_name=tuple(l["name"] for l in self._links),
            qpos0=qpos0,
            **{k: v for k, v in self.options.items()},
        )


def model_arrays(model: Model) -> Dict[str, np.ndarray]:
    """Every set field of a ``Model`` as a numpy array; dicts keyed by
    geom pairs become ``<name>__keys`` (P, 2) and ``<name>__values``."""
    out = {}
    for f in dataclasses.fields(model):
        v = getattr(model, f.name)
        if v is None:
            continue
        if isinstance(v, dict):
            keys = sorted(v)
            out[f"{f.name}__keys"] = np.asarray(keys, np.int64).reshape(-1, 2)
            out[f"{f.name}__values"] = np.asarray([v[k] for k in keys])
        else:
            out[f.name] = np.asarray(v)
    return out


def save_model_npz(model: Model, path: str) -> None:
    """Write ``model_arrays(model)`` to ``path`` (compressed), for
    ``load_model_npz``."""
    np.savez_compressed(path, **model_arrays(model))


def load_model_npz(path: str) -> Model:
    """A ``Model`` from the arrays ``save_model_npz`` stores (and
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
