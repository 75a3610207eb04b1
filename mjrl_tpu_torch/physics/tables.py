"""Static model tables: the tree, the contact pairs, the limit gains.

Numpy twins of ``engine.tree_tables`` (``mjrl_tpu/physics/engine.py:92``),
``contact._pair_groups`` (``contact.py:56``), ``soa._SoATables``
(``soa.py:203``) and ``engine.scale_limit_penalties`` (``engine.py:615``).
The plain stepper (physics/soa.py) unrolls its loops over these tables, and
physics/pkernel.py packs them into the buffer the CUDA kernel walks.
Everything is cached on the model instance.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from mjrl_tpu_torch.physics.model import (
    BOX,
    CAPSULE,
    CYLINDER,
    HINGE,
    JOINT_NV,
    PLANE,
    SLIDE,
    SPHERE,
    Model,
)


class TreeTables(NamedTuple):
    dof_link: np.ndarray  # (nv,) link index of each dof
    L_mask: np.ndarray  # (nlink, nv) dof j is ancestor-or-self of link l
    dof_mask: np.ndarray  # (nv, nv) [i, j]: dof j is ancestor-or-self of dof i
    # the 1-dof (hinge and slide) joints in link order: qpos / dof address
    # and link of each
    hinge_slide_q: np.ndarray
    hinge_slide_v: np.ndarray
    hinge_slide_link: np.ndarray


def tree_tables(model: Model) -> TreeTables:
    cached = getattr(model, "_tables", None)
    if cached is not None:
        return cached
    nv, nlink = model.nv, model.nlink
    dof_link = np.zeros(nv, np.int32)
    for i in range(nlink):
        t = model.link_jnt_type[i]
        if t != -1:
            dof_link[model.link_vadr[i] : model.link_vadr[i] + JOINT_NV[t]] = i
    L = np.zeros((nlink, nv), np.float32)
    for l in range(nlink):
        j = l
        while j >= 0:
            t = model.link_jnt_type[j]
            if t != -1:
                L[l, model.link_vadr[j] : model.link_vadr[j] + JOINT_NV[t]] = 1.0
            j = model.link_parent[j]
    hs = [i for i in range(nlink) if model.link_jnt_type[i] in (HINGE, SLIDE)]
    tables = TreeTables(
        dof_link=dof_link, L_mask=L, dof_mask=L[dof_link],
        hinge_slide_q=np.asarray([model.link_qadr[i] for i in hs], np.int32),
        hinge_slide_v=np.asarray([model.link_vadr[i] for i in hs], np.int32),
        hinge_slide_link=np.asarray(hs, np.int32),
    )
    model._tables = tables
    return tables


class PairGroups(NamedTuple):
    """Per-kind contact tables, in the reference's kind and pair order."""

    kinds: Tuple[Tuple[str, Dict[str, np.ndarray]], ...]


_RANK = {SPHERE: 0, CAPSULE: 1, CYLINDER: 1, BOX: 2, PLANE: 3}
_KIND_NAME = {0: "sphere", 1: "capsule", 2: "box", 3: "plane"}
# contact points each pair of a kind contributes
_POINTS = {"box_plane": 8, "capsule_plane": 2, "capsule_box": 3, "box_box": 16}


def pair_groups(model: Model) -> PairGroups:
    cached = getattr(model, "_pair_groups", None)
    if cached is not None:
        return cached
    buckets: Dict[str, List[Dict]] = {}
    pair_mu = getattr(model, "pair_mu", None) or {}
    for gi, gj in model.contact_pairs:
        # normalize order: sphere < capsule/cylinder < box < plane
        if _RANK[model.geom_type[gi]] > _RANK[model.geom_type[gj]]:
            gi, gj = gj, gi
        ri, rj = _RANK[model.geom_type[gi]], _RANK[model.geom_type[gj]]
        mu = max(float(model.geom_friction[gi]), float(model.geom_friction[gj]))
        mu = pair_mu.get((gi, gj), pair_mu.get((gj, gi), mu))
        kind = f"{_KIND_NAME[ri]}_{_KIND_NAME[rj]}"
        if kind == "plane_plane":
            continue
        buckets.setdefault(kind, []).append(
            dict(gi=gi, gj=gj, mu=mu, li=model.geom_link[gi], lj=model.geom_link[gj])
        )
    kinds = []
    for kind, rows in buckets.items():
        tab = {k: np.asarray([r[k] for r in rows], np.int32) for k in ("gi", "gj", "li", "lj")}
        tab["mu"] = np.asarray([r["mu"] for r in rows], np.float32)
        kinds.append((kind, tab))
    groups = PairGroups(kinds=tuple(kinds))
    model._pair_groups = groups
    return groups


def num_contact_candidates(model: Model) -> int:
    """Static count of narrow-phase contact points for this model."""
    return sum(
        len(tab["gi"]) * _POINTS.get(kind, 1) for kind, tab in pair_groups(model).kinds
    )


def plane_normal_point(model: Model, g: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static world normal + point of a world-fixed plane geom."""
    w, x, y, z = np.asarray(model.geom_quat[g], np.float64)
    n = np.array([2 * (x * z + w * y), 2 * (y * z - w * x), 1 - 2 * (x * x + y * y)])
    return n.astype(np.float32), np.asarray(model.geom_pos[g], np.float32)


class SoATables:
    """Ancestor chains, children, inertia eigen-pairs and composite masses."""

    def __init__(self, model: Model):
        tables = tree_tables(model)
        nv = model.nv
        # ancestor dof lists (j <= i), and the parent-dof chain lambda
        self.anc: List[List[int]] = []
        self.lam: List[int] = []
        for i in range(nv):
            js = [int(j) for j in np.flatnonzero(tables.dof_mask[i]) if j <= i]
            self.anc.append(js)
            below = [j for j in js if j < i]
            self.lam.append(max(below) if below else -1)
        self.dof_link = [int(x) for x in tables.dof_link]
        self.children: List[List[int]] = [[] for _ in range(model.nlink)]
        for i in range(model.nlink):
            p = model.link_parent[i]
            if p >= 0:
                if p >= i:
                    raise ValueError("links must be topologically ordered")
                self.children[p].append(i)
        # principal-axis factorization of each link's com inertia
        self.inertia_eig: List[Tuple[np.ndarray, np.ndarray]] = []
        for i in range(model.nlink):
            d, Q = np.linalg.eigh(np.asarray(model.link_inertia_com[i], np.float64))
            self.inertia_eig.append(
                (np.maximum(d, 0.0).astype(np.float32), Q.astype(np.float32))
            )
        cm = np.asarray(model.link_mass, np.float64).copy()
        for i in reversed(range(model.nlink)):
            p = model.link_parent[i]
            if p >= 0:
                cm[p] += cm[i]
        self.c_mass = cm.astype(np.float32)


def soa_tables(model: Model) -> SoATables:
    cached = getattr(model, "_soa_tables", None)
    if cached is None:
        cached = SoATables(model)
        model._soa_tables = cached
    return cached


def scale_limit_penalties(model: Model, omega: float = 60.0, zeta: float = 1.0) -> None:
    """Per-dof limit-penalty gains with one response frequency ``omega``
    (rad/s) and damping ratio ``zeta``: k_j = omega^2 M_jj(qpos0),
    c_j = 2 zeta omega M_jj. ``M_jj`` comes from the plain mass matrix
    (physics/soa.py) at qpos0 for one env, plus the armature."""
    if model.tendon_Jv is not None:
        raise NotImplementedError("tendon limit gains are not ported")
    from mjrl_tpu_torch.physics import soa

    Mdiag = soa.mass_matrix_diag(model, model.default_qpos) + np.asarray(
        model.dof_armature
    )
    model.dof_limit_stiffness = (omega**2 * Mdiag).astype(np.float32)
    model.dof_limit_damping = (2.0 * zeta * omega * Mdiag).astype(np.float32)

