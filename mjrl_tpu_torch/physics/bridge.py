"""Bridge: a compiled ``mujoco.MjModel`` -> the port's :class:`Model`.

Twin of ``mjrl_tpu/physics/bridge.py``. MuJoCo serves only as an offline
MJCF compiler front end: ``load_mj_model`` compiles an MJCF file with the
installed ``mujoco`` wheel, and ``model_from_mujoco`` copies the compiled
arrays into a plain numpy ``Model`` once, on the host. Nothing here runs
on the card, and ``mujoco`` is imported only inside these functions, so
the package imports on a machine without it; the Adroit envs read the
``Model`` this produces from ``envs/assets/adroit_<task>.npz``
(``tools/torch_gen_adroit_model.py``).

Supported: hinge/slide/ball/free joints (free only on world-rooted bodies),
plane/sphere/capsule/cylinder/box collision geoms (mesh/ellipsoid accepted
as visual-only), joint-transmission actuators with fixed gain + affine bias
(covers <motor> and <position>/Adroit <general>), fixed tendons
(joint-coupling wraps) with limits/springs, sites, explicit contact <pair>
elements (with their friction/condim) and <exclude> filtering, per-dof
damping/armature, option timestep/gravity/density/viscosity.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Dict, List, Tuple

import numpy as np

from mjrl_tpu_torch.physics.model import (
    BALL,
    BOX,
    CAPSULE,
    CYLINDER,
    FREE,
    HINGE,
    PLANE,
    SLIDE,
    SPHERE,
    Model,
    ModelBuilder,
)

# mjtJoint: FREE=0 BALL=1 SLIDE=2 HINGE=3
_MJ_JNT = {0: FREE, 1: BALL, 2: SLIDE, 3: HINGE}
# mjtGeom: PLANE=0 HFIELD=1 SPHERE=2 CAPSULE=3 ELLIPSOID=4 CYLINDER=5 BOX=6 MESH=7
_MJ_GEOM = {0: PLANE, 2: SPHERE, 3: CAPSULE, 5: CYLINDER, 6: BOX}


def load_mj_model(path: str):
    """Compile an MJCF file with the installed ``mujoco`` wheel, stripping
    legacy attributes (e.g. ``apirate``) that MuJoCo 3.x rejects in the
    original DAPG-era Adroit assets."""
    import mujoco

    try:
        return mujoco.MjModel.from_xml_path(path)
    except ValueError:
        src_dir = os.path.dirname(os.path.abspath(path))
        # the compiled model holds everything it read: the copy can go
        with tempfile.TemporaryDirectory(prefix="mjrl_tpu_torch_mjcf_") as tmp:
            for fname in os.listdir(src_dir):
                fpath = os.path.join(src_dir, fname)
                if os.path.isdir(fpath) or not fname.endswith(".xml"):
                    os.symlink(fpath, os.path.join(tmp, fname))
                    continue
                with open(fpath) as f:
                    text = re.sub(r"\sapirate=[\"'][^\"']*[\"']", "", f.read())
                with open(os.path.join(tmp, fname), "w") as f:
                    f.write(text)
            return mujoco.MjModel.from_xml_path(os.path.join(tmp, os.path.basename(path)))


def model_from_mujoco(m) -> Model:
    """Convert a compiled ``mujoco.MjModel`` into the port's ``Model``."""
    import mujoco

    def body_name(i: int) -> str:
        return mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_BODY, i) or f"body{i}"

    b = ModelBuilder(dt=float(m.opt.timestep), gravity=tuple(m.opt.gravity))
    b.options["density"] = float(m.opt.density)
    b.options["viscosity"] = float(m.opt.viscosity)

    # -- bodies + joints (document order == index order in MjModel) ----------
    jnt_to_link: Dict[int, int] = {}
    free_qpos0: List[Tuple[int, np.ndarray]] = []  # (link, pose7)
    for bi in range(1, m.nbody):
        parent = int(m.body_parentid[bi])
        parent_name = None if parent == 0 else body_name(parent)
        joints = []
        jids = list(range(int(m.body_jntadr[bi]), int(m.body_jntadr[bi]) + int(m.body_jntnum[bi])))
        is_free = any(_MJ_JNT[int(m.jnt_type[j])] == FREE for j in jids)
        if is_free and parent != 0:
            raise NotImplementedError("free joint on a non-world body")
        for j in jids:
            t = _MJ_JNT[int(m.jnt_type[j])]
            qadr, dadr = int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])
            joints.append(
                dict(
                    type=t,
                    axis=np.asarray(m.jnt_axis[j], np.float32),
                    pos=np.asarray(m.jnt_pos[j], np.float32),
                    range=np.asarray(m.jnt_range[j], np.float32),
                    limited=bool(m.jnt_limited[j]),
                    damping=float(m.dof_damping[dadr]),
                    armature=float(m.dof_armature[dadr]),
                    frictionloss=float(m.dof_frictionloss[dadr]),
                    stiffness=float(m.jnt_stiffness[j]),
                    springref=float(m.qpos_spring[qadr]) if t in (HINGE, SLIDE) else 0.0,
                    ref=float(m.qpos0[qadr]) if t in (HINGE, SLIDE) else 0.0,
                )
            )
        b.add_body(
            body_name(bi),
            parent=parent_name,
            pos=(0, 0, 0) if is_free else tuple(m.body_pos[bi]),
            quat=(1, 0, 0, 0) if is_free else tuple(m.body_quat[bi]),
            joints=joints,
        )
        link = b._name_to_link[body_name(bi)]
        # inertia straight from the compiled model (principal frame -> link)
        R = _quat_to_mat_np(np.asarray(m.body_iquat[bi], np.float64))
        icom = R @ np.diag(np.asarray(m.body_inertia[bi], np.float64)) @ R.T
        b._links[link]["mass"] = float(m.body_mass[bi])
        b._links[link]["com"] = np.asarray(m.body_ipos[bi], np.float32)
        b._links[link]["inertia_com"] = np.asarray(icom, np.float32)
        if is_free:
            pose = np.concatenate([m.body_pos[bi], m.body_quat[bi]])
            free_qpos0.append((link, np.asarray(pose, np.float32)))
        first = link - (len(joints) - 1)
        for k, j in enumerate(jids):
            jnt_to_link[j] = first + k

    body_last_link = {bi: b._name_to_link[body_name(bi)] for bi in range(1, m.nbody)}

    # -- geoms (collidable shapes + planes; mesh/ellipsoid are visual) -------
    geom_map: Dict[int, int] = {}  # mj geom id -> our geom index
    for gi in range(m.ngeom):
        gt = int(m.geom_type[gi])
        if gt not in _MJ_GEOM:
            if m.geom_contype[gi] or m.geom_conaffinity[gi]:
                raise NotImplementedError(
                    f"collidable geom of unsupported type {gt} (mesh/ellipsoid/hfield)"
                )
            continue
        bi = int(m.geom_bodyid[gi])
        body = None if bi == 0 else body_name(bi)
        geom_map[gi] = b.add_geom(
            body,
            _MJ_GEOM[gt],
            size=tuple(m.geom_size[gi]),
            pos=tuple(m.geom_pos[gi]),
            quat=tuple(m.geom_quat[gi]),
            friction=float(m.geom_friction[gi][0]),
        )

    # -- contact pairs: contype/conaffinity + weld-parent filter, then
    #    explicit <pair> additions and <exclude> removals (mj_collision rule)
    excl = set()
    for e in range(m.nexclude):
        sig = int(m.exclude_signature[e])
        excl.add((sig >> 16, sig & 0xFFFF))
        excl.add((sig & 0xFFFF, sig >> 16))
    pairs: List[Tuple[int, int]] = []
    pair_mu: Dict[Tuple[int, int], float] = {}

    def _rank(gt: int) -> int:
        return {SPHERE: 0, CAPSULE: 1, CYLINDER: 1, BOX: 2, PLANE: 3}[gt]

    def _norm(gi: int, gj: int) -> Tuple[int, int]:
        ti = _MJ_GEOM[int(m.geom_type[gi])]
        tj = _MJ_GEOM[int(m.geom_type[gj])]
        return (gj, gi) if _rank(ti) > _rank(tj) else (gi, gj)

    for gi in range(m.ngeom):
        for gj in range(gi + 1, m.ngeom):
            if gi not in geom_map or gj not in geom_map:
                continue
            bi, bj = int(m.geom_bodyid[gi]), int(m.geom_bodyid[gj])
            if bi == bj:
                continue
            wi, wj = int(m.body_weldid[bi]), int(m.body_weldid[bj])
            # <exclude> signatures name RAW body ids (mj_collision checks
            # them pre-weld); comparing weld ids silently missed e.g. the
            # hammer model's nail_board/nail exclude (nail_board welds to
            # the world, so its weld id is 0, never matching the signature)
            # — which left a spurious nail-vs-board contact that capped the
            # nail 3.4 cm short of its goal and made the task unwinnable.
            # Raw ids ONLY: adding a weld-id match here would over-exclude
            # (a body welded to an excluded body's weld root would inherit
            # the exclusion that MuJoCo does not apply).
            if wi == wj or (bi, bj) in excl:
                continue
            # parent filter — MuJoCo exempts the world body: a geom welded
            # to the world must still collide with free-standing children
            pa = int(m.body_weldid[m.body_parentid[wi]]) if wi else -1
            pb = int(m.body_weldid[m.body_parentid[wj]]) if wj else -1
            if (pa == wj and wj != 0) or (pb == wi and wi != 0):
                continue
            c1 = int(m.geom_contype[gi]) & int(m.geom_conaffinity[gj])
            c2 = int(m.geom_contype[gj]) & int(m.geom_conaffinity[gi])
            if not (c1 or c2):
                continue
            pairs.append(_norm(gi, gj))
    for p in range(m.npair):
        gi, gj = int(m.pair_geom1[p]), int(m.pair_geom2[p])
        if gi not in geom_map or gj not in geom_map:
            continue
        key = _norm(gi, gj)
        if key not in pairs:
            pairs.append(key)
        mu = 0.0 if int(m.pair_dim[p]) == 1 else float(m.pair_friction[p][0])
        pair_mu[(geom_map[key[0]], geom_map[key[1]])] = mu
    pairs = [(geom_map[i], geom_map[j]) for (i, j) in pairs]

    model = b.finalize(explicit_pairs=pairs)
    model.pair_mu = pair_mu or None

    # -- soft-constraint solver parameters (csolve.py): straight copies of
    #    the compiled model's solref/solimp/margin/invweight0 fields --------
    jnt_solref = np.tile(np.array([0.02, 1.0], np.float32), (model.nlink, 1))
    jnt_solimp = np.tile(
        np.array([0.9, 0.95, 0.001, 0.5, 2.0], np.float32), (model.nlink, 1)
    )
    for j, link in jnt_to_link.items():
        jnt_solref[link] = m.jnt_solref[j]
        jnt_solimp[link] = m.jnt_solimp[j]
    model.jnt_solref = jnt_solref
    model.jnt_solimp = jnt_solimp
    ngeom = model.ngeom
    geom_solref = np.tile(np.array([0.02, 1.0], np.float32), (ngeom, 1))
    geom_solimp = np.tile(
        np.array([0.9, 0.95, 0.001, 0.5, 2.0], np.float32), (ngeom, 1)
    )
    geom_margin = np.zeros(ngeom, np.float32)
    geom_condim = np.full(ngeom, 3, np.int32)
    geom_invw = np.zeros(ngeom, np.float32)
    for mj_g, our_g in geom_map.items():
        geom_solref[our_g] = m.geom_solref[mj_g]
        geom_solimp[our_g] = m.geom_solimp[mj_g]
        geom_margin[our_g] = m.geom_margin[mj_g]
        geom_condim[our_g] = m.geom_condim[mj_g]
        geom_invw[our_g] = m.body_invweight0[int(m.geom_bodyid[mj_g]), 0]
    model.geom_solref = geom_solref
    model.geom_solimp = geom_solimp
    model.geom_margin = geom_margin
    model.geom_condim = geom_condim
    model.geom_invweight0 = geom_invw
    geom_tor = np.full(ngeom, 0.005, np.float32)
    for mj_g, our_g in geom_map.items():
        geom_tor[our_g] = m.geom_friction[mj_g][1]
    model.geom_friction_tor = geom_tor
    model.dof_invweight0 = np.asarray(m.dof_invweight0, np.float32)
    pair_condim = {}
    for p in range(m.npair):
        gi, gj = int(m.pair_geom1[p]), int(m.pair_geom2[p])
        if gi in geom_map and gj in geom_map:
            key = _norm(gi, gj)
            pair_condim[(geom_map[key[0]], geom_map[key[1]])] = int(m.pair_dim[p])
    model.pair_condim = pair_condim or None

    # -- qpos0 (MuJoCo's reference configuration, free poses included) -------
    qpos0 = model.default_qpos.copy()
    qpos0[:] = np.asarray(m.qpos0, np.float32)
    for link, pose in free_qpos0:
        adr = model.link_qadr[link]
        qpos0[adr : adr + 7] = pose
    model.qpos0 = qpos0

    # -- actuators: joint transmission, fixed gain + (optional) affine bias --
    if m.nu:
        vadr, qadr, gear = [], [], []
        gain = np.zeros((m.nu, 3), np.float32)
        bias = np.zeros((m.nu, 3), np.float32)
        ctrlrange = np.zeros((m.nu, 2), np.float32)
        ctrllimited = np.zeros(m.nu, np.float32)
        for a in range(m.nu):
            if int(m.actuator_trntype[a]) != 0:  # mjTRN_JOINT
                raise NotImplementedError("non-joint actuator transmission")
            if int(m.actuator_gaintype[a]) != 0:  # mjGAIN_FIXED
                raise NotImplementedError("non-fixed actuator gain")
            if int(m.actuator_biastype[a]) not in (0, 1):  # NONE or AFFINE
                raise NotImplementedError("muscle bias actuators")
            j = int(m.actuator_trnid[a][0])
            link = jnt_to_link[j]
            vadr.append(model.link_vadr[link])
            qadr.append(model.link_qadr[link])
            gear.append(float(m.actuator_gear[a][0]))
            gain[a] = m.actuator_gainprm[a][:3]
            bias[a] = m.actuator_biasprm[a][:3]
            ctrlrange[a] = m.actuator_ctrlrange[a]
            ctrllimited[a] = float(m.actuator_ctrllimited[a])
        model.act_vadr = np.asarray(vadr, np.int32)
        model.act_qadr = np.asarray(qadr, np.int32)
        model.act_gear = np.asarray(gear, np.float32)
        model.act_gainprm = gain
        model.act_biasprm = bias
        model.act_ctrlrange = ctrlrange
        model.act_ctrllimited = ctrllimited
        model.nu = m.nu

    # -- fixed tendons (mjWRAP_JOINT wraps only) ------------------------------
    if m.ntendon:
        Jq = np.zeros((m.ntendon, model.nq), np.float32)
        Jv = np.zeros((m.ntendon, model.nv), np.float32)
        for t in range(m.ntendon):
            adr, num = int(m.tendon_adr[t]), int(m.tendon_num[t])
            for w in range(adr, adr + num):
                if int(m.wrap_type[w]) != 1:  # mjWRAP_JOINT
                    raise NotImplementedError("spatial (non-fixed) tendons")
                link = jnt_to_link[int(m.wrap_objid[w])]
                coef = float(m.wrap_prm[w])
                Jq[t, model.link_qadr[link]] += coef
                Jv[t, model.link_vadr[link]] += coef
        model.tendon_Jq = Jq
        model.tendon_Jv = Jv
        model.tendon_range = np.asarray(m.tendon_range, np.float32)
        model.tendon_limited = np.asarray(m.tendon_limited, np.float32)
        model.tendon_stiffness = np.asarray(m.tendon_stiffness, np.float32)
        model.tendon_damping = np.asarray(m.tendon_damping, np.float32)
        model.tendon_springlength = np.asarray(
            m.tendon_lengthspring[:, 0], np.float32
        )

    # -- joint names (per expanded link, for env code name lookups) ----------
    jnames = [""] * model.nlink
    for j, link in jnt_to_link.items():
        jnames[link] = (
            mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_JOINT, j) or f"joint{j}"
        )
    model.jnt_name = tuple(jnames)

    # -- sites ----------------------------------------------------------------
    if m.nsite:
        model.site_link = tuple(
            -1 if int(m.site_bodyid[s]) == 0 else body_last_link[int(m.site_bodyid[s])]
            for s in range(m.nsite)
        )
        model.site_pos = np.asarray(m.site_pos, np.float32)
        model.site_quat = np.asarray(m.site_quat, np.float32)
        model.site_name = tuple(
            mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_SITE, s) or f"site{s}"
            for s in range(m.nsite)
        )
    return model


def _quat_to_mat_np(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
