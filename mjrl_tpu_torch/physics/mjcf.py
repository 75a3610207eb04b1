"""MJCF (MuJoCo XML) subset loader -> :class:`Model`.

A numpy-only twin of ``mjrl_tpu/physics/mjcf.py``: it compiles the same XML
into the port's :class:`Model`, array for array (tests/test_torch_physics.py
holds the two loaders equal on ant).

Supported subset (what the gym locomotion + Adroit-class models need):
- <compiler angle= inertiafromgeom= settotalmass=>
- <option timestep= gravity=> (integrator attr ignored: this engine always
  uses implicit-damping semi-implicit Euler; oracle tests therefore compare
  integrator-independent quantities or force Euler in MuJoCo)
- <default> trees with class inheritance for joint/geom/motor
- nested <body pos quat euler childclass>, <joint type axis pos range
  limited damping armature stiffness ref springref>, <freejoint>,
  <geom type size fromto pos quat euler friction mass density contype
  conaffinity>, <inertial pos quat mass diaginertia fullinertia>
- <actuator><motor joint gear ctrlrange ctrllimited>
- body inertia from geoms (sphere/capsule/box/cylinder, exact formulas)
  when inertiafromgeom is true or no <inertial> is given
- MuJoCo contact filtering: same-body and parent-child exclusion (unless
  the parent is world), contype/conaffinity bitmasks

Ignored: visual-only elements (light/camera/asset/material), tendons,
sensors, condim/solref/solimp (the penalty contact model has its own
stiffness parameters — physics/contact.py).
"""

from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

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

_JOINT_TYPES = {"free": FREE, "ball": BALL, "hinge": HINGE, "slide": SLIDE}
_GEOM_TYPES = {
    "plane": PLANE,
    "sphere": SPHERE,
    "capsule": CAPSULE,
    "box": BOX,
    "cylinder": CYLINDER,
}


def _floats(s: str) -> List[float]:
    return [float(x) for x in s.split()]


def _euler_to_quat(euler_rad: np.ndarray) -> np.ndarray:
    """XYZ-extrinsic euler -> quat (MJCF default eulerseq='xyz')."""

    def axis_q(ax, a):
        h = 0.5 * a
        q = np.zeros(4)
        q[0] = math.cos(h)
        q[1 + ax] = math.sin(h)
        return q

    def qmul(a, b):
        w1, x1, y1, z1 = a
        w2, x2, y2, z2 = b
        return np.array(
            [
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            ]
        )

    # extrinsic xyz == apply Rx then Ry then Rz in world: q = qz*qy*qx? For
    # extrinsic rotations about fixed axes applied x,y,z: R = Rz Ry Rx.
    qx = axis_q(0, euler_rad[0])
    qy = axis_q(1, euler_rad[1])
    qz = axis_q(2, euler_rad[2])
    return qmul(qz, qmul(qy, qx))


def _zalign_quat(d: np.ndarray) -> np.ndarray:
    """Quaternion rotating +z onto unit vector d."""
    z = np.array([0.0, 0.0, 1.0])
    c = float(np.dot(z, d))
    if c > 1 - 1e-9:
        return np.array([1.0, 0, 0, 0])
    if c < -1 + 1e-9:
        return np.array([0.0, 1.0, 0, 0])  # 180deg about x
    axis = np.cross(z, d)
    axis = axis / np.linalg.norm(axis)
    half = 0.5 * math.acos(max(-1.0, min(1.0, c)))
    return np.concatenate([[math.cos(half)], math.sin(half) * axis])


def _geom_mass_inertia(gtype: int, size, density, mass_attr):
    """(mass, inertia_diag_about_com_in_geom_frame) — MuJoCo formulas."""
    if gtype == SPHERE:
        r = size[0]
        vol = 4.0 / 3.0 * math.pi * r**3
        m = mass_attr if mass_attr is not None else density * vol
        i = 0.4 * m * r * r
        return m, np.diag([i, i, i])
    if gtype == CAPSULE:
        r, hl = size[0], size[1]
        vol_cyl = math.pi * r * r * (2 * hl)
        vol_sph = 4.0 / 3.0 * math.pi * r**3
        vol = vol_cyl + vol_sph
        m = mass_attr if mass_attr is not None else density * vol
        mc = m * vol_cyl / vol
        ms = m * vol_sph / vol
        iz = 0.5 * mc * r * r + 0.4 * ms * r * r
        # hemisphere about capsule com: I_com_hemi + m_h d^2
        d = hl + 3.0 * r / 8.0
        i_hemi_com = 0.4 * (ms / 2) * r * r - (ms / 2) * (3.0 * r / 8.0) ** 2
        ix = (
            mc * (3 * r * r + (2 * hl) ** 2) / 12.0
            + 2.0 * (i_hemi_com + (ms / 2) * d * d)
        )
        return m, np.diag([ix, ix, iz])
    if gtype == BOX:
        a, b, c = size[0], size[1], size[2]
        vol = 8.0 * a * b * c
        m = mass_attr if mass_attr is not None else density * vol
        return m, np.diag(
            [
                m / 3.0 * (b * b + c * c),
                m / 3.0 * (a * a + c * c),
                m / 3.0 * (a * a + b * b),
            ]
        )
    if gtype == CYLINDER:
        r, hl = size[0], size[1]
        vol = math.pi * r * r * 2 * hl
        m = mass_attr if mass_attr is not None else density * vol
        ix = m * (3 * r * r + 4 * hl * hl) / 12.0
        return m, np.diag([ix, ix, 0.5 * m * r * r])
    return 0.0, np.zeros((3, 3))


def _quat_to_mat_np(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


class _Defaults:
    """MJCF <default> class tree resolver."""

    def __init__(self, parent: Optional["_Defaults"] = None):
        self.parent = parent
        self.attrs: Dict[str, Dict[str, str]] = {}
        self.children: Dict[str, "_Defaults"] = {}

    def get(self, tag: str) -> Dict[str, str]:
        out: Dict[str, str] = {}
        if self.parent is not None:
            out.update(self.parent.get(tag))
        out.update(self.attrs.get(tag, {}))
        return out

    @staticmethod
    def parse(elem: Optional[ET.Element], parent=None) -> "_Defaults":
        d = _Defaults(parent)
        if elem is None:
            return d
        for child in elem:
            if child.tag == "default":
                name = child.get("class")
                d.children[name] = _Defaults.parse(child, d)
            else:
                d.attrs[child.tag] = dict(child.attrib)
        return d

    def flat_lookup(self, class_name: Optional[str]) -> "_Defaults":
        """Find the defaults node for a class anywhere in the tree."""
        if class_name is None:
            return self
        stack = [self]
        while stack:
            node = stack.pop()
            if class_name in node.children:
                return node.children[class_name]
            stack.extend(node.children.values())
        return self


def load_mjcf(source: str) -> Model:
    """Compile an MJCF string or file path into a :class:`Model`."""
    if os.path.exists(source):
        with open(source) as f:
            xml = f.read()
    else:
        xml = source
    root = ET.fromstring(xml)

    compiler = root.find("compiler")
    angle_deg = (compiler is None) or (compiler.get("angle", "degree") == "degree")
    inertiafromgeom = (
        compiler.get("inertiafromgeom", "auto") if compiler is not None else "auto"
    )
    settotalmass = (
        float(compiler.get("settotalmass", "-1")) if compiler is not None else -1.0
    )

    def ang(x: float) -> float:
        return math.radians(x) if angle_deg else x

    option = root.find("option")
    dt = float(option.get("timestep", "0.002")) if option is not None else 0.002
    gravity = (
        tuple(_floats(option.get("gravity", "0 0 -9.81")))
        if option is not None
        else (0.0, 0.0, -9.81)
    )

    defaults = _Defaults.parse(root.find("default"))

    b = ModelBuilder(dt=dt, gravity=gravity)
    if option is not None:
        b.options["density"] = float(option.get("density", "0"))
        b.options["viscosity"] = float(option.get("viscosity", "0"))

    joint_name_to_link: Dict[str, int] = {}
    body_parent_name: Dict[str, Optional[str]] = {}
    geom_meta: List[Dict] = []  # contype/conaffinity/body per geom index
    body_free: Dict[str, bool] = {}

    def merged(tag: str, elem: ET.Element, cls_default: _Defaults) -> Dict[str, str]:
        d = cls_default
        if elem.get("class"):
            d = defaults.flat_lookup(elem.get("class"))
        out = d.get(tag)
        out.update(elem.attrib)
        return out

    def parse_orient(attrs: Dict[str, str]) -> np.ndarray:
        if "quat" in attrs:
            q = np.asarray(_floats(attrs["quat"]))
            return q / np.linalg.norm(q)
        if "euler" in attrs:
            e = np.asarray([ang(v) for v in _floats(attrs["euler"])])
            return _euler_to_quat(e)
        if "axisangle" in attrs:
            aa = _floats(attrs["axisangle"])
            axis = np.asarray(aa[:3])
            axis = axis / np.linalg.norm(axis)
            a = ang(aa[3])
            return np.concatenate(
                [[math.cos(a / 2)], math.sin(a / 2) * axis]
            )
        return np.array([1.0, 0, 0, 0])

    def handle_geoms(
        body_name: Optional[str], elems: List[ET.Element], cls: _Defaults
    ):
        """Add geoms; return list of (mass, com, inertia_com) contributions in
        body frame."""
        contribs = []
        for ge in elems:
            attrs = merged("geom", ge, cls)
            gtype = _GEOM_TYPES[attrs.get("type", "sphere")]
            size = _floats(attrs.get("size", "0"))
            size = (size + [0.0, 0.0, 0.0])[:3]
            if "fromto" in attrs:
                ft = _floats(attrs["fromto"])
                a, c = np.asarray(ft[:3]), np.asarray(ft[3:])
                mid = 0.5 * (a + c)
                d = c - a
                length = float(np.linalg.norm(d))
                quat = _zalign_quat(d / max(length, 1e-12))
                pos = mid
                size = (size[0], 0.5 * length, 0.0)
            else:
                pos = np.asarray(_floats(attrs.get("pos", "0 0 0")))
                quat = parse_orient(attrs)
            fr = _floats(attrs.get("friction", "1 0.005 0.0001"))
            friction = fr[0]
            friction_tor = fr[1] if len(fr) > 1 else 0.005
            density = float(attrs.get("density", "1000"))
            mass_attr = float(attrs["mass"]) if "mass" in attrs else None
            gidx = b.add_geom(
                body_name,
                gtype,
                size=size,
                pos=pos,
                quat=quat,
                friction=friction,
            )
            solimp = _floats(attrs.get("solimp", "0.9 0.95 0.001 0.5 2"))
            solimp = (solimp + [0.5, 2.0])[:5]  # files often give 3 of 5
            geom_meta.append(
                dict(
                    idx=gidx,
                    body=body_name,
                    contype=int(attrs.get("contype", "1")),
                    conaffinity=int(attrs.get("conaffinity", "1")),
                    type=gtype,
                    condim=int(attrs.get("condim", "3")),
                    solref=_floats(attrs.get("solref", "0.02 1")),
                    solimp=solimp,
                    margin=float(attrs.get("margin", "0")),
                    friction_tor=friction_tor,
                )
            )
            if gtype != PLANE and body_name is not None:
                m, i_diag = _geom_mass_inertia(gtype, size, density, mass_attr)
                R = _quat_to_mat_np(quat)
                i_body = R @ i_diag @ R.T
                contribs.append((m, pos, i_body))
        return contribs

    def combine_inertia(contribs):
        mass = sum(c[0] for c in contribs)
        if mass <= 0:
            return 0.0, np.zeros(3), np.zeros((3, 3))
        com = sum(c[0] * np.asarray(c[1]) for c in contribs) / mass
        itot = np.zeros((3, 3))
        for m, p, i_com in contribs:
            d = np.asarray(p) - com
            itot += i_com + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
        return mass, com, itot

    # -- recursive body walk -------------------------------------------------
    def walk(body_elem: ET.Element, parent_name: Optional[str], cls: _Defaults):
        name = body_elem.get("name") or f"body{len(body_parent_name)}"
        if body_elem.get("childclass"):
            cls = defaults.flat_lookup(body_elem.get("childclass"))
        pos = np.asarray(_floats(body_elem.get("pos", "0 0 0")))
        quat = parse_orient(body_elem.attrib)

        joints = []
        jnames = []
        for je in body_elem.findall("joint") + body_elem.findall("freejoint"):
            if je.tag == "freejoint":
                jattrs = {"type": "free"}
                jattrs.update(je.attrib)
            else:
                jattrs = merged("joint", je, cls)
            jtype = _JOINT_TYPES[jattrs.get("type", "hinge")]
            limited = jattrs.get("limited", "false") in ("true", "1")
            rng = [ang(v) for v in _floats(jattrs.get("range", "0 0"))]
            if jtype == SLIDE:
                rng = _floats(jattrs.get("range", "0 0"))  # lengths, not angles
            ref = float(jattrs.get("ref", "0"))
            if jtype == HINGE:
                ref = ang(ref)
            axis = np.asarray(_floats(jattrs.get("axis", "0 0 1")))
            n = np.linalg.norm(axis)
            if n > 0:
                axis = axis / n
            joints.append(
                dict(
                    type=jtype,
                    axis=axis,
                    pos=_floats(jattrs.get("pos", "0 0 0")),
                    range=rng,
                    limited=limited,
                    damping=float(jattrs.get("damping", "0")),
                    frictionloss=float(jattrs.get("frictionloss", "0")),
                    armature=float(jattrs.get("armature", "0")),
                    stiffness=float(jattrs.get("stiffness", "0")),
                    springref=float(jattrs.get("springref", "0")),
                    ref=ref,
                )
            )
            jnames.append(jattrs.get("name"))

        is_free = any(j["type"] == FREE for j in joints)
        body_free[name] = is_free
        if is_free:
            assert len(joints) == 1, "free joint must be the only joint"
            assert parent_name is None, "free joint requires world parent"

        geom_elems = body_elem.findall("geom")

        inertial = body_elem.find("inertial")
        use_geom_inertia = inertiafromgeom == "true" or (
            inertiafromgeom == "auto" and inertial is None
        )

        # Body must exist before geoms attach; compute inertia after geoms.
        b.add_body(
            name,
            parent=parent_name,
            pos=(0, 0, 0) if is_free else pos,
            quat=(1, 0, 0, 0) if is_free else quat,
            joints=joints,
            mass=0.0,
        )
        contribs = handle_geoms(name, geom_elems, cls)

        if use_geom_inertia:
            mass, com, icom = combine_inertia(contribs)
        else:
            iattrs = inertial.attrib
            mass = float(iattrs["mass"])
            com = np.asarray(_floats(iattrs.get("pos", "0 0 0")))
            iq = parse_orient(iattrs)
            R = _quat_to_mat_np(iq)
            if "diaginertia" in iattrs:
                idiag = np.diag(_floats(iattrs["diaginertia"]))
            else:
                f = _floats(iattrs["fullinertia"])
                idiag = np.array(
                    [
                        [f[0], f[3], f[4]],
                        [f[3], f[1], f[5]],
                        [f[4], f[5], f[2]],
                    ]
                )
            icom = R @ idiag @ R.T
        link = b._name_to_link[name]
        b._links[link]["mass"] = float(mass)
        b._links[link]["com"] = np.asarray(com, np.float32)
        b._links[link]["inertia_com"] = np.asarray(icom, np.float32)

        # free-joint bodies: world pose lives in qpos, not the link offset
        if is_free:
            b._links[link]["free_qpos0"] = np.concatenate([pos, quat]).astype(
                np.float32
            )

        for k, jn in enumerate(jnames):
            if jn is not None:
                first = link - (len(joints) - 1)
                joint_name_to_link[jn] = first + k

        body_parent_name[name] = parent_name
        for child in body_elem.findall("body"):
            walk(child, name, cls)

    worldbody = root.find("worldbody")
    handle_geoms(None, worldbody.findall("geom"), defaults)
    for body_elem in worldbody.findall("body"):
        walk(body_elem, None, defaults)

    # -- actuators -----------------------------------------------------------
    act_root = root.find("actuator")
    if act_root is not None:
        for me in act_root.findall("motor") + act_root.findall("general"):
            attrs = merged("motor", me, defaults)
            link = joint_name_to_link[attrs["joint"]]
            gear = _floats(attrs.get("gear", "1"))[0]
            limited = attrs.get("ctrllimited", "false") in ("true", "1")
            rng = _floats(attrs.get("ctrlrange", "0 0")) if limited else None
            b.add_motor_link(link, gear=gear, ctrlrange=rng)

    # -- settotalmass --------------------------------------------------------
    if settotalmass > 0:
        total = sum(l["mass"] for l in b._links)
        scale = settotalmass / max(total, 1e-12)
        for l in b._links:
            l["mass"] *= scale
            l["inertia_com"] = l["inertia_com"] * scale

    # -- contact pairs with MuJoCo filtering ---------------------------------
    pairs: List[Tuple[int, int]] = []
    for i, gi in enumerate(geom_meta):
        for j in range(i + 1, len(geom_meta)):
            gj = geom_meta[j]
            bi, bj = gi["body"], gj["body"]
            if bi == bj:
                continue
            if bi is None and bj is None:
                continue
            # parent-child exclusion (parent != world)
            if bi is not None and bj is not None:
                if body_parent_name.get(bi) == bj or body_parent_name.get(bj) == bi:
                    continue
            mask = (gi["contype"] & gj["conaffinity"]) or (
                gj["contype"] & gi["conaffinity"]
            )
            if not mask:
                continue
            static_i = gi["type"] == PLANE or bi is None
            pairs.append((j, i) if static_i else (i, j))

    model = b.finalize(explicit_pairs=pairs)

    # soft-constraint solver parameters per geom (csolve.py); invweights
    # are computed lazily at first solver use
    ng = model.ngeom
    model.geom_solref = np.asarray(
        [g["solref"][:2] for g in geom_meta], np.float32
    ).reshape(ng, 2)
    model.geom_solimp = np.asarray(
        [g["solimp"] for g in geom_meta], np.float32
    ).reshape(ng, 5)
    model.geom_margin = np.asarray(
        [g["margin"] for g in geom_meta], np.float32
    )
    model.geom_condim = np.asarray([g["condim"] for g in geom_meta], np.int32)
    model.geom_friction_tor = np.asarray(
        [g["friction_tor"] for g in geom_meta], np.float32
    )

    # free-joint initial world pose -> qpos0
    qpos0 = model.default_qpos.copy()
    for i, l in enumerate(b._links):
        if "free_qpos0" in l:
            adr = model.link_qadr[i]
            qpos0[adr : adr + 7] = l["free_qpos0"]
    model.qpos0 = qpos0
    return model
