"""Kernels K1, K2, K3 and K4: a full control step of physics per launch,
CUDA C++ on Hopper; and the pose kernel.

They replace ``mjrl_tpu/physics/pkernel.py::multistep_pallas``, the Pallas
TPU mega-kernel: K1 its penalty body (``_kernel_body``), K2 the same with
the Newton solver (``soa_newton.constrained_qdd``), K3 its body for
models with fixed tendons and per-env scene offsets (``_kernel_body_ext``,
every Adroit env), K4 that body with the Newton solver. The sources are in
``mjrl_tpu_torch/csrc/``: ``mj_substep.h`` holds the table-driven layout,
helpers, the narrow phase (Adroit's box kinds as its ``EXT`` branch) and
the one-lane stages, ``mj_newton.h`` the Newton row builders,
``mj_warp.h`` the warp primitives, ``mj_warp_stages.h`` the pipeline's
stages spread over the 32 lanes of a warp, ``mj_warp_penalty.h`` K1's and
K3's substeps on them (``EXT`` off and on) and ``mj_warp_newton.h`` K2's
and K4's; ``mj_kernel.cu``, ``mj_newton_kernel.cu``, ``mj_ext_kernel.cu``
and ``mj_ext_newton_kernel.cu`` (one warp per env, its state in shared
memory) hold the ``__global__`` wrappers with plain C launch functions.
Each is built with ``nvcc`` for ``sm_90a`` at first use into
``mjrl_tpu_torch/_build/`` (keyed by a hash of the sources and flags) and
bound with ``ctypes`` (:func:`load_library`).

What bounds them on an H100: latency. A control step moves ~260 bytes per
env (pen ~0.8 KB) and runs tens of thousands (K2, K3, K4: hundreds of
thousands) of dependent f32 operations; each kernel keeps one env's state
in a warp's shared memory with each stage's work spread over its lanes,
for the whole control step (one launch per control step, no intermediate
in device memory).

One wrapper, :class:`PhysicsKernel`, keyed on the solver and on ``ext``
(Adroit's stages), is ``K1`` (penalty), ``K2`` (Newton), ``K3`` and ``K4``
(the same with ``ext``); ``KERNELS`` maps (solver, ext) to them. For a
CUDA tensor they launch the kernel or raise; for a CPU tensor they run the
plain version, ``physics/soa.py::multistep``; ``launches`` counts
launches. ``POSES`` (:class:`PoseKernel`, ``mj_poses_kernel.cu`` on
``mj_poses.h``) gives the Adroit envs' observation its link poses and
site positions on the card. Their tables live in one cache on the model
(:meth:`PhysicsKernel.tables`, :func:`set_tables`, :func:`drop_tables`).
While tracing is on (``utils/trace.py``) K2 and K4 count their
env-substeps, the contact rows each holds and the rest of ``STAT_NAMES``,
their launches, blocks and waves, and the pose kernel its launches and
plain calls.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import operator
import os
import shutil
import subprocess
from functools import cached_property
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mjrl_tpu_torch.physics import soa, soa_newton
from mjrl_tpu_torch.physics.csolve import ensure_solver_params
from mjrl_tpu_torch.physics.engine import forward_kinematics, site_positions
from mjrl_tpu_torch.physics.model import Model
from mjrl_tpu_torch.physics.tables import (
    num_contact_candidates,
    pair_groups,
    plane_normal_point,
    soa_tables,
    tree_tables,
)
from mjrl_tpu_torch.utils import trace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

# Names of the values mj_layout() writes, in its order (mj_substep.h).
LAYOUT_NAMES = (
    "MAX_LINK", "MAX_NV", "MAX_NQ", "MAX_NU", "PAIR_I", "PAIR_F", "PAIR_GJ",
    "I_NLINK", "I_NQ", "I_NV", "I_NU", "I_NPAIR", "I_HAS_FCAP",
    "I_PARENT", "I_TYPE", "I_QADR", "I_VADR", "I_LIMITED", "I_DOFLINK",
    "I_LAM", "I_ACTV", "I_ACTLIM", "I_PAIR",
    "F_GRAV", "F_KS", "F_KD", "F_CAP", "F_FCAP", "F_VREG", "F_LPOS",
    "F_LQUAT", "F_AXIS", "F_ANCHOR", "F_REF", "F_RANGE", "F_STIFF",
    "F_SPRINGREF", "F_MASS", "F_COM", "F_EIGD", "F_EIGQ", "F_CMASS",
    "F_DAMP", "F_EXTRA", "F_LIMK", "F_LIMC", "F_LIMDTC", "F_GEAR",
    "F_CLO", "F_CHI", "F_PAIR", "I_HAS_FLUID", "F_IQUAT", "F_FLUID", "FLUID_F",
    "I_HAS_GAINBIAS", "I_HAS_FRIC", "I_NTEN", "I_TEN_I", "I_TEN_F", "I_ACTQ", "F_GAIN",
    "F_BIAS", "F_FRIC", "F_FVEPS",
)
# Names of the values mj_newton_layout() writes, in its order (mj_newton.h).
NEWTON_LAYOUT_NAMES = (
    "MAX_FACET", "MAX_CHAIN", "IMP_F", "LIM_I", "LIM_F", "NPAIR_I", "NPAIR_F",
    "N_I_NLIM", "N_I_LIM", "N_I_PAIR", "N_F_LIM", "N_F_PAIR", "MAX_HELD", "N_STATS",
    "SHARED_HELD", "ROW_BYTES",
)
# The counters of K2's and K4's stats buffer (mj_newton.h's MJ_STAT_*), in
# its order: per env-substep the contact rows inside their margin (summed,
# and the largest) and the terms of H's assembly over the rows held; per
# Newton iteration the iteration, and whether its line search took a
# fraction under 1, took 0 or was a near tie (mj_warp_newton.h's
# mj_near_tie); per env-substep the rows it holds in device memory (past
# the build's SHARED_HELD), and whether it holds any there.
STAT_NAMES = ("held_rows", "held_rows_max", "chain_terms", "newton_iters", "ls_cut", "ls_zero",
              "ls_near_ties", "spilled_rows", "spill_substeps")
# Names of the values mj_warp_layout() writes, in its order (a warp body's
# .cu file: mj_warp_penalty.h's or mj_warp_newton.h's values): shared
# bytes per warp (env), tendons, warps per block and stages at most, and
# K1's contact points at most (0 in a Newton body and in K3, which has no
# cap).
WARP_LAYOUT_NAMES = ("BYTES", "MAX_TEN", "MAX_WARPS", "N_STAGES", "MAX_POINTS")
# Shared memory a block may use on Hopper (227 KB).
SHARED_BYTES_PER_BLOCK = 232448
_KIND_CODE = {"sphere_plane": 0, "capsule_plane": 1, "capsule_capsule": 2, "sphere_sphere": 3,
              "sphere_capsule": 4, "box_plane": 5, "sphere_box": 6, "capsule_box": 7,
              "box_box": 8}
# The size classes: the compile-time maxima (links, dofs, qpos,
# actuators) of each build, smallest first. The first is mj_substep.h's
# default (ant, the planar walkers, swimmer); the second fits humanoid
# (20 links, 23 dofs, 24 qpos, 17 actuators); the third the Adroit hand
# (pen: 34 links, 30 dofs, 30 qpos, 24 actuators; relocate's 36 dofs). A
# model runs in the smallest class it fits, so the larger per-thread
# arrays cost the small models nothing. CHAIN_CLASSES: each class's dofs
# on a Newton contact pair's chain (mj_newton.h; pen's pairs reach 13,
# hammer's 15, relocate's 19). POINT_CLASSES: each class's contact points
# of a model in K1's warp body (mj_warp_penalty.h; ant 25, humanoid 140);
# K3 takes the pairs in rounds of 32 and has no such cap. HELD_CLASSES:
# each class's contact rows inside their margin that K2's and K4's bodies
# hold per env-substep (mj_newton.h; ant and hopper hold under 10; Adroit's
# states where a box, capsule or sphere sits up to 1 cm deep in the table
# or the hand, physics/probe.py's kind_states, hold up to 75 on door and
# relocate and 65 on hammer, 36 on pen; training holds ~2).
# SHARED_HELD_CLASSES: of those, the rows each class keeps in the warp's
# shared memory; the rest go to the env's slab in device memory, which the
# wrapper allocates. All of them in the two small classes; 14 in the
# Adroit class, the most at which a warp's state (28840 bytes, 564 a row)
# lets 8 envs share a block and an SM (96 in shared memory took 74980
# bytes, 3 envs a block).
SIZE_CLASSES = ((16, 16, 24, 16), (24, 24, 32, 24), (38, 36, 36, 30))
CHAIN_CLASSES = (8, 8, 19)
POINT_CLASSES = (32, 160, 512)
HELD_CLASSES = (64, 64, 96)
SHARED_HELD_CLASSES = (64, 64, 14)


def size_flags(size_class: int) -> Tuple[str, ...]:
    """The compiler defines of one size class."""
    return (*(f"-DMJ_MAX_{name}={n}" for name, n in
              zip(("LINK", "NV", "NQ", "NU", "CHAIN", "POINTS", "HELD"),
                  (*SIZE_CLASSES[size_class], CHAIN_CLASSES[size_class],
                   POINT_CLASSES[size_class], HELD_CLASSES[size_class]))),
            f"-DMJ_SHARED_HELD={SHARED_HELD_CLASSES[size_class]}")


def size_class(model: Model) -> int:
    """The smallest size class ``model`` fits; raises beyond the largest."""
    need = (model.nlink, model.nv, model.nq, model.nu)
    for k, cap in enumerate(SIZE_CLASSES):
        if all(n <= c for n, c in zip(need, cap)):
            return k
    raise NotImplementedError(f"(links, dofs, qpos, actuators) {need} exceed every size class "
                              f"{SIZE_CLASSES}")


def build_library(source: str, compiler_cmd, build_dir: Path, csrc: Path = CSRC) -> Path:
    """Compile ``<csrc>/<source>`` into a shared library in ``build_dir``,
    unless a build of the same sources (every header in ``csrc``) and
    flags is there. Processes that want the same build at once (the ranks
    of a data-parallel run) take a file lock: one compiles, the others wait
    and load its library."""
    csrc = Path(csrc)
    digest = hashlib.sha256()
    for path in [*sorted(csrc.glob("*.h")), csrc / source]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(compiler_cmd).encode())
    out = Path(build_dir) / f"lib{Path(source).stem}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # built by the process that held the lock
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [*compiler_cmd, "-o", str(tmp), str(csrc / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"build failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda)")
    return path


def read_layout(lib: ctypes.CDLL, fn: str = "mj_layout",
                names: Tuple[str, ...] = LAYOUT_NAMES) -> Dict[str, int]:
    """The packed-table layout the library was compiled with."""
    buf = (ctypes.c_int * len(names))()
    func = getattr(lib, fn)
    func.argtypes = [ctypes.c_void_p]
    func.restype = ctypes.c_int
    n = func(ctypes.cast(buf, ctypes.c_void_p))
    if n != len(names):
        raise RuntimeError(f"{fn} has {n} entries, expected {len(names)}")
    return dict(zip(names, list(buf)))


def read_newton_layout(lib: ctypes.CDLL) -> Dict[str, int]:
    return read_layout(lib, "mj_newton_layout", NEWTON_LAYOUT_NAMES)


def read_warp_layout(lib: ctypes.CDLL) -> Dict[str, int]:
    return read_layout(lib, "mj_warp_layout", WARP_LAYOUT_NAMES)


def pack_tables(model: Model, L: Dict[str, int], ext: bool = False,
                max_points: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """The model as the kernel reads it: (f32 table, i32 table) in the
    layout ``L``; ``ext`` adds the stages of K3's build (servos,
    frictionloss, the tendon block after the pairs). Raises for a model
    outside the kernel's feature set or its compile-time maxima;
    ``max_points``: K1's slots for contact points (``MAX_POINTS`` of its
    warp layout), which a model's points must not exceed (K3's packs take
    none: any number of points)."""
    soa.check_supported(model)
    if max_points is not None and num_contact_candidates(model) > max_points:
        raise NotImplementedError(f"{num_contact_candidates(model)} contact points exceed the "
                                  f"kernel's {max_points}")
    if not ext and soa.needs_ext(model):
        raise NotImplementedError("tendons, frictionloss, gain/bias actuators and box contacts "
                                  "run in kernel K3's and K4's builds")
    nlink, nq, nv, nu = model.nlink, model.nq, model.nv, model.nu
    for n, cap, what in ((nlink, "MAX_LINK", "links"), (nv, "MAX_NV", "dofs"),
                         (nq, "MAX_NQ", "qpos"), (nu, "MAX_NU", "actuators")):
        if n > L[cap]:
            raise NotImplementedError(f"{n} {what} exceed the kernel's {L[cap]}")
    if nlink < 1:
        raise ValueError("model has no links")
    tab = soa_tables(model)
    dt = np.float32(model.dt / model.n_substeps)
    pairs = [(kind, tab_k, p) for kind, tab_k in pair_groups(model).kinds
             for p in range(len(tab_k["gi"]))]

    ten_i, ten_f = _tendon_block(model) if ext else (np.zeros(0, np.int32),
                                                      np.zeros(0, np.float32))
    n_pi, n_pf = L["I_PAIR"] + L["PAIR_I"] * len(pairs), L["F_PAIR"] + L["PAIR_F"] * len(pairs)
    mi = np.zeros(n_pi + ten_i.size, np.int32)
    mf = np.zeros(n_pf + ten_f.size, np.float32)
    mi[n_pi:], mf[n_pf:] = ten_i, ten_f

    def put_i(name, values):
        v = np.asarray(values, np.int32).reshape(-1)
        mi[L[name] : L[name] + v.size] = v

    def put_f(name, values):
        v = np.asarray(values, np.float32).reshape(-1)
        mf[L[name] : L[name] + v.size] = v

    ratio = model.contact_force_cap_ratio
    ks, cap = np.float32(model.contact_stiffness), np.float32(model.contact_depth_cap)
    has_fluid = model.density != 0.0 or model.viscosity != 0.0
    put_i("I_NLINK", [nlink, nq, nv, nu, len(pairs), int(ratio > 0)])
    put_i("I_HAS_FLUID", [int(has_fluid)])
    put_i("I_PARENT", model.link_parent)
    put_i("I_TYPE", model.link_jnt_type)
    put_i("I_QADR", model.link_qadr)
    put_i("I_VADR", model.link_vadr)
    put_i("I_LIMITED", np.asarray(model.jnt_limited) > 0)
    put_i("I_DOFLINK", tab.dof_link)
    put_i("I_LAM", tab.lam)
    put_i("I_ACTV", model.act_vadr)
    put_i("I_ACTLIM", np.asarray(model.act_ctrllimited) > 0)

    put_f("F_GRAV", model.gravity)
    put_f("F_KS", [ks, model.contact_damping, cap, np.float32(ratio) * ks * cap,
                   model.friction_vel])
    put_f("F_LPOS", model.link_pos)
    put_f("F_LQUAT", model.link_quat)
    put_f("F_AXIS", model.jnt_axis)
    put_f("F_ANCHOR", model.jnt_anchor)
    put_f("F_REF", model.jnt_ref)
    put_f("F_RANGE", model.jnt_range)
    put_f("F_STIFF", model.jnt_stiffness)
    put_f("F_SPRINGREF", model.jnt_springref)
    put_f("F_MASS", model.link_mass)
    put_f("F_COM", model.link_com)
    put_f("F_EIGD", np.stack([d for d, _ in tab.inertia_eig]))
    put_f("F_EIGQ", np.stack([Q.T for _, Q in tab.inertia_eig]))  # columns
    put_f("F_CMASS", tab.c_mass)
    damping = np.asarray(model.dof_damping, np.float32)
    put_f("F_DAMP", damping)
    put_f("F_EXTRA", np.asarray(model.dof_armature, np.float32) + dt * damping)
    if model.dof_limit_stiffness is not None:
        limc = np.asarray(model.dof_limit_damping, np.float32)
        put_f("F_LIMK", model.dof_limit_stiffness)
        put_f("F_LIMC", limc)
        put_f("F_LIMDTC", dt * limc)
    put_f("F_GEAR", model.act_gear)
    if nu:
        put_f("F_CLO", np.asarray(model.act_ctrlrange)[:, 0])
        put_f("F_CHI", np.asarray(model.act_ctrlrange)[:, 1])
    if has_fluid:
        put_f("F_IQUAT", model.link_iquat)
        for i in range(nlink):
            if float(model.link_mass[i]) > 0.0:
                lin, ang, quad_f, quad_t = soa.fluid_coefficients(model, i)
                o = L["F_FLUID"] + L["FLUID_F"] * i
                mf[o : o + L["FLUID_F"]] = [lin, ang, *quad_f, *quad_t]

    if ext:
        if model.act_gainprm is not None:
            put_i("I_HAS_GAINBIAS", [1])
            put_i("I_ACTQ", model.act_qadr)
            put_f("F_GAIN", np.asarray(model.act_gainprm)[:, 0])
            put_f("F_BIAS", model.act_biasprm)
        if soa.has_frictionloss(model):
            put_i("I_HAS_FRIC", [1])
            put_f("F_FRIC", model.dof_frictionloss)
            put_f("F_FVEPS", [model.dof_friction_vel])
        if ten_i.size:
            put_i("I_NTEN", [ten_i[0]])
            put_i("I_TEN_I", [n_pi])
            put_i("I_TEN_F", [n_pf])

    for k, (kind, tab_k, p) in enumerate(pairs):
        gi, gj = int(tab_k["gi"][p]), int(tab_k["gj"][p])
        o = L["I_PAIR"] + L["PAIR_I"] * k
        mi[o : o + 3] = [_KIND_CODE[kind], tab_k["li"][p], tab_k["lj"][p]]
        o = L["F_PAIR"] + L["PAIR_F"] * k
        mf[o : o + L["PAIR_GJ"]] = np.concatenate(
            [[tab_k["mu"][p]], _geom_row(model, gi)])
        # geom j: a plane's world normal and point, or its row
        gj_row = (np.concatenate(plane_normal_point(model, gj)) if kind in soa._PLANE_KINDS
                  else _geom_row(model, gj))
        mf[o + L["PAIR_GJ"] : o + L["PAIR_GJ"] + gj_row.size] = gj_row
    return mf, mi


def _geom_row(model: Model, g: int) -> np.ndarray:
    """Size (3: radius and half length, or a box's half-sizes), local pos
    (3) and quat (4) of geom ``g``."""
    size = np.asarray(model.geom_size[g], np.float32)
    return np.concatenate([size[:3], model.geom_pos[g], model.geom_quat[g]]).astype(np.float32)


def _tendon_block(model: Model) -> Tuple[np.ndarray, np.ndarray]:
    """The tendon block of K3's tables (mj_substep.h): ints ``nt, qptr,
    qidx, vptr, vidx`` and floats ``P (nt, 8), qval, vval``, the nonzeros
    of Jq and Jv in compressed rows; empty without tendons."""
    if model.tendon_Jq is None:
        return np.zeros(0, np.int32), np.zeros(0, np.float32)
    Jq, Jv, P = soa.tendon_params(model)
    ints, floats = [[Jq.shape[0]]], [P.T.reshape(-1)]
    for J in (Jq, Jv):
        rows, cols = np.nonzero(J)
        ptr = np.searchsorted(rows, np.arange(J.shape[0] + 1))
        ints += [ptr, cols]
    for J in (Jq, Jv):
        floats.append(J[np.nonzero(J)])
    return (np.concatenate(ints).astype(np.int32), np.concatenate(floats).astype(np.float32))


def _impedance_block(solref, solimp) -> list:
    """k, b and the solimp spline constants of a row (mj_newton.h)."""
    k, b = soa_newton._kb_static(solref, solimp)
    dmin, dmax, width, mid, power = (float(v) for v in solimp)
    return [k, b, dmin, dmax, max(width, soa_newton._MINVAL), mid, power,
            1.0 / mid ** (power - 1.0), 1.0 / (1.0 - mid) ** (power - 1.0), dmax - dmin]


def pack_newton_tables(model: Model, L: Dict[str, int], NL: Dict[str, int],
                       ext: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """The Newton rows' static constants as K2 (and, with ``ext``, K4)
    reads them: (f32 table, i32 table) in the layout ``NL``, per limited
    1-dof joint and per contact pair in K1's pair order. Fills the model's
    solver parameters first; raises for a model beyond the kernel's maxima.
    Both kernels hold the contact rows inside their margin, at most
    ``MAX_HELD`` per env-substep, and count a substep that has more (the
    wrappers raise). K2's models must hold all of theirs: their contact
    points plus their limited joints may not exceed ``MAX_HELD``. K4's
    may have any number of contact points (pen: 406).

    A pair's Jacobian spans the dofs of ``li``'s chain that are not on
    ``lj``'s and those of ``lj``'s that are not on ``li``'s, each with its
    sign (+1 and -1: the point's velocity on ``li`` minus that on ``lj``).
    The dofs the two chains share can go: a shared dof's point-Jacobian
    columns on the two links are one expression at the same contact point,
    so the plain version's ``a - b`` and its torsional ``w - cdof``
    (physics/soa_newton.py ``_contact_rows``) are exactly zero there and
    add exactly nothing to the rows, the gradient, H or the cost."""
    ensure_solver_params(model)
    tables = tree_tables(model)
    lim = [(int(l), int(qa), int(va)) for l, qa, va in
           zip(tables.hinge_slide_link, tables.hinge_slide_q, tables.hinge_slide_v)
           if model.jnt_limited[l] > 0]
    n_cand = num_contact_candidates(model)
    if not ext and n_cand + len(lim) > NL["MAX_HELD"]:
        raise NotImplementedError(f"{n_cand} contact points and {len(lim)} limited joints exceed "
                                  f"the kernel's {NL['MAX_HELD']} held rows")
    pairs = [(tab_k, p) for _, tab_k in pair_groups(model).kinds for p in range(len(tab_k["gi"]))]
    ni = np.zeros(NL["N_I_PAIR"] + NL["NPAIR_I"] * len(pairs), np.int32)
    nf = np.zeros(NL["N_F_PAIR"] + NL["NPAIR_F"] * len(pairs), np.float32)
    ni[NL["N_I_NLIM"]] = len(lim)
    for r, (link, qadr, vadr) in enumerate(lim):
        ni[NL["N_I_LIM"] + NL["LIM_I"] * r :][:2] = [qadr, vadr]
        lo, hi = model.jnt_range[link]
        row = _impedance_block(model.jnt_solref[link], model.jnt_solimp[link]) + [
            lo, hi, max(float(model.dof_invweight0[vadr]), 0.0)]
        nf[NL["N_F_LIM"] + NL["LIM_F"] * r :][: NL["LIM_F"]] = row
    tor = np.asarray(model.geom_friction_tor)
    for k, (tab_k, p) in enumerate(pairs):
        gi, gj = int(tab_k["gi"][p]), int(tab_k["gj"][p])
        li, lj, mu = int(tab_k["li"][p]), int(tab_k["lj"][p]), float(tab_k["mu"][p])
        solref, solimp, margin, invw, condim = soa_newton.contact_params(model, gi, gj, mu)
        ci, cj = set(soa_newton._chain(model, li)), set(soa_newton._chain(model, lj))
        chain = sorted(ci ^ cj)
        if not chain:
            raise NotImplementedError(f"pair ({gi}, {gj}): no moving link, or both on one chain")
        if len(chain) > NL["MAX_CHAIN"]:
            raise NotImplementedError(f"{len(chain)} chain dofs exceed the kernel's {NL['MAX_CHAIN']}")
        nfacet = 1 if condim == 1 else (6 if condim >= 4 else 4)
        scale = 1.0 if condim == 1 else soa_newton.pyramid_scale(mu)
        o = NL["N_I_PAIR"] + NL["NPAIR_I"] * k
        ni[o : o + 2 + len(chain)] = [nfacet, len(chain), *chain]
        o += 2 + NL["MAX_CHAIN"]
        ni[o : o + len(chain)] = [1 if j in ci else -1 for j in chain]
        row = _impedance_block(solref, solimp) + [
            margin, max(invw, 0.0), mu, max(float(tor[gi]), float(tor[gj])), scale]
        o = NL["N_F_PAIR"] + NL["NPAIR_F"] * k
        nf[o : o + NL["NPAIR_F"]] = row
    return nf, ni


def check_tendons(model: Model, warp_layout: Dict[str, int]) -> None:
    """Raise if ``model`` has more fixed tendons than an ``EXT`` warp body's
    scratch holds (``MAX_TEN`` of its warp layout)."""
    n_ten = 0 if model.tendon_Jq is None else len(model.tendon_Jq)
    if n_ten > warp_layout["MAX_TEN"]:
        raise NotImplementedError(f"{n_ten} tendons exceed the kernel's {warp_layout['MAX_TEN']}")


def check_optional(name: str, x: Optional[torch.Tensor], dtype: torch.dtype, shape: tuple,
                   device: torch.device) -> None:
    """Raise unless ``x`` is None or a contiguous ``dtype`` tensor of
    ``shape`` on ``device`` (the kernels' optional inputs and outputs)."""
    if x is not None and (x.dtype != dtype or x.device != device or tuple(x.shape) != shape
                          or not x.is_contiguous()):
        raise ValueError(f"{name} must be contiguous {dtype} {shape} on {device}")


def check_inputs(model: Model, q: torch.Tensor, qd: torch.Tensor, ctrl: torch.Tensor) -> int:
    """Device, dtype, shape and layout checks; returns the batch size."""
    if q.dim() != 2:
        raise ValueError(f"q must be (nq, B), got {tuple(q.shape)}")
    B = q.shape[1]
    for name, x, rows in (("q", q, model.nq), ("qd", qd, model.nv), ("ctrl", ctrl, model.nu)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != (rows, B):
            raise ValueError(f"{name} must be {(rows, B)}, got {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous batch-last")
    if B < 1:
        raise ValueError("empty batch")
    return B


# The physics kernels' launch parameters (each .cu file's ``<name>_launch``)
# in the order each takes those it has: only the Newton kernels (K2, K4)
# take ``NEWTON_PARAMS``, only K3 and K4 ``delta`` (the link offsets), only
# K4 ``slab``. ``mj_poses_launch`` takes ``POSES_PARAMS`` (``mj_poses_host``
# the same without the stream). :func:`argtypes` gives each its C type.
LAUNCH_PARAMS = ("mf", "mi", "nf", "ni", "q", "qd", "ctrl", "delta", "q_out", "qd_out", "picks",
                 "overflow", "stats", "slab", "B", "n_sub", "iters", "dt", "warps", "stream")
NEWTON_PARAMS = frozenset(("nf", "ni", "picks", "overflow", "stats", "iters"))
POSES_PARAMS = ("mf", "mi", "site_pos", "site_link", "nsite", "q", "sq0", "sq1", "delta", "sd0",
                "sd1", "sd2", "pos", "quat", "sites", "B", "stream")
_CTYPES = {**dict.fromkeys(("B", "n_sub", "iters", "warps", "nsite"), ctypes.c_int),
           **dict.fromkeys(("sq0", "sq1", "sd0", "sd1", "sd2"), ctypes.c_longlong),
           "dt": ctypes.c_float}


def argtypes(params) -> list:
    """The ctypes of a launch function's parameters, by name (a pointer or
    the stream: ``c_void_p``)."""
    return [_CTYPES.get(p, ctypes.c_void_p) for p in params]


class Library:
    """A loaded kernel library and the layouts it exports, each read at
    first use (None where the library exports none)."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib

    @cached_property
    def layout(self) -> Dict[str, int]:
        return read_layout(self.lib)

    @cached_property
    def newton_layout(self) -> Optional[Dict[str, int]]:
        return read_newton_layout(self.lib) if hasattr(self.lib, "mj_newton_layout") else None

    @cached_property
    def warp_layout(self) -> Optional[Dict[str, int]]:
        return read_warp_layout(self.lib) if hasattr(self.lib, "mj_warp_layout") else None


def load_library(source: str, size: int, signatures: Dict[str, tuple], flags: tuple = (),
                 csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Library:
    """``<csrc>/<source>`` built by nvcc in size class ``size``, ``flags``
    after the class's (:func:`build_library`: once per sources and flags),
    and loaded, each function of ``signatures`` (name: parameter names)
    declared to take those and return an int."""
    path = build_library(source, (nvcc_path(), *NVCC_FLAGS, *size_flags(size), *flags),
                         Path(build_dir), Path(csrc))
    lib = ctypes.CDLL(str(path))
    for fn, params in signatures.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes(params), ctypes.c_int
    return Library(lib)


_TABLES = "_kernel_tables"  # a model's uploaded tables: {(device, reader or packing): tensors}


def _cached(model: Model, key: tuple, make) -> Tuple[torch.Tensor, ...]:
    cache = model.__dict__.setdefault(_TABLES, {})
    got = cache.get(key)
    if got is None:
        got = cache[key] = make()
    return got


def _upload(device: torch.device, arrays) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def set_tables(model: Model, kernel, device: torch.device, tables) -> None:
    """Give ``model`` a table cache of its own holding ``tables`` as what
    ``kernel`` reads on ``device`` (a copy of a model shares its
    original's until then): how a check plants faulty tables."""
    model.__dict__[_TABLES] = {(str(device), kernel.label): tuple(tables)}


def drop_tables(model: Model) -> None:
    """Drop ``model``'s table cache: each kernel packs anew at its next use."""
    model.__dict__.pop(_TABLES, None)


def _ptr(x: Optional[torch.Tensor]) -> int:
    return 0 if x is None else x.data_ptr()


class _Wrapper:
    """A kernel wrapper's library per size class and its entry in a
    model's table cache; ``csrc`` and ``build_dir``: where its sources are
    read and its libraries built."""

    sizes: Tuple[int, ...] = tuple(range(len(SIZE_CLASSES)))

    def __init__(self, csrc: Path = CSRC, build_dir: Path = BUILD_DIR):
        self.csrc, self.build_dir = Path(csrc), Path(build_dir)
        self.source = f"mjrl_tpu_torch/csrc/{self.file}"
        self.launches = 0
        self._libs: Dict[int, Library] = {}

    def build(self, size: int = 0) -> Library:
        """Build (or find) and load the library of size class ``size``, once."""
        lib = self._libs.get(size)
        if lib is None:
            if size not in self.sizes:
                raise NotImplementedError(f"{self.label} has the size classes {self.sizes} only")
            lib = self._libs[size] = load_library(self.file, size, self.signatures,
                                                  csrc=self.csrc, build_dir=self.build_dir)
        return lib

    def tables(self, model: Model, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """``model``'s tables as this kernel reads them on ``device``, packed
        and uploaded at its first use; K3, K4 and the pose kernel share one
        upload of the model's ext packing."""
        return _cached(model, (str(device), self.label),
                       lambda: self._pack(model, device, self.build(size_class(model))))

    def _packed(self, model: Model, device: torch.device, lib: Library, ext: bool,
                max_points: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
        return _cached(model, (str(device), "pack", ext, max_points), lambda: _upload(
            device, pack_tables(model, lib.layout, ext=ext, max_points=max_points)))


# Per (solver, ext): label, C name (``<name>_launch``, ``__global__``
# ``<name>_kernel``, Newton ``<name>_occupancy``), source, size classes (K2:
# the small one, as no Newton model without Adroit's stages needs more)
# and the TPU code it replaces.
_SPECS = {
    ("penalty", False): ("K1", "mj_multistep", "mj_kernel.cu", (0, 1, 2),
                         "mjrl_tpu/physics/pkernel.py:79"),
    ("newton", False): ("K2", "mj_newton", "mj_newton_kernel.cu", (0,),
                        "mjrl_tpu/physics/pkernel.py:79 (soa_newton.py:338)"),
    ("penalty", True): ("K3", "mj_ext", "mj_ext_kernel.cu", (0, 1, 2),
                        "mjrl_tpu/physics/pkernel.py:49 (_kernel_body_ext)"),
    ("newton", True): ("K4", "mj_ext_newton", "mj_ext_newton_kernel.cu", (0, 1, 2),
                       "mjrl_tpu/physics/pkernel.py:49 (_kernel_body_ext; soa_newton.py:338)"),
}


class PhysicsKernel(_Wrapper):
    """The physics kernel of ``solver`` (``"penalty"`` or ``"newton"``) and
    ``ext`` (Adroit's stages: link offsets, box contacts, servos, tendons,
    frictionloss): ``(q (nq,B), qd (nv,B), ctrl (nu,B)[, link_delta
    (3 nlink, B)]) -> (q, qd)`` after ``n_frames * model.n_substeps``
    substeps, in the smallest size class the model fits, one warp per env
    and ``warps_per_block`` envs a block (default: :meth:`launch_warps`).
    K1 caps a model's contact points (``MAX_POINTS``). The Newton kernels
    take ``picks``, an int32 ``(n_sub * solver_iters, B)`` tensor on the
    device of ``q`` for each iteration's line-search fraction index (CUDA
    only), and count an env-substep with more contact rows inside their
    margin than the build holds (``MAX_HELD``) on the device, which
    :meth:`check` reads and raises on (the env calls it at the end of each
    rollout); a build that keeps only its first ``SHARED_HELD`` held rows
    in shared memory (K4's Adroit class) takes a slab in device memory for
    the rest (:meth:`slab`). The counters, the check and the slab do
    nothing for the penalty kernels."""

    def __init__(self, solver: str, ext: bool, csrc: Path = CSRC, build_dir: Path = BUILD_DIR):
        self.label, self.name, self.file, self.sizes, self.replaces = _SPECS[solver, ext]
        self.solver, self.ext, self.newton = solver, ext, solver == "newton"
        self.symbol, self.launch_fn = f"{self.name}_kernel", f"{self.name}_launch"
        self.params = tuple(p for p in LAUNCH_PARAMS if (self.newton or p not in NEWTON_PARAMS)
                            and (ext or p != "delta") and (ext and self.newton or p != "slab"))
        self.signatures = {self.launch_fn: self.params,
                           **({f"{self.name}_occupancy": ("warps",)} if self.newton else {})}
        # picks the launch's arguments, in its C order, from __call__'s list:
        # the tables, then LAUNCH_PARAMS past them
        given = (*self.params[:4 if self.newton else 2], *LAUNCH_PARAMS[4:])
        self._order = operator.itemgetter(*(given.index(p) for p in self.params))
        super().__init__(csrc, build_dir)
        # per device: the overflow count (int32) and the stats (int64, STAT_NAMES)
        self._counters: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._counted: set = set()  # devices whose stats a traced launch added to
        self._occupancy: Dict[Tuple[int, int], int] = {}
        self._slabs: Dict[str, torch.Tensor] = {}  # per device: held rows past SHARED_HELD

    def _pack(self, model: Model, device: torch.device, lib: Library):
        wl = lib.warp_layout
        if self.ext:
            check_tendons(model, wl)
        out = self._packed(model, device, lib, self.ext, wl["MAX_POINTS"] or None)
        if self.newton:
            out += _upload(device, pack_newton_tables(model, lib.layout, lib.newton_layout,
                                                      ext=self.ext))
        return out

    def warps_per_block(self, size: int) -> int:
        """The most envs (warps) a block of size class ``size``'s build
        holds in shared memory; raises if not even one fits."""
        wl = self.build(size).warp_layout
        warps = min(wl["MAX_WARPS"], SHARED_BYTES_PER_BLOCK // wl["BYTES"])
        if warps < 1:
            raise NotImplementedError(f"{self.name}'s env state in size class {SIZE_CLASSES[size]} "
                                      f"takes {wl['BYTES']} bytes of shared memory, more than a "
                                      f"block's {SHARED_BYTES_PER_BLOCK}")
        return warps

    def launch_warps(self, size: int, batch: int, device: torch.device,
                     warps_per_block: Optional[int] = None) -> int:
        """Warps (envs) a block of a launch of ``batch`` envs: the fewest that
        spread them over the SMs in one wave, within :meth:`warps_per_block`;
        or ``warps_per_block``, which must be in 1 to that."""
        most = self.warps_per_block(size)
        if warps_per_block is not None:
            if not 1 <= int(warps_per_block) <= most:
                raise ValueError(f"warps_per_block must be in 1..{most}, got {warps_per_block}")
            return int(warps_per_block)
        return min(most, -(-batch // self.sm_count(device)))

    def counters(self, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The device's overflow count (int32: env-substeps that held too
        many rows) and stats (int64, ``STAT_NAMES``)."""
        key = str(device)
        if key not in self._counters:
            self._counters[key] = (torch.zeros(1, dtype=torch.int32, device=device),
                                   torch.zeros(len(STAT_NAMES), dtype=torch.int64, device=device))
        return self._counters[key]

    def stats(self, device: torch.device) -> int:
        """The address of the device's stats buffer while tracing is on,
        else 0: the kernel then counts nothing."""
        if not trace.enabled():
            return 0
        self._counted.add(str(device))
        return self.counters(device)[1].data_ptr()

    def slab(self, size: int, batch: int, device: torch.device) -> int:
        """The address of the device's slab for ``batch`` envs' held rows past
        the build's ``SHARED_HELD`` (grown to the largest batch), or 0."""
        NL = self.build(size).newton_layout
        need = NL and batch * (NL["MAX_HELD"] - NL["SHARED_HELD"]) * NL["ROW_BYTES"]
        if not need:
            return 0
        key = str(device)
        if key not in self._slabs or self._slabs[key].numel() < need:
            self._slabs[key] = torch.empty(need, dtype=torch.uint8, device=device)
        return self._slabs[key].data_ptr()

    def count_launch(self, B: int, n_sub: int, held: Optional[List[torch.Tensor]] = None) -> None:
        """Traced: a Newton launch's env-substeps, and the plain version's
        held rows (``held``: one ``(B,)`` count per substep) where it ran."""
        if not self.newton:
            return
        trace.count(f"{self.label}.env_substeps", B * n_sub)
        if held:
            rows = torch.stack(held)
            trace.count(f"{self.label}.held_rows", int(rows.sum()))
            trace.peak(f"{self.label}.held_rows_max", int(rows.max()))

    def sm_count(self, device: torch.device) -> int:
        return torch.cuda.get_device_properties(device).multi_processor_count

    def occupancy(self, size: int, warps: int) -> int:
        """Blocks of ``warps`` envs one SM holds at once (the build's
        ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), asked once."""
        if (size, warps) not in self._occupancy:
            fn = f"{self.name}_occupancy"
            n = getattr(self.build(size).lib, fn)(warps)
            if n < 1:
                raise RuntimeError(f"{fn}({warps}): CUDA error {-n}")
            self._occupancy[size, warps] = n
        return self._occupancy[size, warps]

    @staticmethod
    def launch_waves(batch: int, warps: int, sms: int, per_sm: int) -> Tuple[int, int]:
        """``(blocks, waves)`` of ``batch`` envs, ``warps`` a block, on
        ``sms`` SMs that each hold ``per_sm`` blocks at once."""
        blocks = -(-batch // warps)
        return blocks, -(-blocks // (sms * per_sm))

    def count_waves(self, size: int, B: int, warps: int, device: torch.device) -> None:
        """Traced: a Newton launch, its blocks and its waves."""
        if not (self.newton and trace.enabled()):
            return
        blocks, waves = self.launch_waves(B, warps, self.sm_count(device),
                                          self.occupancy(size, warps))
        trace.count(f"{self.label}.launches")
        trace.count(f"{self.label}.blocks", blocks)
        trace.count(f"{self.label}.waves", waves)

    def check(self) -> None:
        """Raise ``RuntimeError`` if a launch so far held more contact rows
        than the build's ``MAX_HELD``: one read (``K2.check``, ``K4.check``)
        that also takes the stats a traced launch added into the tracer's
        counters (``K4.held_rows``, ...) and peak (``K4.held_rows_max``)."""
        for key, (over, stats) in self._counters.items():
            if key in self._counted:
                self._counted.discard(key)
                n, *values = trace.host_read(f"{self.label}.check",
                                             torch.cat([over.to(torch.int64), stats]))
                stats.zero_()
                for name, v in zip(STAT_NAMES, values):
                    if name == "held_rows_max":
                        trace.peak(f"{self.label}.{name}", v)
                    else:
                        trace.count(f"{self.label}.{name}", v)
            else:
                n, = trace.host_read(f"{self.label}.check", over)
            if n:
                over.zero_()
                raise RuntimeError(
                    f"{self.name}: {n} env-substeps on {key} held more contact rows inside "
                    f"their margin than the build's MAX_HELD; those substeps are wrong")

    def __call__(self, model: Model, q: torch.Tensor, qd: torch.Tensor, ctrl: torch.Tensor,
                 n_frames: int = 1, link_delta: Optional[torch.Tensor] = None,
                 picks: Optional[torch.Tensor] = None, warps_per_block: Optional[int] = None):
        B = check_inputs(model, q, qd, ctrl)
        if model.constraint_solver != self.solver:
            raise ValueError(f"{self.label} runs models with constraint_solver={self.solver!r}")
        stray = "link_delta" if link_delta is not None and not self.ext else "picks"
        if stray == "link_delta" or picks is not None and not self.newton:
            raise TypeError(f"{self.label} takes no {stray}")
        if self.ext:
            check_optional("link_delta", link_delta, torch.float32, (3 * model.nlink, B), q.device)
        elif soa.needs_ext(model):
            raise ValueError("tendons, frictionloss, gain/bias actuators and box contacts run in "
                             f"{KERNELS[self.solver, True].label}")
        n_sub = n_frames * model.n_substeps
        if q.device.type == "cpu":
            held = [] if self.newton and trace.enabled() else None
            out = soa.multistep(model, q, qd, ctrl, n_frames, link_delta=link_delta, held=held)
            self.count_launch(B, n_sub, held)
            return out
        if q.device.type != "cuda":
            raise ValueError(f"no {self.label} path for device {q.device}")
        dev, size = q.device, size_class(model)
        lib = self.build(size).lib
        warps = self.launch_warps(size, B, dev, warps_per_block)
        tables = self.tables(model, dev)
        iters, faults = 0, (0, 0, 0, 0)
        if self.newton:
            iters = int(model.solver_iters)
            check_optional("picks", picks, torch.int32, (n_sub * iters, B), dev)
            faults = (_ptr(picks), self.counters(dev)[0].data_ptr(), self.stats(dev),
                      self.slab(size, B, dev))
        q_out, qd_out = torch.empty_like(q), torch.empty_like(qd)
        dt = float(np.float32(model.dt / model.n_substeps))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, self.launch_fn)(*self._order((
                *map(torch.Tensor.data_ptr, tables), q.data_ptr(), qd.data_ptr(),
                ctrl.data_ptr(), _ptr(link_delta), q_out.data_ptr(), qd_out.data_ptr(), *faults,
                B, n_sub, iters, dt, warps, stream)))
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1
        self.count_launch(B, n_sub)
        self.count_waves(size, B, warps, dev)
        return q_out, qd_out


def pack_site_tables(model: Model) -> Tuple[np.ndarray, np.ndarray]:
    """The pose kernel's site table: (site_pos (nsite, 3) f32, site_link
    (nsite,) i32; -1 a world site)."""
    n = len(model.site_link)
    pos = np.asarray(model.site_pos if n else np.zeros((0, 3)), np.float32).reshape(n, 3)
    return np.ascontiguousarray(pos), np.asarray(model.site_link, np.int32).reshape(n)


class PoseKernel(_Wrapper):
    """The pose kernel: ``(q (B, nq)[, link_delta (B, nlink, 3)]) -> (pos
    (B, nlink, 3), quat (B, nlink, 4), sites (B, nsite, 3))``, every link's
    world pose and every site's world position as physics/engine.py's
    ``forward_kinematics`` and ``site_positions`` compute them, in one
    launch, one warp per env (``mj_poses.h``); for a CPU tensor that plain
    version (:meth:`plain`). ``q`` and ``link_delta`` are read through
    their strides (after a control step the env's ``q`` is the transposed
    view of K3's or K4's output); the three outputs are views of one new
    buffer. It reads K3's and K4's packing of the model and a site table
    (:func:`pack_site_tables`). Traced, each launch counts
    ``poses.kernel`` and each plain call ``poses.plain``."""

    label, name, file, symbol = "poses", "mj_poses", "mj_poses_kernel.cu", "mj_poses_kernel"
    replaces = "mjrl_tpu_torch/physics/engine.py forward_kinematics + site_positions"
    launch_fn, params = "mj_poses_launch", POSES_PARAMS
    signatures = {launch_fn: params}

    def _pack(self, model: Model, device: torch.device, lib: Library):
        return self._packed(model, device, lib, True) + _upload(device, pack_site_tables(model))

    @staticmethod
    def plain(model: Model, q: torch.Tensor, link_delta: Optional[torch.Tensor] = None):
        """The plain version, on any device."""
        trace.count("poses.plain")
        pos, quat = forward_kinematics(model, q, link_delta)
        return pos, quat, site_positions(model, pos, quat)

    def __call__(self, model: Model, q: torch.Tensor, link_delta: Optional[torch.Tensor] = None):
        if q.device.type == "cpu":
            return self.plain(model, q, link_delta)
        if q.device.type != "cuda":
            raise ValueError(f"no {self.name} path for device {q.device}")
        if q.dtype != torch.float32 or q.dim() != 2 or q.shape[1] != model.nq or q.shape[0] < 1:
            raise ValueError(f"q must be float32 (B, {model.nq}), got {q.dtype} {tuple(q.shape)}")
        B, nl, ns = q.shape[0], model.nlink, len(model.site_link)
        if link_delta is not None and (link_delta.dtype != torch.float32
                                       or tuple(link_delta.shape) != (B, nl, 3)
                                       or link_delta.device != q.device):
            raise ValueError(f"link_delta must be float32 {(B, nl, 3)} on {q.device}")
        lib = self.build(size_class(model)).lib
        mf, mi, site_pos, site_link = self.tables(model, q.device)
        pos, quat, sites = torch.empty(B * (7 * nl + 3 * ns), dtype=torch.float32,
                                       device=q.device).split([3 * B * nl, 4 * B * nl, 3 * B * ns])
        pos, quat, sites = pos.view(B, nl, 3), quat.view(B, nl, 4), sites.view(B, ns, 3)
        sd = (0, 0, 0) if link_delta is None else link_delta.stride()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.mj_poses_launch(
                mf.data_ptr(), mi.data_ptr(), site_pos.data_ptr(), site_link.data_ptr(), ns,
                q.data_ptr(), *q.stride(), _ptr(link_delta), *sd, pos.data_ptr(),
                quat.data_ptr(), sites.data_ptr(), B, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1
        trace.count("poses.kernel")
        return pos, quat, sites


K1, K2 = PhysicsKernel("penalty", False), PhysicsKernel("newton", False)
K3, K4 = PhysicsKernel("penalty", True), PhysicsKernel("newton", True)
KERNELS = {(k.solver, k.ext): k for k in (K1, K2, K3, K4)}  # the frame stepper's lookup
POSES = PoseKernel()
