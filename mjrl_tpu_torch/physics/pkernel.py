"""Kernel K1: a full control step of physics per launch, CUDA C++ on Hopper.

Replaces ``mjrl_tpu/physics/pkernel.py::multistep_pallas``, the Pallas TPU
mega-kernel. The source is ``mjrl_tpu_torch/csrc/``: ``mj_substep.h`` holds
the table-driven substep body, ``mj_kernel.cu`` the one-thread-per-env
``__global__`` wrapper and a plain C launch function. It is built with
``nvcc`` for ``sm_90a`` at first use into ``mjrl_tpu_torch/_build/`` (keyed
by a hash of the sources) and bound with ``ctypes``.

What bounds it on an H100: per-thread latency. A control step moves ~260
bytes per env and runs tens of thousands of dependent f32 operations over
per-thread arrays in local memory; at 1024 envs one thread per env fills 8
blocks of 128 threads on 132 SMs. The design keeps the state in
one thread for the whole control step (one launch per control step, no
intermediate in device memory) and leaves occupancy to later work.

:class:`MultistepKernel` is the wrapper: for a CUDA tensor it launches the
kernel or raises; for a CPU tensor it runs the plain version,
``physics/soa.py::multistep``. ``K1`` is the instance the frame stepper
calls; its ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mjrl_tpu_torch.physics import soa
from mjrl_tpu_torch.physics.model import Model
from mjrl_tpu_torch.physics.tables import pair_groups, plane_normal_point, soa_tables

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

# Names of the values mj_layout() writes, in its order (mj_substep.h).
LAYOUT_NAMES = (
    "MAX_LINK", "MAX_NV", "MAX_NQ", "MAX_NU", "PAIR_I", "PAIR_F",
    "I_NLINK", "I_NQ", "I_NV", "I_NU", "I_NPAIR", "I_HAS_FCAP",
    "I_PARENT", "I_TYPE", "I_QADR", "I_VADR", "I_LIMITED", "I_DOFLINK",
    "I_LAM", "I_ACTV", "I_ACTLIM", "I_PAIR",
    "F_GRAV", "F_KS", "F_KD", "F_CAP", "F_FCAP", "F_VREG", "F_LPOS",
    "F_LQUAT", "F_AXIS", "F_ANCHOR", "F_REF", "F_RANGE", "F_STIFF",
    "F_SPRINGREF", "F_MASS", "F_COM", "F_EIGD", "F_EIGQ", "F_CMASS",
    "F_DAMP", "F_EXTRA", "F_LIMK", "F_LIMC", "F_LIMDTC", "F_GEAR",
    "F_CLO", "F_CHI", "F_PAIR",
)
_KIND_CODE = {"sphere_plane": 0, "capsule_plane": 1}


def build_library(source: str, compiler_cmd, build_dir: Path) -> Path:
    """Compile ``csrc/<source>`` (with mj_substep.h) into a shared library
    in ``build_dir``, unless a build of the same sources and flags is there."""
    digest = hashlib.sha256()
    for name in ("mj_substep.h", source):
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(compiler_cmd).encode())
    out = Path(build_dir) / f"lib{Path(source).stem}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [*compiler_cmd, "-o", str(tmp), str(CSRC / source)]
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


def read_layout(lib: ctypes.CDLL) -> Dict[str, int]:
    """The packed-table layout the library was compiled with."""
    buf = (ctypes.c_int * len(LAYOUT_NAMES))()
    lib.mj_layout.argtypes = [ctypes.c_void_p]
    lib.mj_layout.restype = ctypes.c_int
    n = lib.mj_layout(ctypes.cast(buf, ctypes.c_void_p))
    if n != len(LAYOUT_NAMES):
        raise RuntimeError(f"layout has {n} entries, expected {len(LAYOUT_NAMES)}")
    return dict(zip(LAYOUT_NAMES, list(buf)))


def pack_tables(model: Model, L: Dict[str, int]) -> Tuple[np.ndarray, np.ndarray]:
    """The model as the kernel reads it: (f32 table, i32 table) in the
    layout ``L``. Raises for a model outside the kernel's feature set or
    its compile-time maxima."""
    soa.check_supported(model)
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

    mi = np.zeros(L["I_PAIR"] + L["PAIR_I"] * len(pairs), np.int32)
    mf = np.zeros(L["F_PAIR"] + L["PAIR_F"] * len(pairs), np.float32)

    def put_i(name, values):
        v = np.asarray(values, np.int32).reshape(-1)
        mi[L[name] : L[name] + v.size] = v

    def put_f(name, values):
        v = np.asarray(values, np.float32).reshape(-1)
        mf[L[name] : L[name] + v.size] = v

    ratio = model.contact_force_cap_ratio
    ks, cap = np.float32(model.contact_stiffness), np.float32(model.contact_depth_cap)
    put_i("I_NLINK", [nlink, nq, nv, nu, len(pairs), int(ratio > 0)])
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

    for k, (kind, tab_k, p) in enumerate(pairs):
        gi, gj = int(tab_k["gi"][p]), int(tab_k["gj"][p])
        o = L["I_PAIR"] + L["PAIR_I"] * k
        mi[o : o + 3] = [_KIND_CODE[kind], tab_k["li"][p], tab_k["lj"][p]]
        n, pp = plane_normal_point(model, gj)
        size = np.asarray(model.geom_size[gi], np.float32)
        row = np.concatenate([[tab_k["mu"][p], size[0], size[1]], model.geom_pos[gi],
                              model.geom_quat[gi], n, pp]).astype(np.float32)
        o = L["F_PAIR"] + L["PAIR_F"] * k
        mf[o : o + L["PAIR_F"]] = row
    return mf, mi


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


class MultistepKernel:
    """Wrapper of kernel K1: ``(q (nq,B), qd (nv,B), ctrl (nu,B)) -> (q, qd)``
    after ``n_frames * model.n_substeps`` substeps."""

    name = "mj_multistep"
    source = "mjrl_tpu_torch/csrc/mj_kernel.cu"
    replaces = "mjrl_tpu/physics/pkernel.py:79"

    def __init__(self):
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self._lib: Optional[ctypes.CDLL] = None
        self._layout: Optional[Dict[str, int]] = None

    def build(self) -> ctypes.CDLL:
        """Build (or find) and load the CUDA library."""
        if self._lib is None:
            t0 = time.perf_counter()
            path = build_library("mj_kernel.cu", (nvcc_path(), *NVCC_FLAGS), BUILD_DIR)
            lib = ctypes.CDLL(str(path))
            lib.mj_multistep_launch.argtypes = [ctypes.c_void_p] * 7 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
            lib.mj_multistep_launch.restype = ctypes.c_int
            self._layout = read_layout(lib)
            self._lib = lib
            self.build_seconds = time.perf_counter() - t0
        return self._lib

    def _tables(self, model: Model, device: torch.device):
        cache = model.__dict__.setdefault("_k1_tables", {})
        key = str(device)
        if key not in cache:
            mf, mi = pack_tables(model, self._layout)
            cache[key] = (torch.from_numpy(mf).to(device), torch.from_numpy(mi).to(device))
        return cache[key]

    def __call__(self, model: Model, q: torch.Tensor, qd: torch.Tensor,
                 ctrl: torch.Tensor, n_frames: int = 1):
        B = check_inputs(model, q, qd, ctrl)
        if q.device.type == "cpu":
            return soa.multistep(model, q, qd, ctrl, n_frames)
        if q.device.type != "cuda":
            raise ValueError(f"no K1 path for device {q.device}")
        lib = self.build()
        mf, mi = self._tables(model, q.device)
        q_out, qd_out = torch.empty_like(q), torch.empty_like(qd)
        n_sub = n_frames * model.n_substeps
        dt = float(np.float32(model.dt / model.n_substeps))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.mj_multistep_launch(
                mf.data_ptr(), mi.data_ptr(), q.data_ptr(), qd.data_ptr(),
                ctrl.data_ptr(), q_out.data_ptr(), qd_out.data_ptr(), B, n_sub, dt,
                stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1
        return q_out, qd_out


K1 = MultistepKernel()
