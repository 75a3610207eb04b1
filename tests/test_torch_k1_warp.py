"""Kernel K1's warp design on the CPU: its contact stage, its body against
the plain version, and the packers' caps of the warp bodies.

``mjrl_tpu_torch/csrc/mj_warp_penalty.h`` spreads one env's penalty
substep over the 32 lanes of a warp: lanes take the contact pairs, a warp
scan places each non-zero point wrench in a slot in narrow-phase order,
and each link's lane sums its slots. ``mj_host.cpp`` builds that same code
with g++ under the emulated warp, in the small and the large size class
(``pkernel.size_flags``), and these tests hold it: each link's wrench after
the contact stage (``mj_penalty_contacts_host``) bit for bit against a
sequential f32 sum, in point order, of every point's wrench computed alone
(with no point in contact, fewer than 32 and more than 32 in contact); one
control step of ant, walker2d, swimmer (fluid drag) and humanoid (the
sphere kinds, the large class) against the plain version
(physics/soa.py); and the packers' refusal of a model over K1's point cap
or of a K2 model whose points and limit rows exceed its held rows.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.physics import pkernel, probe, soa

torch.set_num_threads(1)

B = 4
# tests/test_torch_kernel_body.py's tolerances for K1's body against plain
# (swimmer: tests/test_torch_swimmer.py's)
TOL = {"q": dict(rtol=1e-5, atol=1e-5), "qd": dict(rtol=1e-4, atol=1e-4)}
TOL_SWIMMER = {"q": dict(rtol=0, atol=1e-5), "qd": dict(rtol=0, atol=1e-3)}


def _library(directory, size):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    path = pkernel.build_library("mj_host.cpp", ("g++", *pkernel.GXX_FLAGS,
                                                 *pkernel.size_flags(size)), directory)
    lib = ctypes.CDLL(str(path))
    P = ctypes.c_void_p
    lib.mj_multistep_host.argtypes = [P] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.mj_multistep_host.restype = ctypes.c_int
    lib.mj_penalty_contacts_host.argtypes = [P] * 4 + [ctypes.c_int] * 2 + [P] * 4
    lib.mj_penalty_contacts_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The host builds of the small and the large size class."""
    return {size: _library(tmp_path_factory.mktemp(f"k1warp{size}"), size) for size in (0, 1)}


def _penalty_layout(lib):
    buf = (ctypes.c_int * len(pkernel.WARP_LAYOUT_NAMES))()
    assert lib.mj_penalty_warp_layout(buf) == len(pkernel.WARP_LAYOUT_NAMES)
    return dict(zip(pkernel.WARP_LAYOUT_NAMES, buf))


def _tables(lib, model):
    return pkernel.pack_tables(model, pkernel.read_layout(lib),
                               max_points=_penalty_layout(lib)["MAX_POINTS"])


def _lying_humanoids(model, n, rng, lo, hi):
    """``(q, qd)`` of ``n`` humanoids lying in the floor, their hinges
    drawn in range, each with ``lo`` to ``hi`` contact points at depth > 0."""
    draws = 2048
    q = np.tile(np.asarray(model.default_qpos, np.float32)[:, None], (1, draws))
    for i in range(model.nlink):
        if model.link_jnt_type[i] == probe.HINGE and model.jnt_limited[i] > 0:
            q[model.link_qadr[i]] = rng.uniform(*model.jnt_range[i], draws)
    q[2] = rng.uniform(-0.05, 0.05, draws)
    q[3:7] = np.array([np.sqrt(0.5), 0.0, np.sqrt(0.5), 0.0], np.float32)[:, None]
    pos, quat = soa._fk(model, torch.as_tensor(q))
    depth = torch.cat([c.depth for c in soa._contact_candidates(model, pos, quat)])
    touching = (depth > 0).sum(dim=0).numpy()
    keep = np.flatnonzero((touching >= lo) & (touching <= hi))[:n]
    assert keep.size == n
    qd = rng.uniform(-0.1, 0.1, (model.nv, n)).astype(np.float32)
    return np.ascontiguousarray(q[:, keep]), qd


def _states(case, rng):
    """``(env, q, qd)``: ants at reset lifted off the floor (``none``), or
    humanoids lying in the floor with 8
    to 31 points in contact (``under_32``) or 33 or more (``over_32``)."""
    if case != "none":
        env = make("humanoid", horizon=2, device="cpu")
        lo, hi = (8, 31) if case == "under_32" else (33, 1000)
        return (env, *_lying_humanoids(env.model, B, rng, lo, hi))
    env = make("ant", horizon=2, device="cpu")
    state, _ = env.reset(B, torch.Generator().manual_seed(0))
    q, qd = state.q.T.numpy().copy(), state.qd.T.numpy().copy()
    q[2] += 2.0
    return env, np.ascontiguousarray(q), np.ascontiguousarray(qd)


@pytest.mark.parametrize("case", ["none", "under_32", "over_32"])
def test_contact_stage_sums_point_wrenches_in_order(libs, case):
    """Each link's wrench after the warp body's contact stage is, bit for
    bit, the sequential f32 sum in narrow-phase order of every contact
    point's wrench (+ on its link li, - on lj): the compaction keeps the
    non-zero ones in order, and the zeros it drops change no sum."""
    rng = np.random.default_rng(0)
    env, q, qd = _states(case, rng)
    m = env.model
    lib = libs[pkernel.size_class(m)]
    mf, mi = _tables(lib, m)
    bounds = {"none": (0, 0), "under_32": (8, 31), "over_32": (33, 1000)}[case]
    for e in range(q.shape[1]):
        points = np.zeros((pkernel.POINT_CLASSES[1], 6), np.float32)
        links = np.zeros((pkernel.POINT_CLASSES[1], 2), np.int32)
        f_ext = np.zeros((m.nlink, 6), np.float32)
        slots = np.zeros(1, np.int32)
        n = lib.mj_penalty_contacts_host(*(a.ctypes.data for a in (mf, mi, q, qd)), q.shape[1], e,
                                         *(a.ctypes.data for a in (points, links, f_ext, slots)))
        assert n == pkernel.num_contact_candidates(m)
        assert bounds[0] <= int(slots[0]) <= bounds[1], int(slots[0])
        assert int(slots[0]) == int((points[:n] != 0).any(axis=1).sum())
        want = np.zeros((m.nlink, 6), np.float32)
        for p in range(n):
            li, lj = links[p]
            if li >= 0:
                want[li] = want[li] + points[p]
            if lj >= 0:
                want[lj] = want[lj] - points[p]
        np.testing.assert_array_equal(f_ext.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name", ["ant", "walker2d", "swimmer", "humanoid"])
def test_warp_body_matches_plain_one_control_step(libs, name):
    """One control step of K1's warp body from warmed states (humanoid:
    half of them folded so a pair of links overlaps) against the plain
    version from the same state."""
    env = make(name, horizon=2, device="cpu")
    m = env.model
    lib = libs[pkernel.size_class(m)]
    mf, mi = _tables(lib, m)
    dt = float(np.float32(m.dt / m.n_substeps))

    def run(q, qd, ctrl):
        q_out, qd_out = np.empty_like(q), np.empty_like(qd)
        assert lib.mj_multistep_host(*(a.ctypes.data for a in (mf, mi, q, qd, ctrl, q_out, qd_out)),
                                     q.shape[1], env.frame_skip * m.n_substeps, dt) == 0
        return q_out, qd_out

    rng = np.random.default_rng(1)
    state, _ = env.reset(B, torch.Generator().manual_seed(1))
    q, qd = state.q.T.numpy().copy(), state.qd.T.numpy().copy()
    for _ in range(4):
        q, qd = run(q, qd, rng.uniform(-1, 1, (m.nu, B)).astype(np.float32))
    if name == "humanoid":
        q[:, B // 2 :], qd[:, B // 2 :] = probe.overlapping_states(m, B - B // 2, rng)
    q, qd = np.ascontiguousarray(q), np.ascontiguousarray(qd)
    ctrl = rng.uniform(-1, 1, (m.nu, B)).astype(np.float32)
    got = run(q, qd, ctrl)
    want = soa.multistep(m, *(torch.as_tensor(x) for x in (q, qd, ctrl)), env.frame_skip)
    tol = TOL_SWIMMER if name == "swimmer" else TOL
    for k, g, w in zip(("q", "qd"), got, want):
        np.testing.assert_allclose(g, w.numpy(), **tol[k], err_msg=k)


def test_packers_refuse_models_over_the_warp_caps(libs):
    """K1's warp layout holds each class's point cap; a model with more
    contact points than K1's slots is refused, and so is a K2 model whose
    contact points and limited joints exceed its held rows."""
    for size, lib in libs.items():
        wl = _penalty_layout(lib)
        assert wl["MAX_POINTS"] == pkernel.POINT_CLASSES[size]
        assert wl["BYTES"] * wl["MAX_WARPS"] <= pkernel.SHARED_BYTES_PER_BLOCK
    humanoid = make("humanoid", horizon=2, device="cpu").model
    L1 = pkernel.read_layout(libs[1])
    pkernel.pack_tables(humanoid, L1, max_points=140)
    with pytest.raises(NotImplementedError, match="contact points exceed"):
        pkernel.pack_tables(humanoid, L1, max_points=139)
    hopper = make("hopper", horizon=2, device="cpu", constraint_solver="newton").model
    L0 = pkernel.read_layout(libs[0])
    NL = pkernel.read_newton_layout(libs[0])
    rows = pkernel.num_contact_candidates(hopper) + sum(1 for v in hopper.jnt_limited if v > 0)
    pkernel.pack_newton_tables(hopper, L0, {**NL, "MAX_HELD": rows})
    with pytest.raises(NotImplementedError, match="held rows"):
        pkernel.pack_newton_tables(hopper, L0, {**NL, "MAX_HELD": rows - 1})
