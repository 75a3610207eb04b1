"""Kernel K1's arithmetic on the CPU, and the wrapper's contract.

``mjrl_tpu_torch/csrc/mj_substep.h`` is compiled with g++ (no CUDA, no
torch headers) into a ctypes library, and its control steps are held
against the plain PyTorch version (physics/soa.py) on the same inputs:
ant, and the planar walkers (slide joints; hopper's capsule-capsule
contacts between links), plus one Newton case (K2's body) on walker2d.
This catches math and table-layout faults before the kernel ever runs on
a card. The tests marked ``cuda`` launch the real kernel and run only
where a card is present.
"""

import copy
import ctypes
import shutil

import numpy as np
import pytest
import torch

from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.physics import pkernel, probe, soa

torch.set_num_threads(1)

B = 8


@pytest.fixture(scope="module")
def env():
    return make("ant", horizon=8, device="cpu")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    path = pkernel.build_library("mj_host.cpp", ("g++", *pkernel.GXX_FLAGS),
                                 tmp_path_factory.mktemp("k1_host"))
    lib = ctypes.CDLL(str(path))
    lib.mj_multistep_host.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.mj_multistep_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def host(env, lib):
    return _host_runner(lib, env.model)


def _host_runner(lib, model):
    """The host build of the kernel body for ``model``: ``run(q, qd, ctrl,
    n_frames)`` on batch-last numpy arrays."""
    mf, mi = pkernel.pack_tables(model, pkernel.read_layout(lib))

    def run(q, qd, ctrl, n_frames):
        q, qd, ctrl = (np.ascontiguousarray(x, np.float32) for x in (q, qd, ctrl))
        q_out, qd_out = np.empty_like(q), np.empty_like(qd)
        ptr = [a.ctypes.data for a in (mf, mi, q, qd, ctrl, q_out, qd_out)]
        dt = float(np.float32(model.dt / model.n_substeps))
        assert lib.mj_multistep_host(*ptr, q.shape[1], n_frames * model.n_substeps, dt) == 0
        return q_out, qd_out

    return run


@pytest.fixture(scope="module")
def warm(env, host):
    """B envs after 4 control steps of random actions (warmed through the
    host build, which is fast), and the next control."""
    rng = np.random.default_rng(0)
    state, _ = env.reset(B, torch.Generator().manual_seed(0))
    q, qd = state.q.T.numpy(), state.qd.T.numpy()
    for _ in range(4):
        q, qd = host(q, qd, rng.uniform(-1, 1, (8, B)), env.frame_skip)
    return q, qd, rng.uniform(-1, 1, (8, B)).astype(np.float32)


def _plain(env, q, qd, ctrl, n_frames):
    out = soa.multistep(env.model, torch.as_tensor(q), torch.as_tensor(qd), torch.as_tensor(ctrl), n_frames)
    return [x.numpy() for x in out]


# host build vs plain, one control step (5 frames x 4 substeps) from the
# same state: the same f32 formulas, a few sums in another order
TOL_Q = dict(rtol=1e-5, atol=1e-5)
TOL_QD = dict(rtol=1e-4, atol=1e-4)


def test_layout_is_the_packers(env, host, tmp_path):
    path = pkernel.build_library("mj_host.cpp", ("g++", *pkernel.GXX_FLAGS), tmp_path)
    L = pkernel.read_layout(ctypes.CDLL(str(path)))
    offsets = sorted(v for k, v in L.items() if k.startswith("F_"))
    assert len(set(offsets)) == len(offsets)  # no two sections share an offset
    mf, mi = pkernel.pack_tables(env.model, L)
    assert mi[L["I_NLINK"]] == 13 and mi[L["I_NV"]] == 14 and mi[L["I_NPAIR"]] == 13
    assert mf.size == L["F_PAIR"] + 13 * L["PAIR_F"]


def test_kernel_body_matches_plain_one_step(env, host, warm):
    q, qd, ctrl = warm
    got_q, got_qd = host(q, qd, ctrl, env.frame_skip)
    want_q, want_qd = _plain(env, q, qd, ctrl, env.frame_skip)
    np.testing.assert_allclose(got_q, want_q, **TOL_Q)
    np.testing.assert_allclose(got_qd, want_qd, **TOL_QD)


def test_kernel_body_matches_plain_along_a_chain(env, host, warm):
    """Ten chained control steps of the host build, each held against the
    plain version from the same state (free-running trajectories of two
    f32 engines diverge chaotically through the penalty contacts)."""
    q, qd, _ = warm
    rng = np.random.default_rng(1)
    for _ in range(10):
        ctrl = rng.uniform(-1, 1, (8, B)).astype(np.float32)
        got_q, got_qd = host(q, qd, ctrl, env.frame_skip)
        want_q, want_qd = _plain(env, q, qd, ctrl, env.frame_skip)
        np.testing.assert_allclose(got_q, want_q, **TOL_Q)
        np.testing.assert_allclose(got_qd, want_qd, **TOL_QD)
        q, qd = got_q, got_qd


def test_kernel_body_keeps_nonfinite_states(env, host, warm):
    q, qd, ctrl = (x.copy() for x in warm)
    qd[3, 2] = np.nan
    got_q, got_qd = host(q, qd, ctrl, env.frame_skip)
    want_q, want_qd = _plain(env, q, qd, ctrl, env.frame_skip)
    np.testing.assert_array_equal(np.isfinite(got_qd), np.isfinite(want_qd))
    np.testing.assert_array_equal(np.isfinite(got_q), np.isfinite(want_q))
    assert not np.isfinite(got_qd[:, 2]).all() and np.isfinite(got_qd[:, [0, 1, 3]]).all()


def test_pack_tables_refuses_unsupported(env):
    model = copy.copy(env.model)
    model.__dict__.pop("_k1_tables", None)
    model.density = 1.2  # fluid forces, not in the kernels' feature set
    with pytest.raises(NotImplementedError):
        pkernel.pack_tables(model, {})


def test_wrapper_checks_inputs_and_runs_plain_on_cpu(env):
    m = env.model
    q = torch.as_tensor(np.tile(m.default_qpos[:, None], (1, 3)))
    qd, ctrl = torch.zeros(m.nv, 3), torch.zeros(m.nu, 3)
    kernel = pkernel.MultistepKernel()
    with pytest.raises(TypeError):
        kernel(m, q.double(), qd, ctrl)
    with pytest.raises(ValueError):
        kernel(m, q, qd[:, :2], ctrl)
    with pytest.raises(ValueError):
        kernel(m, q, qd, ctrl.T.contiguous().T)
    got = kernel(m, q, qd, ctrl, 1)
    want = soa.multistep(m, q, qd, ctrl, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernel.launches == 0  # the CPU path never launches


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(env):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(0)
    state, _ = env.reset(1000, torch.Generator().manual_seed(0))
    dev = torch.device("cuda")
    q, qd = state.q.T.contiguous().to(dev), state.qd.T.contiguous().to(dev)
    ctrl = torch.as_tensor(rng.uniform(-1, 1, (8, 1000)), dtype=torch.float32, device=dev)
    kernel = pkernel.MultistepKernel()
    got_q, got_qd = kernel(env.model, q, qd, ctrl, env.frame_skip)
    torch.cuda.synchronize()
    want_q, want_qd = soa.multistep(env.model, q, qd, ctrl, env.frame_skip)
    assert kernel.launches == 1
    # chip_smoke.py's tolerance: FMA contraction, grown through contacts
    torch.testing.assert_close(got_q, want_q, rtol=0, atol=1e-3)
    torch.testing.assert_close(got_qd, want_qd, rtol=0, atol=5e-2)


# ---- the planar walkers: slide joints, capsule-capsule contacts ----------

WALKERS = ("hopper", "walker2d", "half_cheetah")


def cc_in_contact(model, q):
    """Envs with a capsule-capsule candidate at depth > 0."""
    return int((probe.link_pair_depth(model, torch.as_tensor(q)) > 0).sum())


@pytest.fixture(scope="module", params=WALKERS)
def walker(request, lib):
    """``(env, run, q, qd)``: B envs after 6 control steps of random actions
    from reset (through the host build); for hopper the second half of the
    batch starts folded, with capsule-capsule overlaps."""
    env = make(request.param, horizon=8, device="cpu")
    run = _host_runner(lib, env.model)
    rng = np.random.default_rng(0)
    state, _ = env.reset(B, torch.Generator().manual_seed(0))
    q, qd = state.q.T.numpy().copy(), state.qd.T.numpy().copy()
    for _ in range(6):
        q, qd = run(q, qd, rng.uniform(-1, 1, (env.model.nu, B)), env.frame_skip)
    if request.param == "hopper":
        q[:, B // 2 :], qd[:, B // 2 :] = probe.overlapping_states(env.model, B - B // 2, rng)
        assert cc_in_contact(env.model, q) > 0
    return env, run, q, qd


def test_walker_layout_packs_slides_and_capsule_pairs(walker, lib):
    env, *_ = walker
    L, m = pkernel.read_layout(lib), env.model
    mf, mi = pkernel.pack_tables(m, L)
    assert list(mi[L["I_TYPE"] : L["I_TYPE"] + 3]) == [3, 3, 2]  # rootx, rootz slides, rooty
    pairs = mi[L["I_PAIR"] :].reshape(-1, L["PAIR_I"])
    cc = np.flatnonzero(pairs[:, 0] == 2)
    assert cc.size == (3 if env.asset == "hopper.xml" else 0)
    assert (pairs[cc, 1] >= 0).all() and (pairs[cc, 2] >= 0).all()  # both on links
    rows = mf[L["F_PAIR"] :].reshape(-1, L["PAIR_F"])
    assert (rows[cc, L["PAIR_GJ"]] > 0).all() and (rows[cc, L["PAIR_GJ"] + 1] > 0).all()


def test_walker_kernel_body_matches_plain_along_a_chain(walker):
    """Four chained control steps of the host build, each held against the
    plain version from the same state."""
    env, run, q, qd = walker
    rng = np.random.default_rng(1)
    contact = 0
    for _ in range(4):
        contact += cc_in_contact(env.model, q)
        ctrl = rng.uniform(-1, 1, (env.model.nu, B)).astype(np.float32)
        got_q, got_qd = run(q, qd, ctrl, env.frame_skip)
        want_q, want_qd = _plain(env, q, qd, ctrl, env.frame_skip)
        np.testing.assert_allclose(got_q, want_q, **TOL_Q)
        np.testing.assert_allclose(got_qd, want_qd, **TOL_QD)
        q, qd = got_q, got_qd
    if env.asset == "hopper.xml":
        assert contact > 0, "no capsule-capsule contact along the chain"


def test_capsule_pair_wrenches_are_equal_and_opposite(lib):
    """One capsule-capsule contact, alone: the kernel body's step matches the
    plain version, and the pair's wrenches on the two links cancel, so the
    whole body's momentum changes only by gravity."""
    env = make("hopper", horizon=8, device="cpu")
    model = copy.copy(env.model)
    model.contact_pairs = tuple(p for p in model.contact_pairs
                                if min(model.geom_link[g] for g in p) >= 0)
    model._pair_groups = None
    model.gravity = np.zeros(3, np.float32)
    model.__dict__.pop("_torch_consts", None)
    rng = np.random.default_rng(2)
    q, qd = probe.overlapping_states(model, 4, rng)
    qd[:] = 0.0
    ctrl = np.zeros((model.nu, 4), np.float32)
    run = _host_runner(lib, model)
    got_q, got_qd = run(q, qd, ctrl, 1)
    want_q, want_qd = (x.numpy() for x in soa.multistep(
        model, torch.as_tensor(q), torch.as_tensor(qd), torch.as_tensor(ctrl), 1))
    np.testing.assert_allclose(got_q, want_q, **TOL_Q)
    np.testing.assert_allclose(got_qd, want_qd, **TOL_QD)
    assert np.abs(got_qd).max() > 1e-2  # the contact pushed the links apart
    # linear momentum along x and z: sum over links of m * v_com, from the
    # plain kinematics; internal forces leave it at 0
    pos, quat = soa._fk(model, torch.as_tensor(got_q))
    cdof = soa._cdofs(model, pos, quat, pos[0])
    cvel = soa._cvels(model, cdof, torch.as_tensor(got_qd))
    mom = 0.0
    for i in range(model.nlink):
        com = pos[i] - pos[0] + soa._qrot(quat[i], torch.as_tensor(model.link_com[i]).reshape(3, 1))
        v = cvel[i][3:6] + soa._cross(cvel[i][0:3], com)
        mom = mom + float(model.link_mass[i]) * v
    total = float(np.sum(model.link_mass))
    assert float(mom.abs().max()) < 1e-3 * total


def test_walker_newton_kernel_body_matches_plain(lib):
    """K2's body on walker2d (slide joints through the shared stages; its
    contacts are all against the floor), one control step from warmed
    states."""
    env = make("walker2d", horizon=8, device="cpu", constraint_solver="newton", n_substeps=1)
    model = env.model
    model.solver_iters = 4
    lib.mj_newton_host.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float]
    lib.mj_newton_host.restype = ctypes.c_int
    L = pkernel.read_layout(lib)
    mf, mi = pkernel.pack_tables(model, L)
    nf, ni = pkernel.pack_newton_tables(model, L, pkernel.read_newton_layout(lib))
    rng = np.random.default_rng(3)
    state, _ = env.reset(4, torch.Generator().manual_seed(3))
    for _ in range(6):
        state, *_ = env.step(state, torch.as_tensor(rng.uniform(-1, 1, (4, 6)), dtype=torch.float32))
    q, qd = state.q.T.numpy().copy(), state.qd.T.numpy().copy()
    ctrl = rng.uniform(-1, 1, (6, 4)).astype(np.float32)
    n_sub = env.frame_skip * model.n_substeps
    q_out, qd_out = np.empty_like(q), np.empty_like(qd)
    picks = np.full((n_sub * model.solver_iters, 4), -1, np.int32)
    ptr = [a.ctypes.data for a in (mf, mi, nf, ni, q, qd, ctrl, q_out, qd_out, picks)]
    dt = float(np.float32(model.dt / model.n_substeps))
    assert lib.mj_newton_host(*ptr, 4, n_sub, model.solver_iters, dt) == 0
    want_q, want_qd = (x.numpy() for x in soa.multistep(
        model, torch.as_tensor(q), torch.as_tensor(qd), torch.as_tensor(ctrl), env.frame_skip))
    # test_torch_newton_kernel.py's tolerances for K2's body
    np.testing.assert_allclose(q_out, want_q, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(qd_out, want_qd, rtol=1e-4, atol=1e-4)


def test_pack_newton_tables_refuses_pairs_between_links(lib):
    """Hopper's capsule-capsule pairs join two moving links: K2 does not
    hold such rows yet."""
    env = make("hopper", horizon=8, device="cpu", constraint_solver="newton", n_substeps=1)
    L, NL = pkernel.read_layout(lib), pkernel.read_newton_layout(lib)
    with pytest.raises(NotImplementedError, match="world plane"):
        pkernel.pack_newton_tables(env.model, L, NL)
