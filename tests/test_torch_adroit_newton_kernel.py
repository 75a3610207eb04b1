"""Kernel K4's arithmetic on the CPU, and its wrapper's contract.

``mjrl_tpu_torch/csrc/mj_warp_newton.h``'s Newton substep with Adroit's
stages (per-env link offsets, the box contact kinds, gain/bias servos,
fixed tendons, frictionloss, and at most ``MJ_MAX_HELD`` contact rows held
per env-substep), written over the lanes of a warp, is compiled with g++
(no CUDA) into a ctypes library through ``mj_host.cpp``'s
``mj_ext_newton_host``, which runs it under the emulated warp, in the
Adroit size class (``pkernel.size_flags(2)``), and its control steps are
held against the plain PyTorch version (physics/soa.py and
physics/soa_newton.py) on Adroit pen, from warmed states with link offsets
and from states where each of pen's five contact kinds touches, and its
substep against the engine oracle ``tests/golden/adroit_hammer_newton_substep.npz``
on hammer (671 contact points, pair chains of 15 dofs); on door and
relocate, states that hold more than 64 rows are held without overflow. A
build with room for 4 rows counts the env-substeps that have more and the wrapper's check
raises on them. The test marked ``cuda`` launches the real kernel and runs
only where a card is present.
"""

import copy
import ctypes
import os
import shutil

import numpy as np
import pytest
import torch

from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.envs.adroit import adroit_model
from mjrl_tpu_torch.physics import pkernel, probe, soa
from mjrl_tpu_torch.physics.dispatch import kernel_for
from mjrl_tpu_torch.physics.tables import num_contact_candidates

torch.set_num_threads(1)

# host build vs plain, one control step from the same state: the same f32
# formulas, a few sums in another order (tests/test_torch_newton_kernel.py)
TOL_Q = dict(rtol=1e-5, atol=1e-5)
TOL_QD = dict(rtol=1e-4, atol=1e-4)
# against the engine oracle: tests/test_soa_newton.py's tolerances
TOL_GOLDEN_Q = dict(rtol=3e-4, atol=3e-5)
TOL_GOLDEN_QD = dict(rtol=3e-3, atol=3e-3)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "adroit_hammer_newton_substep.npz")


def _library(directory, *extra):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    path = pkernel.build_library("mj_host.cpp", ("g++", *pkernel.GXX_FLAGS,
                                                 *pkernel.size_flags(2), *extra), directory)
    lib = ctypes.CDLL(str(path))
    lib.mj_ext_newton_host.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [
        ctypes.c_float]
    lib.mj_ext_newton_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _library(tmp_path_factory.mktemp("k4"))


def _host_runner(lib, model):
    """K4's host build for ``model``: ``run(q, qd, ctrl, delta, n_sub)`` on
    batch-last numpy arrays -> ``(q, qd, picks, overflow count)``."""
    L, NL = pkernel.read_layout(lib), pkernel.read_newton_layout(lib)
    mf, mi = pkernel.pack_tables(model, L, ext=True)
    nf, ni = pkernel.pack_newton_tables(model, L, NL, ext=True)
    iters = int(model.solver_iters)

    def run(q, qd, ctrl, delta, n_sub):
        q, qd, ctrl, delta = (np.ascontiguousarray(x, np.float32) for x in (q, qd, ctrl, delta))
        q_out, qd_out = np.empty_like(q), np.empty_like(qd)
        picks = np.full((n_sub * iters, q.shape[1]), -1, np.int32)
        over = np.zeros(1, np.int32)
        ptr = [a.ctypes.data for a in (mf, mi, nf, ni, q, qd, ctrl, delta, q_out, qd_out,
                                        picks, over)]
        dt = float(np.float32(model.dt / model.n_substeps))
        assert lib.mj_ext_newton_host(*ptr, q.shape[1], n_sub, iters, dt) == 0
        return q_out, qd_out, picks, int(over[0])

    return run


def _plain(model, q, qd, ctrl, delta, n_frames):
    picks = []
    out = soa.multistep(model, *map(torch.as_tensor, (q, qd, ctrl)), n_frames, picks=picks,
                        link_delta=torch.as_tensor(delta))
    return out[0].numpy(), out[1].numpy(), torch.cat(picks).numpy()


@pytest.fixture(scope="module")
def pen():
    """The pen env on the Newton solver and B=9 start states: 4 after 2
    control steps of random actions from reset, their links offset by up
    to 5 mm; then one per contact kind where that kind touches
    (``probe.kind_states``); every qd nonzero."""
    env = make("adroit_pen", device="cpu", constraint_solver="newton")
    rng = np.random.default_rng(0)
    state, _ = env.reset(4, torch.Generator().manual_seed(0))
    for _ in range(2):
        state, *_ = env.step(state, torch.as_tensor(rng.uniform(-1, 1, (4, 24)),
                                                    dtype=torch.float32))
    kq, kqd, kd = probe.kind_states(env.model, 1, rng)
    q = np.concatenate([state.q.T.numpy(), kq], axis=1)
    qd = np.concatenate([state.qd.T.numpy(), kqd], axis=1)
    delta = np.concatenate([rng.uniform(-0.005, 0.005, (3 * env.model.nlink, 4)), kd], axis=1)
    return env, q, qd, delta.astype(np.float32)


def _check_picks(iters, got, want):
    """Each substep's first iteration takes a full-size step: its fraction
    must agree; later ones may flip on round-off ties."""
    np.testing.assert_array_equal(got[::iters], want[::iters])
    assert (got >= 0).all() and (got <= 4).all()


def test_k4_host_build_matches_plain_on_pen(pen, lib):
    """One control step, then two more chained (5 substeps each), each held
    against the plain version from the same state with the same link
    offsets; every contact kind and every facet count holds rows on the
    way, and no env-substep overflows the build's rows."""
    env, q, qd, delta = pen
    m = env.model
    run = _host_runner(lib, m)
    rng = np.random.default_rng(1)
    seen = dict.fromkeys(("box_plane", "capsule_plane", "capsule_box", "box_box",
                          "capsule_capsule", "facets_1", "facets_4", "facets_6"), 0)
    for _ in range(3):
        rows = probe.held_rows(m, torch.as_tensor(q), torch.as_tensor(delta))
        for k in seen:
            seen[k] += int((rows[k] > 0).sum())
        ctrl = env._scaled_ctrl(torch.as_tensor(rng.uniform(-1, 1, (q.shape[1], 24)),
                                                dtype=torch.float32)).T.numpy()
        got_q, got_qd, got_p, over = run(q, qd, ctrl, delta, env.frame_skip)
        want_q, want_qd, want_p = _plain(m, q, qd, ctrl, delta, env.frame_skip)
        np.testing.assert_allclose(got_q, want_q, **TOL_Q)
        np.testing.assert_allclose(got_qd, want_qd, **TOL_QD)
        _check_picks(m.solver_iters, got_p, want_p)
        assert over == 0
        q, qd = got_q, got_qd
    assert all(seen.values()), seen


def test_k4_held_counter_changes_no_bit(pen, lib):
    """``mj_ext_newton_stats_host`` (K4's body with the stats buffer that
    tracing reads, its held-row counter first) on pen's states with link
    offsets, every contact kind touching: the same bits with the buffer
    null and non-null, and over one substep the sum and the largest of the
    rows each env holds, as the plain version counts them."""
    lib.mj_ext_newton_stats_host.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [
        ctypes.c_float]
    lib.mj_ext_newton_stats_host.restype = ctypes.c_int
    env, q, qd, delta = pen
    m = env.model
    L = pkernel.read_layout(lib)
    tables = (*pkernel.pack_tables(m, L, ext=True),
              *pkernel.pack_newton_tables(m, L, pkernel.read_newton_layout(lib), ext=True))
    B = q.shape[1]
    ctrl = np.tile(np.asarray(env._act_mean)[:, None], (1, B)).astype(np.float32)
    dt = float(np.float32(m.dt / m.n_substeps))

    def run(n_sub, stats):
        out = [np.empty_like(q), np.empty_like(qd),
               np.full((n_sub * m.solver_iters, B), -1, np.int32), np.zeros(1, np.int32)]
        ptr = [a.ctypes.data for a in (*tables, q, qd, ctrl, delta, *out)]
        held = None if stats is None else stats.ctypes.data
        assert lib.mj_ext_newton_stats_host(*ptr, held, B, n_sub, m.solver_iters, dt) == 0
        return out

    stats = np.zeros(len(pkernel.STAT_NAMES), np.int64)
    for a, b in zip(run(env.frame_skip, None), run(env.frame_skip, stats)):
        np.testing.assert_array_equal(a, b)
    stats[:] = 0
    run(1, stats)
    held = []
    soa.multistep(m, *map(torch.as_tensor, (q, qd, ctrl)), 1, held=held,
                  link_delta=torch.as_tensor(delta))
    assert int(held[0].max()) > 4
    assert stats[:2].tolist() == [int(held[0].sum()), int(held[0].max())]
    rows = probe.held_rows(m, torch.as_tensor(q), torch.as_tensor(delta))["contacts"]
    assert torch.equal(rows, held[0])


def test_k4_host_build_matches_hammer_golden(lib):
    """Hammer's substep (3 Newton iterations, the golden's link offsets;
    671 contact points, pair chains of up to 15 dofs) against the engine
    oracle, to the JAX test's tolerances."""
    g = np.load(GOLDEN)
    model = adroit_model("hammer", "newton")
    model.solver_iters = int(g["solver_iters"])
    assert num_contact_candidates(model) == 671 and float(g["dt"]) == np.float32(model.dt)
    delta = g["link_delta"].reshape(g["link_delta"].shape[0], -1).T
    NL = pkernel.read_newton_layout(lib)
    ni = pkernel.pack_newton_tables(model, pkernel.read_layout(lib), NL, ext=True)[1]
    assert ni[NL["N_I_PAIR"] + 1 :: NL["NPAIR_I"]].max() == 15  # the longest pair chain
    got_q, got_qd, _, over = _host_runner(lib, model)(g["q"].T, g["qd"].T, g["ctrl"].T, delta, 1)
    assert over == 0
    np.testing.assert_allclose(got_q.T, g["ref_q"], **TOL_GOLDEN_Q)
    np.testing.assert_allclose(got_qd.T, g["ref_qd"], **TOL_GOLDEN_QD)


@pytest.mark.parametrize("task, n, seed", [("door", 16, 7), ("relocate", 8, 1)])
def test_k4_host_build_holds_more_than_64_rows(lib, task, n, seed):
    """Door's and relocate's two states (of ``probe.kind_states``) with the
    most contact rows inside their margin, 71 and more in the fullest: more
    than the 64 the Adroit class held before it took 96. One substep of 3
    Newton iterations holds every row (no overflow) and matches the plain
    version."""
    env = make(f"adroit_{task}", device="cpu", constraint_solver="newton")
    m = env.model
    m.solver_iters = 3
    q, qd, delta = probe.kind_states(m, n, np.random.default_rng(seed))
    held = probe.held_rows(m, torch.as_tensor(q), torch.as_tensor(delta))["contacts"].numpy()
    top = np.argsort(-held, kind="stable")[:2]
    assert 64 < held[top[0]] <= pkernel.read_newton_layout(lib)["MAX_HELD"], held[top]
    q, qd, delta = (np.ascontiguousarray(x[:, top]) for x in (q, qd, delta))
    ctrl = np.tile(np.asarray(env._act_mean)[:, None], (1, 2)).astype(np.float32)
    got_q, got_qd, got_p, over = _host_runner(lib, m)(q, qd, ctrl, delta, 1)
    want_q, want_qd, want_p = _plain(m, q, qd, ctrl, delta, 1)
    assert over == 0
    np.testing.assert_allclose(got_q, want_q, **TOL_Q)
    np.testing.assert_allclose(got_qd, want_qd, **TOL_QD)
    _check_picks(m.solver_iters, got_p, want_p)


def test_k4_layout_is_the_packers(pen, lib):
    """K4's tables: the Adroit class holds 19-dof chains and 96 rows; every
    one of pen's 406 contact points is packed (K2's packer refuses them);
    pen's pairs have 1, 4 and 6 facets and chains of up to 13 dofs, each
    dof's sign +1 on geom i's link."""
    env, *_ = pen
    m = env.model
    L, NL = pkernel.read_layout(lib), pkernel.read_newton_layout(lib)
    assert NL["MAX_CHAIN"] == pkernel.CHAIN_CLASSES[2] == 19
    assert NL["MAX_HELD"] == pkernel.HELD_CLASSES[2] == 96
    assert NL["NPAIR_I"] == 2 + 2 * NL["MAX_CHAIN"]
    with pytest.raises(NotImplementedError, match="exceed"):
        pkernel.pack_newton_tables(m, L, NL)
    nf, ni = pkernel.pack_newton_tables(m, L, NL, ext=True)
    npair = len(m.contact_pairs)
    assert ni.size == NL["N_I_PAIR"] + NL["NPAIR_I"] * npair
    assert nf.size == NL["N_F_PAIR"] + NL["NPAIR_F"] * npair
    pairs = ni[NL["N_I_PAIR"]:].reshape(npair, NL["NPAIR_I"])
    assert sorted(set(pairs[:, 0])) == [1, 4, 6]
    assert pairs[:, 1].max() == 13 and pairs[:, 1].min() >= 1
    signs = pairs[:, 2 + NL["MAX_CHAIN"]:]
    assert set(np.unique(signs)) <= {-1, 0, 1}
    assert ni[NL["N_I_NLIM"]] == int((np.asarray(m.jnt_limited) > 0).sum())
    with pytest.raises(NotImplementedError, match="chain"):
        pkernel.pack_newton_tables(m, L, {**NL, "MAX_CHAIN": 12}, ext=True)


def test_k4_overflow_is_counted_and_raises(pen, tmp_path):
    """A build with room for 4 rows: one substep from states where some
    envs hold more contact rows inside their margin than that counts
    exactly those env-substeps, the others match the plain version, and
    the wrapper's check raises on the count."""
    env, q, qd, delta = pen
    m = env.model
    small = _library(tmp_path, "-DMJ_MAX_HELD=4")
    assert pkernel.read_newton_layout(small)["MAX_HELD"] == 4
    held = probe.held_rows(m, torch.as_tensor(q), torch.as_tensor(delta))["contacts"].numpy()
    over4 = held > 4
    assert over4.any() and (~over4).any(), held
    ctrl = np.tile(np.asarray(env._act_mean)[:, None], (1, q.shape[1])).astype(np.float32)
    got_q, got_qd, _, over = _host_runner(small, m)(q, qd, ctrl, delta, 1)
    assert over == int(over4.sum())
    want = soa.substep(m, *map(torch.as_tensor, (q, qd, ctrl)), float(np.float32(m.dt)),
                       link_delta=torch.as_tensor(delta))
    np.testing.assert_allclose(got_q[:, ~over4], want[0].numpy()[:, ~over4], **TOL_Q)
    np.testing.assert_allclose(got_qd[:, ~over4], want[1].numpy()[:, ~over4], **TOL_QD)
    kernel = pkernel.PhysicsKernel("newton", True)
    kernel.check()
    kernel.counters(torch.device("cpu"))[0].fill_(over)
    with pytest.raises(RuntimeError, match="MAX_HELD"):
        kernel.check()
    kernel.check()  # the count was cleared with the raise


def test_k4_wrapper_contract(pen):
    """On CPU tensors K4 runs the plain version with the link offsets and
    launches nothing; it refuses a penalty model and bad offsets; K2
    refuses Adroit's stages; the frame stepper of the Newton env calls K4
    with the offsets, and the env's check reaches K4's."""
    env, q, qd, delta = pen
    m = env.model
    q, qd, delta = (torch.as_tensor(x[:, :3].copy()) for x in (q, qd, delta))
    ctrl = torch.zeros(m.nu, 3)
    kernel = pkernel.PhysicsKernel("newton", True)
    got = kernel(m, q, qd, ctrl, 1, link_delta=delta)
    want = soa.multistep(m, q, qd, ctrl, 1, link_delta=delta)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and kernel.launches == 0
    with pytest.raises(ValueError, match="link_delta"):
        kernel(m, q, qd, ctrl, 1, link_delta=delta[:, :2].contiguous())
    penalty = copy.copy(m)
    penalty.constraint_solver = "penalty"
    with pytest.raises(ValueError, match="newton"):
        kernel(penalty, q, qd, ctrl, 1, link_delta=delta)
    with pytest.raises(ValueError, match="K4"):
        pkernel.PhysicsKernel("newton", False)(m, q, qd, ctrl, 1)
    assert kernel_for(m) is pkernel.K4 and kernel_for(penalty) is pkernel.K3
    calls = []
    real = pkernel.PhysicsKernel.__call__
    try:
        pkernel.PhysicsKernel.__call__ = lambda self, *a, **k: calls.append((self, k)) or real(
            self, *a, **k)
        env._frame_step(q.T, qd.T, ctrl.T, delta.T.reshape(3, m.nlink, 3))
    finally:
        pkernel.PhysicsKernel.__call__ = real
    assert len(calls) == 1 and calls[0][0] is pkernel.K4
    assert calls[0][1]["link_delta"].shape == (3 * m.nlink, 3)
    assert env._frame_step.check == pkernel.K4.check
    env.check()


def test_table_cache_is_shared_planted_and_dropped(pen, lib, monkeypatch):
    """One table cache on the model: K4's tables are its ext packing and
    its Newton tables in the build's layouts, uploaded once; the pose
    kernel reads the same upload of the ext packing and a site table;
    ``set_tables`` gives a copy of the model planted tables of its own and
    leaves the original's; ``drop_tables`` has them packed anew."""
    m, cpu = copy.copy(pen[0].model), torch.device("cpu")
    pkernel.drop_tables(m)
    built = pkernel.Library(lib)
    k4, poses = pkernel.PhysicsKernel("newton", True), pkernel.PoseKernel()
    for k in (k4, poses):
        monkeypatch.setattr(k, "build", lambda size: built)
    tables = k4.tables(m, cpu)
    want = (*pkernel.pack_tables(m, built.layout, ext=True),
            *pkernel.pack_newton_tables(m, built.layout, built.newton_layout, ext=True))
    assert len(tables) == 4 and all(np.array_equal(t.numpy(), w) for t, w in zip(tables, want))
    assert k4.tables(m, cpu) is tables
    pose_tables = poses.tables(m, cpu)
    assert pose_tables[0] is tables[0] and pose_tables[1] is tables[1]
    for t, w in zip(pose_tables[2:], pkernel.pack_site_tables(m)):
        np.testing.assert_array_equal(t.numpy(), w)
    faulty, planted = copy.copy(m), tuple(t.clone() for t in tables)
    pkernel.set_tables(faulty, k4, cpu, planted)
    assert all(a is b for a, b in zip(k4.tables(faulty, cpu), planted))
    assert k4.tables(m, cpu) is tables
    pkernel.drop_tables(faulty)
    again = k4.tables(faulty, cpu)
    assert again[0] is not planted[0] and all(torch.equal(a, b) for a, b in zip(again, tables))


@pytest.mark.cuda
def test_cuda_k4_matches_plain_on_pen():
    """K4 on the card in the Adroit class: B=250 states in which each
    contact kind touches, with their link offsets, one control step; no
    overflow."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    env = make("adroit_pen", constraint_solver="newton")
    m, rng, dev = env.model, np.random.default_rng(0), torch.device("cuda")
    q, qd, d = (torch.as_tensor(x, device=dev) for x in probe.kind_states(m, 50, rng))
    ctrl = torch.as_tensor(rng.uniform(-1, 1, (m.nu, 250)), dtype=torch.float32, device=dev)
    kernel = pkernel.PhysicsKernel("newton", True)
    got_q, got_qd = kernel(m, q, qd, ctrl, env.frame_skip, link_delta=d)
    torch.cuda.synchronize()
    want_q, want_qd = soa.multistep(m, q, qd, ctrl, env.frame_skip, link_delta=d)
    assert kernel.launches == 1
    kernel.check()
    # chip_smoke.py's tolerance for K4 on pen
    torch.testing.assert_close(got_q, want_q, rtol=0, atol=1e-3)
    torch.testing.assert_close(got_qd, want_qd, rtol=0, atol=1e-1)


@pytest.mark.cuda
def test_cuda_k4_held_counter_changes_no_bit():
    """K4 on the card, one control step from pen's kind states with their
    link offsets, with tracing off (no held-row counter) and on (the
    counter read with the overflow count at ``check()``): the same bits,
    and the counter's env-substeps, sum and largest held rows, the most
    at most the build's 96."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from mjrl_tpu_torch.utils import trace

    env = make("adroit_pen", constraint_solver="newton")
    m, rng, dev = env.model, np.random.default_rng(0), torch.device("cuda")
    q, qd, d = (torch.as_tensor(x, device=dev) for x in probe.kind_states(m, 50, rng))
    ctrl = torch.as_tensor(rng.uniform(-1, 1, (m.nu, 250)), dtype=torch.float32, device=dev)
    kernel = pkernel.PhysicsKernel("newton", True)
    off = kernel(m, q, qd, ctrl, env.frame_skip, link_delta=d)
    kernel.check()
    trace.reset()
    trace.enable()
    try:
        on = kernel(m, q, qd, ctrl, env.frame_skip, link_delta=d)
        kernel.check()
        got = trace.take()
    finally:
        trace.disable()
        trace.reset()
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    assert got["counters"]["K4.env_substeps"] == 250 * env.frame_skip * m.n_substeps
    assert got["counters"]["K4.held_rows"] > 0
    assert 0 < got["peaks"]["K4.held_rows_max"] <= 96
    assert got["reads"]["K4.check"]["count"] == 1
