"""Kernel K2's arithmetic on the CPU, and its wrapper's contract.

``mjrl_tpu_torch/csrc/mj_newton.h`` (with ``mj_substep.h``) is compiled
with g++ into a ctypes library, and its Newton control steps are held
against the plain PyTorch version (physics/soa.py with
physics/soa_newton.py) on the same inputs, at the bench row's settings:
ant, Newton solver, ``n_substeps=1``, 10 iterations. The test marked
``cuda`` launches the real kernel and runs only where a card is present.
"""

import copy
import ctypes
import shutil

import numpy as np
import pytest
import torch

from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.physics import pkernel, soa

torch.set_num_threads(1)

B = 8


@pytest.fixture(scope="module")
def env():
    return make("ant", horizon=8, device="cpu", constraint_solver="newton", n_substeps=1)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    path = pkernel.build_library("mj_host.cpp", ("g++", *pkernel.GXX_FLAGS),
                                 tmp_path_factory.mktemp("k2_host"))
    lib = ctypes.CDLL(str(path))
    lib.mj_newton_host.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float]
    lib.mj_newton_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def host(env, lib):
    return _host_runner(lib, env.model)


def _host_runner(lib, model):
    """The host build of K2's body for ``model``: ``run(q, qd, ctrl,
    n_frames) -> (q, qd, picks)`` on batch-last numpy arrays."""
    L = pkernel.read_layout(lib)
    mf, mi = pkernel.pack_tables(model, L)
    nf, ni = pkernel.pack_newton_tables(model, L, pkernel.read_newton_layout(lib))

    def run(q, qd, ctrl, n_frames):
        q, qd, ctrl = (np.ascontiguousarray(x, np.float32) for x in (q, qd, ctrl))
        q_out, qd_out = np.empty_like(q), np.empty_like(qd)
        n_sub, iters = n_frames * model.n_substeps, model.solver_iters
        picks = np.full((n_sub * iters, q.shape[1]), -1, np.int32)
        ptr = [a.ctypes.data for a in (mf, mi, nf, ni, q, qd, ctrl, q_out, qd_out, picks)]
        dt = float(np.float32(model.dt / model.n_substeps))
        assert lib.mj_newton_host(*ptr, q.shape[1], n_sub, iters, dt) == 0
        return q_out, qd_out, picks

    return run


@pytest.fixture(scope="module")
def warm(env, host):
    """B envs after 12 control steps of random actions (warmed through the
    host build), some with feet inside the contact margin, and the next
    control."""
    rng = np.random.default_rng(0)
    state, _ = env.reset(B, torch.Generator().manual_seed(0))
    q, qd = state.q.T.numpy(), state.qd.T.numpy()
    for _ in range(12):
        q, qd, _ = host(q, qd, rng.uniform(-1, 1, (8, B)), env.frame_skip)
    return q, qd, rng.uniform(-1, 1, (8, B)).astype(np.float32)


def _plain(env, q, qd, ctrl, n_frames, model=None):
    picks = []
    out = soa.multistep(model or env.model, torch.as_tensor(q), torch.as_tensor(qd),
                        torch.as_tensor(ctrl), n_frames, picks=picks)
    return out[0].numpy(), out[1].numpy(), torch.cat(picks).numpy()


def _in_margin(env, q):
    pos, quat = soa._fk(env.model, torch.as_tensor(q))
    depth = torch.cat([c.depth for c in soa._contact_candidates(env.model, pos, quat)])
    return int((depth > -0.02).sum())


# host build vs plain, one control step (5 Newton substeps) from the same
# state: the same f32 formulas with sums in another order; the soft
# constraints are implicit, so round-off does not grow as in K1's penalty
# contacts. A converged iteration's five line-search costs can tie to
# round-off and flip the fraction picked, with a step dx of round-off size.
TOL_Q = dict(rtol=1e-5, atol=1e-5)
TOL_QD = dict(rtol=1e-4, atol=1e-4)


def _check_picks(env, got, want):
    """Each substep's first iteration takes a full-size step: its fraction
    must agree; later ones may flip on round-off ties."""
    first = np.arange(0, got.shape[0], env.model.solver_iters)
    np.testing.assert_array_equal(got[first], want[first])
    assert (got >= 0).all() and (got <= 4).all()


def test_newton_layout_is_the_packers(env, lib):
    L, NL = pkernel.read_layout(lib), pkernel.read_newton_layout(lib)
    assert NL["MAX_FACET"] == 6 and NL["MAX_CHAIN"] >= 8 and NL["MAX_CAND"] >= 25
    for prefix in ("N_F_", "N_I_"):
        offsets = sorted(v for k, v in NL.items() if k.startswith(prefix))
        assert len(set(offsets)) == len(offsets)
    nf, ni = pkernel.pack_newton_tables(env.model, L, NL)
    assert ni[NL["N_I_NLIM"]] == 8  # ant's 8 limited hinges
    assert nf.size == NL["N_F_PAIR"] + 13 * NL["NPAIR_F"]
    pairs = ni[NL["N_I_PAIR"]:].reshape(13, NL["NPAIR_I"])
    assert (pairs[:, 0] == 4).all()  # condim 3: four pyramid facets
    assert pairs[0, 1] == 6 and set(pairs[1:, 1]) == {6, 7, 8}  # torso, leg links


def test_newton_kernel_body_matches_plain_one_step(env, host, warm):
    q, qd, ctrl = warm
    assert _in_margin(env, q) > 0, "no contact rows in the warmed states"
    got_q, got_qd, got_p = host(q, qd, ctrl, env.frame_skip)
    want_q, want_qd, want_p = _plain(env, q, qd, ctrl, env.frame_skip)
    np.testing.assert_allclose(got_q, want_q, **TOL_Q)
    np.testing.assert_allclose(got_qd, want_qd, **TOL_QD)
    _check_picks(env, got_p, want_p)


def test_newton_kernel_body_matches_plain_along_a_chain(env, host, warm):
    """Six chained control steps of the host build, each held against the
    plain version from the same state."""
    q, qd, _ = warm
    rng = np.random.default_rng(1)
    for _ in range(6):
        ctrl = rng.uniform(-1, 1, (8, B)).astype(np.float32)
        got_q, got_qd, got_p = host(q, qd, ctrl, env.frame_skip)
        want_q, want_qd, want_p = _plain(env, q, qd, ctrl, env.frame_skip)
        np.testing.assert_allclose(got_q, want_q, **TOL_Q)
        np.testing.assert_allclose(got_qd, want_qd, **TOL_QD)
        _check_picks(env, got_p, want_p)
        q, qd = got_q, got_qd


@pytest.mark.parametrize("condim,nfacet", [(1, 1), (4, 6)])
def test_newton_kernel_body_matches_plain_other_condims(env, lib, warm, condim, nfacet):
    """Frictionless contacts (one row each) and torsional friction (six
    pyramid facets) through the same kernel paths as ant's condim 3."""
    model = copy.copy(env.model)
    model.geom_condim = np.full(model.ngeom, condim, np.int32)
    run = _host_runner(lib, model)
    NL = pkernel.read_newton_layout(lib)
    ni = pkernel.pack_newton_tables(model, pkernel.read_layout(lib), NL)[1]
    assert (ni[NL["N_I_PAIR"]::NL["NPAIR_I"]] == nfacet).all()
    q, qd, ctrl = warm
    got_q, got_qd, got_p = run(q, qd, ctrl, env.frame_skip)
    want_q, want_qd, want_p = _plain(env, q, qd, ctrl, env.frame_skip, model)
    np.testing.assert_allclose(got_q, want_q, **TOL_Q)
    np.testing.assert_allclose(got_qd, want_qd, **TOL_QD)
    _check_picks(env, got_p, want_p)


def test_newton_kernel_body_keeps_nonfinite_states(env, host, warm):
    q, qd, ctrl = (x.copy() for x in warm)
    qd[3, 2] = np.nan
    q[4, 5] = np.inf
    got_q, got_qd, _ = host(q, qd, ctrl, env.frame_skip)
    want_q, want_qd, _ = _plain(env, q, qd, ctrl, env.frame_skip)
    np.testing.assert_array_equal(np.isfinite(got_qd), np.isfinite(want_qd))
    np.testing.assert_array_equal(np.isfinite(got_q), np.isfinite(want_q))
    bad = ~np.isfinite(got_qd).all(axis=0)
    assert bad[2] and bad[5] and bad.sum() == 2


def test_pack_newton_tables_refuses_beyond_maxima(env, lib):
    L, NL = pkernel.read_layout(lib), pkernel.read_newton_layout(lib)
    with pytest.raises(NotImplementedError):
        pkernel.pack_newton_tables(env.model, L, {**NL, "MAX_CAND": 24})
    with pytest.raises(NotImplementedError):
        pkernel.pack_newton_tables(env.model, L, {**NL, "MAX_CHAIN": 7})


def test_newton_wrapper_runs_plain_on_cpu(env):
    m = env.model
    q = torch.as_tensor(np.tile(m.default_qpos[:, None], (1, 3)))
    qd, ctrl = torch.zeros(m.nv, 3), torch.zeros(m.nu, 3)
    kernel = pkernel.NewtonKernel()
    got = kernel(m, q, qd, ctrl, 1)
    want = soa.multistep(m, q, qd, ctrl, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernel.launches == 0  # the CPU path never launches
    penalty = copy.copy(m)
    penalty.constraint_solver = "penalty"
    with pytest.raises(ValueError):
        kernel(penalty, q, qd, ctrl, 1)
    with pytest.raises(ValueError):
        pkernel.MultistepKernel()(m, q, qd, ctrl, 1)


@pytest.mark.cuda
def test_cuda_newton_kernel_matches_plain(env):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(0)
    state, _ = env.reset(1000, torch.Generator().manual_seed(0))
    dev = torch.device("cuda")
    q, qd = state.q.T.contiguous().to(dev), state.qd.T.contiguous().to(dev)
    ctrl = torch.as_tensor(rng.uniform(-1, 1, (8, 1000)), dtype=torch.float32, device=dev)
    kernel = pkernel.NewtonKernel()
    n_sub = env.frame_skip * env.model.n_substeps
    picks = torch.full((n_sub * env.model.solver_iters, 1000), -1, dtype=torch.int32, device=dev)
    got_q, got_qd = kernel(env.model, q, qd, ctrl, env.frame_skip, picks=picks)
    torch.cuda.synchronize()
    want_q, want_qd = soa.multistep(env.model, q, qd, ctrl, env.frame_skip)
    assert kernel.launches == 1 and bool(((picks >= 0) & (picks <= 4)).all())
    # chip_smoke.py's tolerances for K2
    torch.testing.assert_close(got_q, want_q, rtol=0, atol=1e-4)
    torch.testing.assert_close(got_qd, want_qd, rtol=0, atol=1e-2)
