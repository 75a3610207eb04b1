"""Hopper with the Newton solver in the port: K2's rows for contacts
between two moving links, and hopper Newton NPG through the entry point on
the CPU.

Hopper's three capsule-capsule pairs join two moving links (thigh, leg and
foot). On states where such a pair lies inside its margin (half the batch
folded by ``physics/probe.py``), the plain Newton substep
(``physics/soa.py`` + ``physics/soa_newton.py``) is held against
``mjrl_tpu.physics.soa`` under ``jax.disable_jit()``, and the g++ host build
of K2's body (``csrc/mj_newton.h``) against the plain version, with at
least one such row held. K2 on hopper on the card:
tests/test_torch_newton_kernel.py's ``cuda`` tests.
"""

import copy
import ctypes
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import envs as jenvs
from mjrl_tpu.physics import soa as jsoa
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.physics import pkernel, probe, soa, soa_newton
from mjrl_tpu_torch.train import load_config, run_job

torch.set_num_threads(1)

B = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# plain vs reference: the same f32 formulas (tests/test_torch_walkers.py)
TOL_Q = dict(rtol=0, atol=1e-5)
TOL_QD = dict(rtol=0, atol=1e-3)
# host build vs plain, one control step (tests/test_torch_newton_kernel.py)
HOST_Q = dict(rtol=1e-5, atol=1e-5)
HOST_QD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def env():
    return make("hopper", horizon=8, device="cpu", constraint_solver="newton")


@pytest.fixture(scope="module")
def states(env):
    """``(q, qd)`` batch-last: B envs after 6 control steps of random
    actions, the second half replaced by folded states with a pair between
    two links overlapping by under 1 cm (inside its margin)."""
    rng = np.random.default_rng(0)
    state, _ = env.reset(B, torch.Generator().manual_seed(0))
    for _ in range(6):
        state, *_ = env.step(state, torch.as_tensor(rng.uniform(-1, 1, (B, 3)), dtype=torch.float32))
    q, qd = state.q.T.numpy().copy(), state.qd.T.numpy().copy()
    q[:, B // 2 :], qd[:, B // 2 :] = probe.overlapping_states(env.model, B - B // 2, rng)
    held = probe.held_contact_rows(env.model, torch.as_tensor(q), between_links=True)
    assert int((held > 0).sum()) >= B // 2
    return q, qd


def test_plain_newton_substep_matches_reference(env, states):
    q, qd = states
    jenv = jenvs.make("hopper", horizon=8, constraint_solver="newton")
    ctrl = np.random.default_rng(1).uniform(-1, 1, (3, B)).astype(np.float32)
    dt = env.model.dt / env.model.n_substeps
    got = soa.substep(env.model, *(torch.as_tensor(x) for x in (q, qd, ctrl)), dt)
    with jax.disable_jit():
        want = jsoa.substep(jenv.model, *(jnp.asarray(x) for x in (q, qd, ctrl)), dt)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL_Q)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL_QD)
    # the rows between links act: without them the folded links pass through
    free = copy.copy(env.model)
    free.contact_pairs = tuple(p for p in free.contact_pairs
                               if min(free.geom_link[g] for g in p) < 0)
    free._pair_groups = None
    alone = soa.substep(free, *(torch.as_tensor(x) for x in (q, qd, ctrl)), dt)
    assert float((alone[1] - got[1])[:, B // 2 :].abs().max()) > 1e-2


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    path = pkernel.build_library("mj_host.cpp", ("g++", *pkernel.GXX_FLAGS),
                                 tmp_path_factory.mktemp("hopper_newton_host"))
    lib = ctypes.CDLL(str(path))
    lib.mj_newton_host.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float]
    return lib


def _host_runner(lib, model):
    """The host build of K2's body: ``run(q, qd, ctrl, n_frames) -> (q, qd,
    picks)`` on batch-last numpy arrays."""
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


def _plain(model, q, qd, ctrl, n_frames):
    picks = []
    out = soa.multistep(model, *(torch.as_tensor(x) for x in (q, qd, ctrl)), n_frames, picks=picks)
    return out[0].numpy(), out[1].numpy(), torch.cat(picks).numpy()


def test_pack_newton_tables_signs_pairs_between_links(env, lib):
    """A pair between two links packs the dofs on one link's chain and not
    the other's, +1 on geom i's link and -1 on geom j's; a pair against the
    floor packs its link's chain, all +1."""
    L, NL = pkernel.read_layout(lib), pkernel.read_newton_layout(lib)
    m = env.model
    ni = pkernel.pack_newton_tables(m, L, NL)[1]
    rows = ni[NL["N_I_PAIR"] :].reshape(-1, NL["NPAIR_I"])
    pairs = [(tab, p) for _, tab in soa.pair_groups(m).kinds for p in range(len(tab["gi"]))]
    between = 0
    for row, (tab, p) in zip(rows, pairs):
        ci = set(soa_newton._chain(m, int(tab["li"][p])))
        cj = set(soa_newton._chain(m, int(tab["lj"][p])))
        n = row[1]
        chain, signs = list(row[2 : 2 + n]), list(row[2 + NL["MAX_CHAIN"] :][:n])
        assert chain == sorted(ci ^ cj) and signs == [1 if j in ci else -1 for j in chain]
        if cj:
            between += 1
            assert 0 < n <= 3 and -1 in signs
        else:
            assert n == len(ci) and set(signs) == {1}
    assert between == 3


def test_newton_kernel_body_matches_plain_along_a_chain(env, lib, states):
    """Three chained control steps of the host build, each held against the
    plain version from the same state; rows between two moving links are
    held in some of them."""
    run = _host_runner(lib, env.model)
    q, qd = states
    rng = np.random.default_rng(2)
    held = 0
    for _ in range(3):
        rows = probe.held_contact_rows(env.model, torch.as_tensor(q), between_links=True)
        held += int((rows > 0).sum())
        ctrl = rng.uniform(-1, 1, (3, B)).astype(np.float32)
        got_q, got_qd, got_p = run(q, qd, ctrl, env.frame_skip)
        want_q, want_qd, want_p = _plain(env.model, q, qd, ctrl, env.frame_skip)
        np.testing.assert_allclose(got_q, want_q, **HOST_Q)
        np.testing.assert_allclose(got_qd, want_qd, **HOST_QD)
        first = np.arange(0, got_p.shape[0], env.model.solver_iters)
        np.testing.assert_array_equal(got_p[first], want_p[first])
        q, qd = got_q, got_qd
    assert held >= B // 2, "no row between two moving links held"


@pytest.mark.parametrize("condim", [3, 4])
def test_newton_kernel_body_matches_plain_with_friction_between_links(env, lib, states, condim):
    """Hopper's pairs between links are frictionless (condim 1, one row);
    with pyramid facets (condim 3) and torsional facets (condim 4) the
    tangent and torsional entries take their dof's sign too."""
    model = copy.copy(env.model)
    model.geom_condim = np.full(model.ngeom, condim, np.int32)
    q, qd = states
    ctrl = np.random.default_rng(3).uniform(-1, 1, (3, B)).astype(np.float32)
    got_q, got_qd, _ = _host_runner(lib, model)(q, qd, ctrl, env.frame_skip)
    want_q, want_qd, _ = _plain(model, q, qd, ctrl, env.frame_skip)
    np.testing.assert_allclose(got_q, want_q, **HOST_Q)
    np.testing.assert_allclose(got_qd, want_qd, **HOST_QD)


def test_newton_wrapper_takes_hopper(env):
    """K2's wrapper runs hopper's Newton model (the plain version on the
    CPU) and its tables pack."""
    m = env.model
    q = torch.as_tensor(np.tile(m.default_qpos[:, None], (1, 3)))
    kernel = pkernel.PhysicsKernel("newton", False)
    got = kernel(m, q, torch.zeros(m.nv, 3), torch.zeros(m.nu, 3), 1)
    want = soa.multistep(m, q, torch.zeros(m.nv, 3), torch.zeros(m.nu, 3), 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and kernel.launches == 0


def test_cli_runs_hopper_npg_newton_and_resumes(tmp_path):
    """examples/hopper_npg_newton.json through the entry point at a tiny
    width, then resumed for one more iteration."""
    config = os.path.join(ROOT, "examples", "hopper_npg_newton.json")
    small = ["num_traj=4", "horizon=20", "save_freq=1"]
    agent = run_job(load_config(config, [*small, "niter=2"]), str(tmp_path), device="cpu")
    assert agent.env.model.constraint_solver == "newton" and agent.iteration == 2
    agent = run_job(load_config(config, [*small, "niter=3"]), str(tmp_path), device="cpu")
    assert agent.iteration == 3
