"""Swimmer in the port: the inertia-box fluid model in the plain physics
(``physics/soa.py``) and in the kernels' shared pipeline
(``csrc/mj_warp_stages.h``), ``SwimmerEnv``, and swimmer NPG through the entry
point on the CPU.

The plain substep and control step are held against ``mjrl_tpu.physics.soa``
(run under ``jax.disable_jit()``, never compiled) on the same numpy inputs,
with either solver; the env's reset and steps against the jitted JAX env;
and the g++ host build of K1's body (penalty) and K2's body (Newton)
against the plain version over 4 chained control steps. K1 on swimmer on
the card: tests/test_torch_kernel_body.py's ``cuda`` tests.
"""

import copy
import ctypes
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import envs as jenvs
from mjrl_tpu.physics import soa as jsoa
from mjrl_tpu.physics.engine import PhysicsState
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.physics import pkernel, soa
from mjrl_tpu_torch.train import load_config, run_job

torch.set_num_threads(1)

B = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# plain vs reference: the same f32 formulas (tests/test_torch_walkers.py)
TOL_Q = dict(rtol=0, atol=1e-5)
TOL_QD = dict(rtol=0, atol=1e-3)
# host build vs plain, one control step: sums in another order
# (tests/test_torch_kernel_body.py)
HOST_Q = dict(rtol=1e-5, atol=1e-5)
HOST_QD = dict(rtol=1e-4, atol=1e-4)


def _states(env, rng, n=B):
    """Batch-last states around the default pose with lively velocities
    (the drag grows with |v|), and the next control."""
    m = env.model
    q = (m.default_qpos[:, None] + rng.uniform(-0.5, 0.5, (m.nq, n))).astype(np.float32)
    qd = rng.uniform(-2.0, 2.0, (m.nv, n)).astype(np.float32)
    return q, qd, rng.uniform(-1, 1, (m.nu, n)).astype(np.float32)


@pytest.fixture(scope="module", params=["penalty", "newton"])
def swimmers(request):
    return (make("swimmer", horizon=8, device="cpu", constraint_solver=request.param),
            jenvs.make("swimmer", horizon=8, constraint_solver=request.param))


def test_swimmer_model_matches_reference(swimmers):
    env, jenv = swimmers
    m = env.model
    for f in dataclasses.fields(jenv.model):
        got, want = getattr(m, f.name), getattr(jenv.model, f.name)
        if isinstance(want, np.ndarray):
            rtol = 1e-5 if f.name in ("dof_limit_stiffness", "dof_limit_damping") else 0
            np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=0, err_msg=f.name)
        elif f.name not in ("dof_invweight0", "geom_invweight0"):  # Newton's, filled at first use
            assert got == want, f.name
    assert (m.density, m.viscosity) == (4000.0, 0.1)
    assert (m.nq, m.nv, m.nu, env.spec.observation_dim) == (5, 5, 2, 8)
    assert not m.contact_pairs and list(m.link_mass[:2]) == [0.0, 0.0]  # two massless slides


def test_swimmer_substep_matches_reference(swimmers):
    env, jenv = swimmers
    q, qd, ctrl = _states(env, np.random.default_rng(0))
    dt = env.model.dt / env.model.n_substeps
    got = soa.substep(env.model, *(torch.as_tensor(x) for x in (q, qd, ctrl)), dt)
    with jax.disable_jit():
        want = jsoa.substep(jenv.model, *(jnp.asarray(x) for x in (q, qd, ctrl)), dt)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL_Q)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL_QD)


def test_swimmer_control_step_matches_reference(swimmers):
    env, jenv = swimmers
    q, qd, ctrl = _states(env, np.random.default_rng(1))
    got = soa.multistep(env.model, *(torch.as_tensor(x) for x in (q, qd, ctrl)), env.frame_skip)
    with jax.disable_jit():
        want = jsoa.multistep(jenv.model, *(jnp.asarray(x) for x in (q, qd, ctrl)), env.frame_skip)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL_Q)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL_QD)


def test_fluid_drag_slows_a_coasting_swimmer():
    """With no control, the drag takes energy out: the speed of a coasting
    swimmer falls, and without the fluid it would not."""
    env = make("swimmer", horizon=8, device="cpu")
    q, qd, _ = _states(env, np.random.default_rng(2))
    ctrl = torch.zeros(env.model.nu, B)
    still = copy.copy(env.model)
    still.density = still.viscosity = 0.0
    args = (torch.as_tensor(q), torch.as_tensor(qd), ctrl, env.frame_skip)
    _, qd_fluid = soa.multistep(env.model, *args)
    _, qd_still = soa.multistep(still, *args)
    speed = lambda v: float(v[:2].norm())
    assert speed(qd_fluid) < speed(torch.as_tensor(qd)) and speed(qd_fluid) < speed(qd_still)


def test_swimmer_env_matches_reference():
    """Reset with the reference's noise, then three batched env steps
    against ``jax.jit(jax.vmap(env.step))`` from the port's states."""
    env, jenv = make("swimmer", horizon=8, device="cpu"), jenvs.make("swimmer", horizon=8)
    jstate, jobs = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(3), 2))
    q_noise = np.asarray(jstate.q) - jenv.model.default_qpos
    state, obs = env.reset_from_noise(torch.as_tensor(q_noise), torch.as_tensor(np.array(jstate.qd)))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=1e-6)
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(1)
    for _ in range(3):
        a = rng.uniform(-1, 1, (2, env.model.nu)).astype(np.float32)
        q, qd = state.q.numpy().copy(), state.qd.numpy().copy()
        state, obs, reward, term, info = env.step(state, torch.as_tensor(a))
        jstate, jobs, jreward, jterm, jinfo = jstep(PhysicsState(q=jnp.asarray(q), qd=jnp.asarray(qd)),
                                                     jnp.asarray(a))
        # tests/test_torch_walker_envs.py's bounds for a control step
        np.testing.assert_allclose(state.q.numpy(), np.asarray(jstate.q), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=5e-3, atol=5e-3)
        np.testing.assert_allclose(reward.numpy(), np.asarray(jreward), rtol=1e-3, atol=2e-3)
        np.testing.assert_allclose(info["x_velocity"].numpy(), np.asarray(jinfo["x_velocity"]),
                                   rtol=1e-3, atol=2e-3)
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
    assert not term.any()  # swimmer never terminates


# ---- a model that turns about every axis ----------------------------------
# Swimmer turns about z alone, so its body and inertia quaternions commute
# and the order of ``quat (x) iquat`` cannot show on it. Ant's links turn
# about every axis and their inertia frames are not their body frames: ant
# in air (MuJoCo's density and viscosity of air) holds that order.
AIR = dict(density=1.2, viscosity=2e-5)


def _ant_in_air(device="cpu"):
    env = make("ant", horizon=8, device=device)
    model = copy.copy(env.model)
    model.__dict__.pop("_torch_consts", None)
    pkernel.drop_tables(model)
    model.density, model.viscosity = AIR["density"], AIR["viscosity"]
    return env, model


def test_fluid_forces_on_a_turning_model_match_reference():
    """The plain ``_fluid_forces`` against the JAX one on ant in air, at
    random poses (unit quaternions), velocities and origins."""
    _, model = _ant_in_air()
    jmodel = dataclasses.replace(jenvs.make("ant", horizon=8).model, **AIR)
    rng = np.random.default_rng(5)
    quats = rng.normal(size=(model.nlink, 4, B))
    args = [rng.normal(size=(model.nlink, 3, B)), quats / np.linalg.norm(quats, axis=1, keepdims=True),
            rng.uniform(-2, 2, (model.nlink, 6, B)), rng.normal(size=(3, B))]
    args = [x.astype(np.float32) for x in args]
    got = soa._fluid_forces(model, *([torch.as_tensor(x) for x in a] if i < 3 else torch.as_tensor(a)
                                     for i, a in enumerate(args)), None)
    want = jsoa._fluid_forces(jmodel, *([jnp.asarray(x) for x in a] if i < 3 else jnp.asarray(a)
                                        for i, a in enumerate(args)), None)
    assert sorted(got) == sorted(want) and len(got) == int((model.link_mass > 0).sum())
    for link, wrench in want.items():
        # the same f32 formulas; the port folds the drag constants in f64
        np.testing.assert_allclose(got[link].numpy(), np.asarray(wrench), rtol=1e-5, atol=1e-6)
        assert np.abs(np.asarray(wrench)).max() > 1e-3  # large against the tolerance


def test_kernel_body_matches_plain_on_a_turning_model(lib):
    """One control step of the host build of K1's body on ant in air
    against the plain version; the fluid moves the step far beyond the
    tolerance."""
    env, model = _ant_in_air()
    rng = np.random.default_rng(6)
    state, _ = env.reset(B, torch.Generator().manual_seed(6))
    q = state.q.T.numpy().copy()
    qd = (state.qd.T.numpy() + rng.uniform(-0.5, 0.5, (model.nv, B))).astype(np.float32)
    ctrl = rng.uniform(-1, 1, (model.nu, B)).astype(np.float32)
    got_q, got_qd = _host_step(lib, model, q, qd, ctrl, env.frame_skip)
    want_q, want_qd = (x.numpy() for x in soa.multistep(
        model, *(torch.as_tensor(x) for x in (q, qd, ctrl)), env.frame_skip))
    np.testing.assert_allclose(got_q, want_q, **HOST_Q)
    np.testing.assert_allclose(got_qd, want_qd, **HOST_QD)
    _, still_qd = soa.multistep(env.model, *(torch.as_tensor(x) for x in (q, qd, ctrl)),
                                env.frame_skip)
    assert np.abs(still_qd.numpy() - want_qd).max() > 100 * HOST_QD["atol"]


# ---- the kernels' bodies on the CPU (g++ host build) ---------------------


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    path = pkernel.build_library("mj_host.cpp", ("g++", *pkernel.GXX_FLAGS),
                                 tmp_path_factory.mktemp("swimmer_host"))
    lib = ctypes.CDLL(str(path))
    lib.mj_multistep_host.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.mj_newton_host.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float]
    return lib


def _host_step(lib, model, q, qd, ctrl, n_frames):
    """One call of the host build of K1's body (penalty) or K2's (Newton)."""
    L = pkernel.read_layout(lib)
    mf, mi = pkernel.pack_tables(model, L)
    q, qd, ctrl = (np.ascontiguousarray(x, np.float32) for x in (q, qd, ctrl))
    q_out, qd_out = np.empty_like(q), np.empty_like(qd)
    n_sub, dt = n_frames * model.n_substeps, float(np.float32(model.dt / model.n_substeps))
    if model.constraint_solver == "penalty":
        ptr = [a.ctypes.data for a in (mf, mi, q, qd, ctrl, q_out, qd_out)]
        assert lib.mj_multistep_host(*ptr, q.shape[1], n_sub, dt) == 0
    else:
        nf, ni = pkernel.pack_newton_tables(model, L, pkernel.read_newton_layout(lib))
        picks = np.full((n_sub * model.solver_iters, q.shape[1]), -1, np.int32)
        ptr = [a.ctypes.data for a in (mf, mi, nf, ni, q, qd, ctrl, q_out, qd_out, picks)]
        assert lib.mj_newton_host(*ptr, q.shape[1], n_sub, model.solver_iters, dt) == 0
    return q_out, qd_out


def test_pack_tables_carries_the_fluid_constants(lib):
    L = pkernel.read_layout(lib)
    m = make("swimmer", horizon=8, device="cpu").model
    mf, mi = pkernel.pack_tables(m, L)
    assert mi[L["I_HAS_FLUID"]] == 1
    np.testing.assert_array_equal(mf[L["F_IQUAT"] :][: 4 * m.nlink], m.link_iquat.reshape(-1))
    rows = mf[L["F_FLUID"] :][: L["FLUID_F"] * m.nlink].reshape(m.nlink, L["FLUID_F"])
    assert not rows[:2].any()  # the massless slide links feel no drag
    for i in range(2, m.nlink):
        lin, ang, quad_f, quad_t = soa.fluid_coefficients(m, i)
        np.testing.assert_array_equal(rows[i], np.float32([lin, ang, *quad_f, *quad_t]))
    for name in ("hopper", "ant"):
        assert pkernel.pack_tables(make(name, horizon=8, device="cpu").model, L)[1][L["I_HAS_FLUID"]] == 0


@pytest.mark.parametrize("solver", ["penalty", "newton"])
def test_kernel_body_matches_plain_along_a_chain(lib, solver):
    """Four chained control steps of the host build (K1's body with the
    penalty solver, K2's with the Newton solver), each held against the
    plain version from the same state."""
    env = make("swimmer", horizon=8, device="cpu", constraint_solver=solver)
    rng = np.random.default_rng(3)
    q, qd, _ = _states(env, rng, 8)
    for _ in range(4):
        ctrl = rng.uniform(-1, 1, (env.model.nu, 8)).astype(np.float32)
        got_q, got_qd = _host_step(lib, env.model, q, qd, ctrl, env.frame_skip)
        want_q, want_qd = (x.numpy() for x in soa.multistep(
            env.model, *(torch.as_tensor(x) for x in (q, qd, ctrl)), env.frame_skip))
        np.testing.assert_allclose(got_q, want_q, **HOST_Q)
        np.testing.assert_allclose(got_qd, want_qd, **HOST_QD)
        assert np.abs(got_qd - qd).max() > 1e-1  # the step moved the bodies
        q, qd = got_q, got_qd


def test_cli_runs_swimmer_npg_and_resumes(tmp_path):
    """examples/swimmer_npg.json through the entry point at a tiny width,
    then resumed for one more iteration."""
    config = os.path.join(ROOT, "examples", "swimmer_npg.json")
    small = ["num_traj=4", "horizon=20", "save_freq=1"]
    agent = run_job(load_config(config, [*small, "niter=2"]), str(tmp_path), device="cpu")
    assert agent.env.model.density == 4000.0 and agent.iteration == 2
    agent = run_job(load_config(config, [*small, "niter=3"]), str(tmp_path), device="cpu")
    assert agent.iteration == 3
    with open(tmp_path / "logs" / "log.csv") as f:
        rows = f.read().splitlines()[1:]
    assert len(rows) == 3
