"""Parity of the port's per-env engine (mjrl_tpu_torch.physics.engine) with
the JAX package's, and with the port's plain batch-last stepper.

The engine is batch-first; the reference's runs per env, here under
``jax.jit(jax.vmap(...))`` (hopper, ant and the two small models compile in
a few seconds; the JAX Newton engine is never compiled for ant). From the
same numpy-seeded states, B = 6: the mass matrix, the bias forces with the
contact and fluid wrenches, forward dynamics, ``integrate`` and one
penalty substep, on hopper, ant, swimmer (the fluid), the ball-joint chain
and the link-mounted planes of physics/probe.py. The Newton engine is held
against the engine goldens ``tests/golden/{ant,adroit_pen,adroit_hammer}
_newton_substep.npz`` (tools/gen_newton_golden.py: one substep of the JAX
engine, 3 Newton iterations, Adroit with link offsets) at
``tests/test_soa_newton.py``'s tolerances. Then the second oracle: one
control step of the engine against the plain stepper (physics/soa.py, the
kernels' plain version) from the same states.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import envs as jenvs
from mjrl_tpu.physics import contact as jcontact
from mjrl_tpu.physics import engine as jengine
from mjrl_tpu.physics import math3d as jm3
from mjrl_tpu.physics import model as jmodel
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.physics import engine, probe, soa
from mjrl_tpu_torch.physics import math3d as m3
from mjrl_tpu_torch.physics.contact import contact_forces

torch.set_num_threads(1)

B = 6
# one substep against the JAX engine: no looser than tests/test_soa.py's
# engine-vs-fast-path bounds per substep (q 2e-4 / 2e-5, qd 2e-3 / 2e-3);
# the same f32 formulas with a few sums in another order read under 1e-6 /
# 1e-4 here
TOL_STEP_Q = dict(rtol=2e-4, atol=2e-5)
TOL_STEP_QD = dict(rtol=2e-3, atol=2e-3)
# the mass matrix, bias and qdd: f32 round-off through the same formulas
TOL_DYN = dict(rtol=1e-4, atol=1e-4)
# the Newton goldens: tests/test_soa_newton.py's tolerances
TOL_GOLDEN_Q = dict(rtol=3e-4, atol=3e-5)
TOL_GOLDEN_QD = dict(rtol=3e-3, atol=3e-3)


def _env_case(name):
    env = make(name, horizon=8, device="cpu")
    jenv = jenvs.make(name, horizon=8)
    rng = np.random.default_rng(0)
    state, _ = env.reset(B, torch.Generator().manual_seed(0))
    for _ in range(5):
        a = torch.as_tensor(rng.uniform(-1, 1, (B, env.spec.action_dim)), dtype=torch.float32)
        state, *_ = env.step(state, a)
    q, qd = state.q.numpy().copy(), state.qd.numpy().copy()
    if name in ROOT_Z:
        # lower the root so that each env's deepest contact point is 5 mm
        # into the floor, and slow it down so that the contact pushes
        depth = probe.kind_depth(env.model, state.q.T.contiguous())
        q[:, ROOT_Z[name]] -= 0.005 - np.max([d.numpy() for d in depth.values()], axis=0)
        qd *= 0.1
    ctrl = rng.uniform(-1, 1, (B, env.spec.action_dim)).astype(np.float32)
    return env.model, jenv.model, q, qd, ctrl


def _probe_case(name):
    fn = {"ball_chain": probe.ball_chain_model, "link_plane": probe.link_plane_model}[name]
    m, jm = fn(), fn(jmodel.ModelBuilder)
    q, qd, ctrl = probe.engine_states(m, B, np.random.default_rng(1))
    return m, jm, q, qd, ctrl


CASES = ("hopper", "ant", "swimmer", "ball_chain", "link_plane")
ROOT_Z = {"hopper": 1, "ant": 2}  # the root's height in q


@pytest.fixture(scope="module", params=CASES)
def case(request):
    name = request.param
    m, jm, q, qd, ctrl = (_probe_case if name in ("ball_chain", "link_plane") else _env_case)(name)
    # one substep of the model's dt, on both sides
    sub = []
    for model in (m, jm):
        one = copy.copy(model)
        one.__dict__ = {k: v for k, v in model.__dict__.items() if not k.startswith("_")}
        one.dt, one.n_substeps = model.dt / model.n_substeps, 1
        sub.append(one)
    qdd = np.random.default_rng(2).standard_normal((B, m.nv)).astype(np.float32)
    return name, sub[0], sub[1], q, qd, ctrl, qdd


def _jax_side(jm, q, qd, ctrl, qdd):
    def one(q, qd, c, a):
        ps = jengine.PhysicsState(q, qd)
        kin = jengine.compute_kinematics(jm, ps)
        f_ext = jnp.zeros((jm.nlink, 6))
        if jm.contact_pairs:
            f_ext = f_ext + jcontact.contact_forces(jm, kin)
        if jm.density or jm.viscosity:
            f_ext = f_ext + jengine.fluid_forces(jm, kin)
        integ = jengine.integrate(jm, ps, a)
        stepped = jengine.step(jm, ps, c)
        return dict(M=jengine.crba(jm, kin), C=jengine.rnea_bias(jm, kin, f_ext_world=f_ext),
                    f_ext=f_ext, qdd=jengine.forward_dynamics(jm, ps, c, f_ext, kin=kin),
                    int_q=integ.q, int_qd=integ.qd, q=stepped.q, qd=stepped.qd)

    out = jax.jit(jax.vmap(one))(q, qd, ctrl, qdd)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_side(m, q, qd, ctrl, qdd):
    q, qd, ctrl, qdd = map(torch.as_tensor, (q, qd, ctrl, qdd))
    ps = engine.PhysicsState(q, qd)
    kin = engine.compute_kinematics(m, q, qd)
    f_ext = q.new_zeros(q.shape[0], m.nlink, 6)
    if m.contact_pairs:
        f_ext = f_ext + contact_forces(m, kin)
    if m.density or m.viscosity:
        f_ext = f_ext + engine.fluid_forces(m, kin)
    integ = engine.integrate(m, ps, qdd)
    stepped = engine.step(m, ps, ctrl)
    out = dict(M=engine.crba(m, kin), C=engine.rnea_bias(m, kin, f_ext), f_ext=f_ext,
               qdd=engine.forward_dynamics(m, ps, ctrl, f_ext, kin=kin), int_q=integ.q,
               int_qd=integ.qd, q=stepped.q, qd=stepped.qd)
    return {k: v.numpy() for k, v in out.items()}


def test_engine_matches_jax_engine(case):
    """crba, rnea_bias (with the contact and fluid wrenches), forward
    dynamics, integrate and one penalty substep against the JAX engine."""
    name, m, jm, q, qd, ctrl, qdd = case
    want = _jax_side(jm, q, qd, ctrl, qdd)
    got = _port_side(m, q, qd, ctrl, qdd)
    scale = max(1.0, float(np.abs(want["M"]).max()))
    np.testing.assert_allclose(got["M"], want["M"], rtol=1e-5, atol=1e-6 * scale, err_msg="M")
    fscale = max(1.0, float(np.abs(want["f_ext"]).max()))
    np.testing.assert_allclose(got["f_ext"], want["f_ext"], rtol=1e-4, atol=1e-5 * fscale,
                               err_msg="f_ext")
    for k in ("C", "qdd"):
        s = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=TOL_DYN["rtol"], atol=1e-5 * s, err_msg=k)
    np.testing.assert_allclose(got["int_q"], want["int_q"], rtol=1e-6, atol=1e-6, err_msg="int_q")
    np.testing.assert_allclose(got["int_qd"], want["int_qd"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["q"], want["q"], **TOL_STEP_Q, err_msg=f"{name} q")
    np.testing.assert_allclose(got["qd"], want["qd"], **TOL_STEP_QD, err_msg=f"{name} qd")
    if name == "ball_chain":
        # the exponential map keeps the ball joints' quaternions unit
        norms = np.linalg.norm(got["q"].reshape(B, 2, 4), axis=-1)
        np.testing.assert_allclose(norms, 1.0, atol=1e-6)
    # a contact in every env of hopper and ant, in some of the small
    # models'; swimmer's drag
    pushed = np.abs(want["f_ext"]).reshape(B, -1).max(axis=1) > 0
    assert pushed.all() if name in ROOT_Z else pushed.any()


@pytest.mark.parametrize("name", ["ant", "adroit_pen", "adroit_hammer"])
def test_newton_engine_matches_golden(name):
    """One Newton substep (the golden's solver iterations and link offsets)
    against the JAX engine's, stored."""
    import os

    g = np.load(os.path.join(os.path.dirname(__file__), "golden", f"{name}_newton_substep.npz"))
    m = make(name, device="cpu", constraint_solver="newton").model
    m.n_substeps, m.dt, m.solver_iters = 1, float(g["dt"]), int(g["solver_iters"])
    delta = torch.as_tensor(g["link_delta"]) if "link_delta" in g.files else None
    out = engine.step(m, engine.PhysicsState(torch.as_tensor(g["q"]), torch.as_tensor(g["qd"])),
                      torch.as_tensor(g["ctrl"]), link_pos_delta=delta)
    np.testing.assert_allclose(out.q.numpy(), g["ref_q"], **TOL_GOLDEN_Q)
    np.testing.assert_allclose(out.qd.numpy(), g["ref_qd"], **TOL_GOLDEN_QD)


def test_quaternion_helpers_and_subspaces_match_reference():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v = rng.standard_normal((5, 3)).astype(np.float32)
    w = np.concatenate([rng.standard_normal((4, 3)), np.zeros((1, 3))]).astype(np.float32)
    tq, tv, tw = map(torch.as_tensor, (q, v, w))
    np.testing.assert_allclose(m3.quat_rotate_inv(tq, tv).numpy(),
                               np.asarray(jm3.quat_rotate_inv(q, v)), atol=1e-6)
    np.testing.assert_allclose(m3.quat_integrate(tq, tw, 0.01).numpy(),
                               np.asarray(jm3.quat_integrate(q, w, 0.01)), atol=1e-6)
    six = rng.standard_normal((2, 5, 6)).astype(np.float32)
    np.testing.assert_allclose(m3.crm(*map(torch.as_tensor, six)).numpy(),
                               np.asarray(jm3.crm(*six)), atol=1e-5)
    np.testing.assert_allclose(m3.crf(*map(torch.as_tensor, six)).numpy(),
                               np.asarray(jm3.crf(*six)), atol=1e-5)
    m, jm = probe.ball_chain_model(), probe.ball_chain_model(jmodel.ModelBuilder)
    for got, want in zip(engine.joint_subspaces(m), jengine.joint_subspaces(jm)):
        np.testing.assert_allclose(got, want, atol=1e-7)


# the engine against the plain stepper: one control step from the same
# states. Both are f32 with the same physics, the plain one a sparse L^T D L
# per dof chain and its own Newton rows where the engine factors the dense
# matrix and builds every row; on these states they part by up to 1.5e-7 in
# q and 2.6e-5 in qd (pen), so ten times that, up to a power of ten
TOL_ORACLE = dict(q=1e-5, qd=1e-3)


@pytest.mark.parametrize("name,solver", [("hopper", "penalty"), ("hopper", "newton"),
                                         ("adroit_pen", "penalty"), ("adroit_pen", "newton")])
def test_engine_matches_plain_stepper(name, solver):
    """The second oracle: ``frame_skip`` calls of ``engine.step`` against
    ``soa.multistep`` (the kernels' plain version) over one control step,
    from hopper's folded states (a capsule-capsule pair overlapping) and
    pen's ``probe.kind_states`` (each of its five kinds touching, with the
    link offsets that lower the hand or the pen)."""
    env = make(name, horizon=8, device="cpu", constraint_solver=solver)
    m = env.model
    if solver == "newton":
        m.solver_iters = 3
    rng = np.random.default_rng(4)
    delta = None
    if name == "hopper":
        q, qd = map(torch.as_tensor, probe.overlapping_states(m, 4, rng))
    else:
        q, qd, d = map(torch.as_tensor, probe.kind_states(m, 1, rng))
        delta = d.T.reshape(-1, m.nlink, 3).contiguous()
    n = q.shape[1]
    ctrl = torch.as_tensor(rng.uniform(-1, 1, (n, m.nu)), dtype=torch.float32)
    if name == "adroit_pen":
        ctrl = env._scaled_ctrl(ctrl)
    ps = engine.PhysicsState(q.T.contiguous(), qd.T.contiguous())
    for _ in range(env.frame_skip):
        ps = engine.step(m, ps, ctrl, link_pos_delta=delta)
    dl = None if delta is None else delta.reshape(n, -1).T.contiguous()
    q2, qd2 = soa.multistep(m, q.contiguous(), qd.contiguous(), ctrl.T.contiguous(),
                            env.frame_skip, link_delta=dl)
    assert np.abs(ps.q.numpy() - q2.T.numpy()).max() <= TOL_ORACLE["q"]
    assert np.abs(ps.qd.numpy() - qd2.T.numpy()).max() <= TOL_ORACLE["qd"]
