"""Parity of the port's Newton soft-constraint physics (physics/csolve.py,
physics/soa_newton.py, the Newton branch of physics/soa.py) with the JAX
package.

The solver parameters must equal the reference's; one plain Newton substep
must match the precomputed engine oracle ``tests/golden/ant_newton_substep.npz``
(B=4, dt 0.0025, 3 iterations) and ``mjrl_tpu.physics.soa.substep`` at the
bench row's dt 0.01 from warmed states with feet inside the contact margin
(run under ``jax.disable_jit()``: the reference's Newton program is never
compiled here); a state with no row inside its margin must reduce to the
unconstrained step.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import envs as jenvs
from mjrl_tpu.physics import soa as jsoa
from mjrl_tpu.physics.csolve import ensure_solver_params as j_ensure_solver_params
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.physics import soa
from mjrl_tpu_torch.physics.csolve import ensure_solver_params

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "ant_newton_substep.npz")


def _ant(**kw):
    return make("ant", horizon=8, device="cpu", constraint_solver="newton", **kw)


def test_solver_params_match_reference():
    env, jenv = _ant(), jenvs.make("ant", horizon=8, constraint_solver="newton")
    m, jm = env.model, jenv.model
    ensure_solver_params(m)
    j_ensure_solver_params(jm)
    for name in ("jnt_solref", "jnt_solimp", "geom_solref", "geom_solimp", "geom_margin",
                 "geom_friction_tor", "geom_condim"):
        np.testing.assert_array_equal(getattr(m, name), getattr(jm, name), err_msg=name)
    # the port's own f32 mass matrix, inverted in float64, against the
    # reference's crba: invweights scale every row's R
    for name in ("dof_invweight0", "geom_invweight0"):
        got, want = getattr(m, name), getattr(jm, name)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=name)
    assert m.geom_invweight0[0] == 0.0 and (m.geom_invweight0[1:] > 0).all()  # floor, bodies


def test_newton_substep_matches_golden():
    g = np.load(GOLDEN)
    env = _ant()  # the class default n_substeps=4: dt 0.0025
    model = env.model
    model.solver_iters = int(g["solver_iters"])
    assert float(g["dt"]) == pytest.approx(model.dt / model.n_substeps)
    got_q, got_qd = soa.substep(model, torch.as_tensor(g["q"].T.copy()),
                                torch.as_tensor(g["qd"].T.copy()),
                                torch.as_tensor(g["ctrl"].T.copy()), float(g["dt"]))
    # tests/test_soa_newton.py's tolerances for this golden (engine oracle,
    # cross-backend allowance)
    np.testing.assert_allclose(got_q.numpy().T, g["ref_q"], rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(got_qd.numpy().T, g["ref_qd"], rtol=3e-3, atol=3e-3)


@pytest.fixture(scope="module")
def warm():
    """B=4 ant states (Newton, n_substeps=1) after 12 control steps of
    random actions, with feet inside the contact margin, and a control."""
    env = _ant(n_substeps=1)
    rng = np.random.default_rng(0)
    state, _ = env.reset(4, torch.Generator().manual_seed(0))
    q, qd = state.q.T.contiguous(), state.qd.T.contiguous()
    for _ in range(12):
        ctrl = torch.as_tensor(rng.uniform(-1, 1, (8, 4)), dtype=torch.float32)
        q, qd = soa.multistep(env.model, q, qd, ctrl, env.frame_skip)
    return q.numpy().copy(), qd.numpy().copy(), rng.uniform(-1, 1, (8, 4)).astype(np.float32)


def test_newton_substep_matches_reference(warm):
    env = _ant(n_substeps=1)
    jenv = jenvs.make("ant", horizon=8, constraint_solver="newton", n_substeps=1)
    # 3 iterations take the same code path as the bench's 10 in a third of
    # the reference's eager time
    env.model.solver_iters = jenv.model.solver_iters = 3
    q, qd, ctrl = warm
    pos, quat = soa._fk(env.model, torch.as_tensor(q))
    depth = torch.cat([c.depth for c in soa._contact_candidates(env.model, pos, quat)])
    assert int((depth > -0.02).sum()) > 0, "no contact row inside the margin"
    got_q, got_qd = soa.substep(env.model, torch.as_tensor(q), torch.as_tensor(qd),
                                torch.as_tensor(ctrl), 0.01)
    with jax.disable_jit():
        want_q, want_qd = jsoa.substep(jenv.model, jnp.asarray(q), jnp.asarray(qd),
                                       jnp.asarray(ctrl), 0.01)
    # tests/test_soa.py's per-substep bound (f32 reassociation only)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_qd.numpy(), np.asarray(want_qd), rtol=2e-3, atol=2e-3)


def test_newton_rows_only_activate_in_margin():
    """Mid-air with every limited joint mid-range, no row is inside its
    margin: the Newton substep equals the unconstrained (penalty) one."""
    env = _ant(n_substeps=1)
    model = env.model
    state, _ = env.reset(4, torch.Generator().manual_seed(2))
    q = state.q.T.numpy().copy()
    q[2] += 2.0
    for i in range(model.nlink):
        if model.link_jnt_type[i] == 2 and model.jnt_limited[i] > 0:
            q[model.link_qadr[i]] = 0.5 * sum(model.jnt_range[i])
    qd, ctrl = state.qd.T.contiguous(), torch.zeros(model.nu, 4)
    m_pen = copy.copy(model)
    m_pen.constraint_solver = "penalty"
    picks = []
    got_q, got_qd = soa.substep(model, torch.as_tensor(q), qd, ctrl, 0.01, picks)
    want_q, want_qd = soa.substep(m_pen, torch.as_tensor(q), qd, ctrl, 0.01)
    np.testing.assert_allclose(got_q.numpy(), want_q.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_qd.numpy(), want_qd.numpy(), rtol=1e-4, atol=1e-5)
    assert len(picks) == model.solver_iters
