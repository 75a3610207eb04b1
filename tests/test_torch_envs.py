"""Parity of the port's ant env (mjrl_tpu_torch.envs) with the JAX package.

One batched ``env.step`` (5 frames x 4 substeps) against
``jax.jit(jax.vmap(env.step))`` on the same states and actions, the reset
with shared noise, and the blow-up guard on a diverged state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import envs as jenvs
from mjrl_tpu.physics.engine import PhysicsState
from mjrl_tpu_torch.envs import EnvState, make

torch.set_num_threads(1)

B = 4


@pytest.fixture(scope="module")
def ants():
    jenv = jenvs.make("ant", horizon=8)
    return make("ant", horizon=8), jenv, jax.jit(jax.vmap(jenv.step))


@pytest.fixture(scope="module")
def warm(ants):
    env = ants[0]
    rng = np.random.default_rng(1)
    state, _ = env.reset(B, torch.Generator().manual_seed(1))
    for _ in range(3):
        a = torch.as_tensor(rng.uniform(-1, 1, (B, 8)), dtype=torch.float32)
        state, *_ = env.step(state, a)
    return state.q.numpy().copy(), state.qd.numpy().copy(), rng.normal(size=(B, 8)).astype(np.float32)


def _both_steps(ants, q, qd, a):
    env, _, jstep = ants
    got = env.step(EnvState(q=torch.as_tensor(q), qd=torch.as_tensor(qd)), torch.as_tensor(a))
    want = jstep(PhysicsState(q=jnp.asarray(q), qd=jnp.asarray(qd)), jnp.asarray(a))
    return got, want


def test_env_step_matches_reference(ants, warm):
    (state, obs, reward, term, info), (jstate, jobs, jreward, jterm, jinfo) = _both_steps(ants, *warm)
    # tests/test_soa.py's bound for a full control frame of substeps
    np.testing.assert_allclose(state.q.numpy(), np.asarray(jstate.q), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(state.qd.numpy(), np.asarray(jstate.qd), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=5e-3, atol=5e-3)
    # reward = x-velocity (q error / 0.05 s) - ctrl cost + healthy
    np.testing.assert_allclose(reward.numpy(), np.asarray(jreward), rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(info["x_velocity"].numpy(), np.asarray(jinfo["x_velocity"]),
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))


def test_blowup_guard_matches_reference(ants, warm):
    q, qd, a = (x.copy() for x in warm)
    qd[1, 3] = np.nan  # a diverged env
    qd[2, 0] = 2e4  # a runaway env, still finite
    (state, obs, reward, term, _), (_, jobs, jreward, jterm, _) = _both_steps(ants, q, qd, a)
    assert term[1] and term[2] and not torch.isfinite(state.qd[1]).all()
    np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
    assert reward[1] == 0.0 and np.asarray(jreward)[1] == 0.0
    assert torch.isfinite(obs).all() and np.isfinite(np.asarray(jobs)).all()
    np.testing.assert_array_equal(obs[1].numpy() == 0.0, np.asarray(jobs)[1] == 0.0)


def test_reset_matches_reference(ants):
    env, jenv, _ = ants
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    # the reference's reset noise, handed to the port
    q_noise = np.asarray(jstate.q) - jenv.model.default_qpos
    state, obs = env.reset_from_noise(torch.as_tensor(q_noise), torch.as_tensor(np.array(jstate.qd)))
    np.testing.assert_allclose(state.q.numpy(), np.asarray(jstate.q), rtol=0, atol=1e-6)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=1e-6)
    # the port's own draw: uniform on q within the scale, normal on qd
    state, _ = env.reset(4096, torch.Generator().manual_seed(0))
    s = env.reset_noise_scale
    dq = state.q - env.qpos0
    assert float(dq.abs().max()) <= s and float(dq.abs().max()) > 0.99 * s
    assert abs(float(state.qd.std()) - s) < 0.05 * s
