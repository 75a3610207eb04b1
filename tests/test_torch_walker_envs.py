"""Parity of the port's planar-walker envs (``HopperEnv``, ``Walker2dEnv``,
``HalfCheetahEnv``) with the JAX package's.

Three batched ``env.step`` calls against ``jax.jit(jax.vmap(env.step))``
on the same states and actions at B=2 (each step from the port's state),
the observation's qvel clip, and the reset with the reference's noise
handed over; the port's own reset draws uniform qd noise for hopper and
walker2d and normal noise for half_cheetah, as the reference does.
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

B = 2


@pytest.fixture(scope="module", params=["hopper", "walker2d", "half_cheetah"])
def walkers(request):
    jenv = jenvs.make(request.param, horizon=8)
    return make(request.param, horizon=8, device="cpu"), jenv, jax.jit(jax.vmap(jenv.step))


def test_walker_env_step_matches_reference(walkers):
    env, _, jstep = walkers
    rng = np.random.default_rng(1)
    state, _ = env.reset(B, torch.Generator().manual_seed(1))
    for _ in range(3):
        a = rng.uniform(-1, 1, (B, env.model.nu)).astype(np.float32)
        q, qd = state.q.numpy().copy(), state.qd.numpy().copy()
        state, obs, reward, term, info = env.step(state, torch.as_tensor(a))
        jstate, jobs, jreward, jterm, jinfo = jstep(PhysicsState(q=jnp.asarray(q), qd=jnp.asarray(qd)),
                                                     jnp.asarray(a))
        # test_torch_envs.py's bounds for a control step
        np.testing.assert_allclose(state.q.numpy(), np.asarray(jstate.q), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=5e-3, atol=5e-3)
        # reward = x-velocity (q error / control dt) - ctrl cost + healthy
        np.testing.assert_allclose(reward.numpy(), np.asarray(jreward), rtol=1e-3, atol=2e-3)
        np.testing.assert_allclose(info["x_velocity"].numpy(), np.asarray(jinfo["x_velocity"]),
                                   rtol=1e-3, atol=2e-3)
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))


def test_walker_obs_clips_qvel_as_reference(walkers):
    env, jenv, _ = walkers
    rng = np.random.default_rng(2)
    q = np.tile(env.model.default_qpos, (B, 1)).astype(np.float32)
    qd = rng.uniform(-30, 30, (B, env.model.nv)).astype(np.float32)
    obs = env._obs(EnvState(q=torch.as_tensor(q), qd=torch.as_tensor(qd)))
    jobs = jax.vmap(jenv._obs)(PhysicsState(q=jnp.asarray(q), qd=jnp.asarray(qd)))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    clip = env.clip_qvel_obs
    assert float(obs[:, -env.model.nv :].abs().max()) == (clip if clip is not None else np.abs(qd).max())


def test_walker_reset_matches_reference(walkers):
    env, jenv, _ = walkers
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    # the reference's reset noise, handed to the port
    q_noise = np.asarray(jstate.q) - jenv.model.default_qpos
    state, obs = env.reset_from_noise(torch.as_tensor(q_noise), torch.as_tensor(np.array(jstate.qd)))
    np.testing.assert_allclose(state.q.numpy(), np.asarray(jstate.q), rtol=0, atol=1e-6)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=1e-6)
    # the port's own draw: uniform on q; uniform or normal on qd
    state, _ = env.reset(4096, torch.Generator().manual_seed(0))
    s = env.reset_noise_scale
    dq = (state.q - env.qpos0).abs().max()
    assert 0.99 * s < float(dq) <= s
    if env.reset_vel_noise == "normal":
        assert abs(float(state.qd.std()) - s) < 0.05 * s
    else:
        assert 0.99 * s < float(state.qd.abs().max()) <= s
        assert abs(float(state.qd.std()) - s / 3**0.5) < 0.05 * s
