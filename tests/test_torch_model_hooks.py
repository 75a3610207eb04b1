"""The locomotion envs' obs-space hooks of model-based NPG
(mjrl_tpu_torch.envs.locomotion: ``reward_from_obs``,
``terminated_from_obs``, ``_healthy_from_obs`` and the MRO guard)
against the JAX package.

The same observation arrays, drawn with numpy so that many rows lie past
each task's healthy bounds (and, for ant, some hold a non-finite entry),
go through the JAX env's hooks under ``jax.vmap`` and the port's batched
ones: rewards to atol 1e-6 and rtol 1e-6 (humanoid's rewards reach ~10,
where the two packages' sums of 17 squared actions, reduced in another
order, differ by up to 2 f32 ulps), the booleans exactly. A Walker2dEnv subclass
that overrides ``_healthy`` alone raises. On a port hopper rollout
``reward_from_obs`` tracks ``step``'s reward as the JAX package's own test
holds it (mean gap under 0.08).
"""

import jax
import numpy as np
import pytest
import torch

from mjrl_tpu import envs as jenvs
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.envs.locomotion import Walker2dEnv
from mjrl_tpu_torch.models import GaussianMLP
from mjrl_tpu_torch.samplers import sample_episodes

torch.set_num_threads(1)

TASKS = ("hopper", "walker2d", "ant", "humanoid", "half_cheetah", "swimmer")


def _obs_rows(name, do, rng, n=512):
    """Rows around each task's healthy box: z, angle and the rest spread
    past their bounds; a few huge and (ant) non-finite entries."""
    obs = rng.normal(scale=3.0, size=(n, do)).astype(np.float32)
    obs[:, 0] = rng.uniform(-0.2, 2.6, n)  # z (ant, humanoid: q[2])
    obs[:, 1] = rng.uniform(-1.4, 1.4, n)  # the planar walkers' angle
    obs[::7, 3] = rng.choice([-150.0, 150.0], size=obs[::7].shape[0])  # past hopper's 100
    if name == "ant":
        obs[::11, 5] = np.nan
        obs[1::13, 2] = np.inf
    return obs


@pytest.mark.parametrize("name", TASKS)
def test_obs_hooks_match_reference(name):
    jenv = jenvs.make(name)
    env = make(name, device="cpu")
    do, da = env.spec.observation_dim, env.spec.action_dim
    assert jenv.spec.observation_dim == do
    rng = np.random.default_rng(sum(map(ord, name)))
    obs = _obs_rows(name, do, rng)
    nxt = _obs_rows(name, do, rng)
    act = rng.normal(scale=1.5, size=(obs.shape[0], da)).astype(np.float32)
    jr = np.array(jax.vmap(jenv.reward_from_obs)(obs, act, nxt))
    jt = np.array(jax.vmap(jenv.terminated_from_obs)(nxt))
    r = env.reward_from_obs(torch.as_tensor(obs), torch.as_tensor(act), torch.as_tensor(nxt))
    term = env.terminated_from_obs(torch.as_tensor(nxt))
    assert r.shape == term.shape == (obs.shape[0],) and term.dtype == torch.bool
    np.testing.assert_array_equal(term.numpy(), jt)
    finite = np.isfinite(jr)
    np.testing.assert_array_equal(np.isfinite(r.numpy()), finite)
    np.testing.assert_allclose(r.numpy()[finite], jr[finite], rtol=1e-6, atol=1e-6)
    if env.healthy_reward:
        # both sides of the healthy box occur
        assert 0 < int(term.sum()) < obs.shape[0]
    # leading dims: an (N, T, do) batch scores as its rows
    r2 = env.reward_from_obs(torch.as_tensor(obs).reshape(4, -1, do),
                             torch.as_tensor(act).reshape(4, -1, da),
                             torch.as_tensor(nxt).reshape(4, -1, do))
    torch.testing.assert_close(r2.reshape(-1), r, rtol=0, atol=0, equal_nan=True)


def test_a_subclass_overriding_only_healthy_raises():
    """The guard walks the MRO: a Walker2dEnv subclass that overrides
    ``_healthy`` alone inherits Walker2d's ``_healthy_from_obs`` and would
    imagine with the wrong predicate; both hooks raise. One that overrides
    both works, and so do the tasks that never terminate."""

    class TallWalker(Walker2dEnv):
        def _healthy(self, state):
            return state.q[:, 1] > 1.0

    class TallWalkerBoth(TallWalker):
        def _healthy_from_obs(self, obs):
            return obs[..., 0] > 1.0

    obs = torch.tensor([[1.2] + [0.0] * 16, [0.9] + [0.0] * 16])
    for cls in (TallWalker,):
        env = cls(device="cpu")
        with pytest.raises(NotImplementedError, match="_healthy_from_obs"):
            env.terminated_from_obs(obs)
        with pytest.raises(NotImplementedError, match="TallWalker"):
            env.reward_from_obs(obs, torch.zeros(2, 6), obs)
    env = TallWalkerBoth(device="cpu")
    assert env.terminated_from_obs(obs).tolist() == [False, True]
    assert Walker2dEnv(device="cpu").terminated_from_obs(obs).tolist() == [False, False]


def test_hopper_reward_from_obs_tracks_step():
    """The JAX package's hopper check on a port rollout (64 envs x 40
    steps, a (8,) policy at init_log_std 0): on consecutive real
    observations ``reward_from_obs`` (the observed velocity) stays within a
    mean 0.08 of ``step``'s finite-difference reward, and
    ``terminated_from_obs`` flags no step where the episode went on."""
    env = make("hopper", horizon=40, device="cpu")
    policy = GaussianMLP(env.spec, hidden_sizes=(8,), generator=torch.Generator().manual_seed(7))
    b = sample_episodes(env, policy, 64, 40, torch.Generator().manual_seed(2))
    r2 = env.reward_from_obs(b.observations[:, :-1], b.actions[:, :-1], b.observations[:, 1:])
    w = (b.valid[:, :-1] & b.valid[:, 1:]).numpy()
    d = np.abs((b.rewards[:, :-1] - r2).numpy()[w])
    assert w.sum() > 500
    assert d.mean() < 0.08, d.mean()
    term = env.terminated_from_obs(b.observations).numpy()
    assert not term[:, 1:][w].any()
    # the step after a termination holds the terminal observation (the
    # sampler freezes the row), and the obs hook flags it too
    ended = b.terminated.numpy()[:, :-1]
    assert ended.any()
    assert env.terminated_from_obs(b.observations[:, 1:]).numpy()[ended].all()
