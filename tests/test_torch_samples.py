"""Parity of the port's samples mode (the auto-reset sampler with its
persistent carry, the bootstrapped returns, the samples-mode train step)
with the JAX package, on the Newton ant at ``n_substeps=1``.

A tiny run (N=4 envs, windows of T=3 steps, episode horizon H=4, policy
hidden (8, 8), MLPBaseline epochs=2 batch_size=4, 2 Newton iterations)
goes through the JAX agent's ``sample_batch_carry`` and
``_finish_train_step`` (= its ``train_step_carry``) from a hand-made carry
whose rows are at different points of their episodes, so rows truncate at
the horizon, terminate (a healthy z range narrowed to (0.70, 1.0)) and
reset inside the window. The port gets the same weights, the same carry,
the reference-drawn reset and action noise and the reference's minibatch
permutations, all re-derived here from the reference's keys.

The reference's outputs come from ``tests/golden/ant_newton_samples.npz``,
written by ``tools/gen_samples_golden.py`` from the setup below: run
eagerly, the reference's Newton physics takes minutes per control step on
a CPU, and its program is never compiled in these tests.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.algos import NPG as JNPG
from mjrl_tpu.envs.locomotion import AntEnv as JAntEnv
from mjrl_tpu.models import GaussianMLP as JGaussianMLP
from mjrl_tpu.models import MLPBaseline as JMLPBaseline
from mjrl_tpu.physics.engine import PhysicsState
from mjrl_tpu_torch.algos import NPG
from mjrl_tpu_torch.convert import baseline_from_jax, policy_flat_from_jax, policy_from_jax
from mjrl_tpu_torch.envs import EnvState, make
from mjrl_tpu_torch.ops.ravel import ravel
from mjrl_tpu_torch.samplers import (
    AutoresetNoise,
    SamplerCarry,
    carry_from_noise,
    rollout,
    run_autoreset,
)
from mjrl_tpu_torch.types import TrajectoryBatch

torch.set_num_threads(1)

N, T, H, EPOCHS, MB, ITERS = 4, 3, 4, 2, 4, 2
Z_RANGE = (0.70, 1.0)


class _NarrowAnt(JAntEnv):
    def _healthy(self, ps):
        z = ps.q[2]
        finite = jnp.all(jnp.isfinite(ps.q)) & jnp.all(jnp.isfinite(ps.qd))
        return finite & (z > Z_RANGE[0]) & (z < Z_RANGE[1])


def _jax_env(horizon):
    jenv = _NarrowAnt(horizon=horizon, constraint_solver="newton", n_substeps=1)
    jenv.model.solver_iters = ITERS
    return jenv


def _port_env(horizon):
    env = make("ant", horizon=horizon, device="cpu", constraint_solver="newton", n_substeps=1)
    env.model.solver_iters = ITERS
    env.healthy_z_range = Z_RANGE
    return env


def _reset_noise(jenv, keys):
    """The reset noise the reference's ``env.reset`` draws from each key."""
    s = jenv.reset_noise_scale
    q, qd = [], []
    for rk in keys:
        kq, kv = jax.random.split(rk)
        q.append(jax.random.uniform(kq, (jenv.model.nq,), minval=-s, maxval=s))
        qd.append(s * jax.random.normal(kv, (jenv.model.nv,)))
    return np.array(jnp.stack(q)), np.array(jnp.stack(qd))


def _jax_noise(jenv, k_sample, num_steps):
    """The per-step action and reset noise of the reference's
    ``sample_autoreset`` under ``k_sample``, and its initial reset noise."""
    key_reset, key = jax.random.split(k_sample)
    eps, rq, rqd = [], [], []
    for _ in range(num_steps):
        key, k_act, k_reset = jax.random.split(key, 3)
        eps.append(np.array(jax.random.normal(k_act, (N, jenv.spec.action_dim))))
        q, qd = _reset_noise(jenv, jax.random.split(k_reset, N))
        rq.append(q)
        rqd.append(qd)
    t = lambda xs: torch.as_tensor(np.stack(xs))
    noise = AutoresetNoise(reset_q=t(rq), reset_qd=t(rqd), action=t(eps))
    return noise, _reset_noise(jenv, jax.random.split(key_reset, N))


def _carry_arrays():
    """Rows at different heights and points of their episodes."""
    rng = np.random.default_rng(0)
    env = _port_env(H)
    q = env.model.default_qpos + rng.uniform(-0.1, 0.1, (N, env.model.nq))
    q[:, 2] += [0.0, 0.1, -0.03, 0.05]
    qd = 0.1 * rng.normal(size=(N, env.model.nv))
    return (q.astype(np.float32), qd.astype(np.float32), np.array([0, 1, 3, 2], np.int32),
            np.array([0.0, 1.5, -2.0, 0.7], np.float32))


def _port_carry(env, q, qd, t_in_ep, ep_ret) -> SamplerCarry:
    state = EnvState(q=torch.as_tensor(q), qd=torch.as_tensor(qd))
    return SamplerCarry(state, env._obs(state), torch.as_tensor(t_in_ep), torch.as_tensor(ep_ret))


GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "ant_newton_samples.npz")


def jax_agent_and_carry():
    """The reference agent, its initial state and the hand-made carry."""
    jenv = _jax_env(H)
    agent = JNPG(jenv, JGaussianMLP(jenv.spec, hidden_sizes=(8, 8)),
                 JMLPBaseline(jenv.spec, epochs=EPOCHS, batch_size=MB),
                 normalized_step_size=0.05, num_traj=N, num_samples=N * T, horizon=H,
                 sample_mode="samples")
    state0 = agent.init(jax.random.PRNGKey(0))
    q, qd, t_in_ep, ep_ret = _carry_arrays()
    ps = PhysicsState(q=jnp.asarray(q), qd=jnp.asarray(qd))
    carry0 = (ps, jax.vmap(jenv._obs)(ps), jnp.asarray(t_in_ep), jnp.asarray(ep_ret), jnp.zeros(N))
    return agent, state0, carry0


def train_keys():
    """``train_step_carry``'s split of its key: (sample, update, fit)."""
    return jax.random.split(jax.random.PRNGKey(1), 3)


def nocarry_setup():
    """The reference env, policy, weights and key of the no-carry window."""
    jenv = _jax_env(2)
    policy = JGaussianMLP(jenv.spec, hidden_sizes=(8, 8))
    return jenv, policy, policy.init(jax.random.PRNGKey(3)), policy.init_transforms(), \
        jax.random.PRNGKey(4)


def _golden_batch(g, prefix) -> TrajectoryBatch:
    t = lambda name: torch.as_tensor(g[f"{prefix}_{name}"])
    zeros = torch.zeros_like(t("rewards"))
    info = {k[len(prefix) + 6:]: torch.as_tensor(g[k]) for k in g.files
            if k.startswith(f"{prefix}_info_")}
    return TrajectoryBatch(
        observations=t("observations"), actions=t("actions"), rewards=t("rewards"),
        valid=t("valid"), done=t("done"), terminated=t("terminated"), mean=t("mean"),
        log_std=t("log_std"), log_prob=t("log_prob"), time=t("time"), returns=zeros,
        baseline=zeros, advantages=zeros, env_info=info)


@pytest.fixture(scope="module")
def ref():
    g = np.load(GOLDEN)
    agent, state0, _ = jax_agent_and_carry()
    k_sample, _, k_fit = train_keys()
    m = N * T
    perms = [torch.as_tensor(np.array(jax.random.permutation(k, m)[: m // MB * MB].reshape(-1, MB)))
             for k in jax.random.split(k_fit, EPOCHS)]
    return dict(
        g=g, state0=jax.tree.map(np.array, state0), batch=_golden_batch(g, "carry"),
        metrics={k[len("metric_"):]: float(g[k]) for k in g.files if k.startswith("metric_")},
        noise=_jax_noise(agent.env, k_sample, T)[0], perms=perms,
    )


def _port_agent(ref):
    env = _port_env(H)
    state0 = ref["state0"]
    policy = policy_from_jax(state0.params, env.spec)
    baseline = baseline_from_jax(state0.baseline_state, env.spec, epochs=EPOCHS, batch_size=MB)
    return NPG(env, policy, baseline, normalized_step_size=0.05, num_traj=N, num_samples=N * T,
               horizon=H, sample_mode="samples")


# three control steps of Newton physics between the two f32 engines
_BATCH_TOL = (("observations", 1e-3), ("actions", 1e-4), ("mean", 1e-4), ("log_std", 0.0),
              ("log_prob", 1e-3), ("rewards", 2e-3))


def _check_batch(got, want):
    for name in ("valid", "done", "terminated", "time"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name).numpy(),
                                      err_msg=name)
    for name, tol in _BATCH_TOL:
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name).numpy(),
                                   rtol=tol, atol=tol, err_msg=name)
    assert set(got.env_info) == set(want.env_info) == {"x_velocity", "episode_score"}
    for name in sorted(want.env_info):
        np.testing.assert_allclose(got.env_info[name].numpy(), want.env_info[name].numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=name)


def test_sample_autoreset_with_carry_matches_reference(ref):
    jb, g = ref["batch"], ref["g"]
    # the window holds a truncation, a termination and a reset, and
    # episodes that end inside it with their whole score
    assert jb.done.any() and jb.terminated.any() and (jb.done & ~jb.terminated).any()
    assert (jb.env_info["episode_score"] != 0).any()
    agent = _port_agent(ref)
    carry = _port_carry(agent.env, *_carry_arrays())
    got, carry1 = run_autoreset(agent.env, agent.policy, ref["noise"], carry, H)
    _check_batch(got, jb)
    np.testing.assert_array_equal(carry1.t_in_ep.numpy(), g["carry1_t_in_ep"])
    np.testing.assert_allclose(carry1.state.q.numpy(), g["carry1_q"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(carry1.state.qd.numpy(), g["carry1_qd"], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(carry1.obs.numpy(), g["carry1_obs"], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(carry1.ep_return.numpy(), g["carry1_ep_return"], rtol=2e-3,
                               atol=2e-3)


def test_sample_autoreset_without_carry_matches_reference(ref):
    """All rows from reset; the episode horizon 2 truncates every row at
    its second step, so the third starts from the step's reset draw."""
    jenv, _, params, _, key = nocarry_setup()
    want = _golden_batch(ref["g"], "nocarry")
    noise, (q0, qd0) = _jax_noise(jenv, key, T)
    env = _port_env(2)
    carry = carry_from_noise(env, torch.as_tensor(q0), torch.as_tensor(qd0))
    got, carry1 = run_autoreset(env, policy_from_jax(params, env.spec), noise, carry, 2)
    assert want.done[:, 1].all()
    _check_batch(got, want)
    assert (got.time[:, 2] == 0).all()  # every row began an episode at its third step
    assert (carry1.t_in_ep == 1).all()


def test_process_batch_bootstraps_like_reference(ref):
    """returns (bootstrapped with V(s_last) on rows cut mid-episode), GAE
    and normalization on the reference's own batch."""
    agent = _port_agent(ref)
    jb = ref["batch"]
    assert not jb.done[:, -1].all()
    pb = agent.process_batch(jb)
    for name in ("returns", "baseline", "advantages"):
        np.testing.assert_allclose(getattr(pb, name).numpy(), ref["g"][f"pbatch_{name}"],
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_train_step_matches_reference(ref, monkeypatch):
    """The slice as a whole: the carry path of ``train_step`` -> returns
    with bootstrap / GAE -> NPG -> fit -> statistics from episode_score."""
    agent = _port_agent(ref)
    agent.sampler_carry = _port_carry(agent.env, *_carry_arrays())
    monkeypatch.setattr(rollout, "draw_autoreset_noise", lambda *a, **k: ref["noise"])
    monkeypatch.setattr(agent.baseline, "fit_perms", lambda *a, **k: ref["perms"])
    got = {k: float(v) for k, v in agent.train_step().items()}
    want = ref["metrics"]
    assert set(got) == set(want)
    assert got["num_samples"] == want["num_samples"] == N * T and agent.iteration == 1
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-3, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(agent.sampler_carry.t_in_ep.numpy(), ref["g"]["carry1_t_in_ep"])
    got_flat, _ = ravel({k: v.detach() for k, v in agent.policy.named_parameters()})
    want_flat = policy_flat_from_jax(ref["g"]["params1_flat"], agent.policy)
    np.testing.assert_allclose(got_flat.numpy(), want_flat.numpy(), rtol=1e-3, atol=3e-4)


def test_train_step_keeps_the_carry():
    env = _port_env(H)
    init = torch.Generator().manual_seed(0)
    from mjrl_tpu_torch.models import GaussianMLP, MLPBaseline

    agent = NPG(env, GaussianMLP(env.spec, hidden_sizes=(8, 8), generator=init),
                MLPBaseline(env.spec, epochs=1, batch_size=MB, generator=init),
                num_traj=N, num_samples=N * T, horizon=H, sample_mode="samples")
    gen = torch.Generator().manual_seed(1)
    assert agent.sampler_carry is None
    agent.train_step(gen)
    first = agent.sampler_carry
    # H=4 > T=3: a row that did not terminate is mid-episode after a window
    assert first is not None and (first.t_in_ep > 0).any()
    metrics = agent.train_step(gen)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert agent.sampler_carry is not first and agent.iteration == 2
    agent.reset_sampler_carry()
    assert agent.sampler_carry is None
