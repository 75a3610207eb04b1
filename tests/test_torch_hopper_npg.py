"""One hopper NPG train step of the port against the JAX package's.

Hopper learns a little slower in the port than in the reference with
either solver (ROADMAP queue 3). This holds one train step of
``examples/hopper_npg.json``'s agent (NPG, normalized_step_size 0.05,
MLPBaseline epochs 2, gamma 0.995, GAE 0.97) at a small width on the CPU
against the JAX agent's ``sample_batch`` and ``_finish_train_step``: N=6
envs x T=24 steps, policy hidden (16, 16), baseline minibatch 16. The port
gets the reference's weights (mjrl_tpu_torch.convert), its reset and
action noise, and its minibatch permutations, as tests/test_torch_npg.py
does for ant. Both sides narrow hopper's healthy angle to 0.05 rad so that
episodes terminate inside the window and the frozen-row, terminated and
bootstrap masks take part.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.algos import NPG as JNPG
from mjrl_tpu.envs.locomotion import HopperEnv as JHopperEnv
from mjrl_tpu.models import GaussianMLP as JGaussianMLP
from mjrl_tpu.models import MLPBaseline as JMLPBaseline
from mjrl_tpu.ops.ravel import ravel_pytree
from mjrl_tpu_torch.algos import NPG
from mjrl_tpu_torch.convert import baseline_from_jax, policy_flat_from_jax, policy_from_jax
from mjrl_tpu_torch.envs.locomotion import HopperEnv
from mjrl_tpu_torch.ops.ravel import ravel
from mjrl_tpu_torch.samplers import EpisodeNoise, run_episodes

torch.set_num_threads(1)

N, T, EPOCHS, MB, HIDDEN = 6, 24, 2, 16, (16, 16)
ANGLE = 0.05


class _JNarrowHopper(JHopperEnv):
    def _healthy(self, ps):
        return super()._healthy(ps) & (jnp.abs(ps.q[2]) < ANGLE)


class _NarrowHopper(HopperEnv):
    def _healthy(self, state):
        return super()._healthy(state) & (state.q[:, 2].abs() < ANGLE)


def _jax_noise(jenv, k_sample):
    """The reset and action noise the reference's sample_episodes draws
    from ``k_sample`` (hopper: uniform q and qd noise)."""
    key_reset, key_scan = jax.random.split(k_sample)
    s = jenv.reset_noise_scale
    q_noise, qd_noise = [], []
    for rk in jax.random.split(key_reset, N):
        kq, kv = jax.random.split(rk)
        q_noise.append(jax.random.uniform(kq, (jenv.model.nq,), minval=-s, maxval=s))
        qd_noise.append(jax.random.uniform(kv, (jenv.model.nv,), minval=-s, maxval=s))
    eps, key = [], key_scan
    for _ in range(T):
        key, k_act = jax.random.split(key)
        eps.append(jax.random.normal(k_act, (N, jenv.spec.action_dim)))
    t = lambda xs: torch.as_tensor(np.array(jnp.stack(xs)))  # noqa: E731
    return EpisodeNoise(reset_q=t(q_noise), reset_qd=t(qd_noise), action=t(eps))


@pytest.fixture(scope="module")
def ref():
    jenv = _JNarrowHopper(horizon=T)
    agent = JNPG(jenv, JGaussianMLP(jenv.spec, hidden_sizes=HIDDEN),
                 JMLPBaseline(jenv.spec, epochs=EPOCHS, batch_size=MB),
                 normalized_step_size=0.05, num_traj=N, horizon=T, gamma=0.995, gae_lambda=0.97)
    state0 = agent.init(jax.random.PRNGKey(0))
    k_sample, k_update, k_fit = jax.random.split(jax.random.PRNGKey(1), 3)
    batch = agent.sample_batch(state0, k_sample)
    state1, metrics = agent._finish_train_step(state0, batch, k_update, k_fit)
    m = N * T
    perms = [torch.as_tensor(np.array(jax.random.permutation(k, m)[: m // MB * MB]
                                      .reshape(-1, MB))) for k in jax.random.split(k_fit, EPOCHS)]
    to_np = lambda tree: jax.tree.map(np.array, tree)  # noqa: E731
    return dict(state0=to_np(state0), batch=to_np(batch), state1=to_np(state1),
                metrics={k: float(v) for k, v in metrics.items()},
                noise=_jax_noise(jenv, k_sample), perms=perms)


def _port_agent(ref):
    env = _NarrowHopper(horizon=T, device="cpu")
    state0 = ref["state0"]
    policy = policy_from_jax(state0.params, env.spec)
    baseline = baseline_from_jax(state0.baseline_state, env.spec, epochs=EPOCHS, batch_size=MB)
    return NPG(env, policy, baseline, normalized_step_size=0.05, num_traj=N, horizon=T,
               gamma=0.995, gae_lambda=0.97)


def test_hopper_train_step_matches_reference(ref):
    """The sampled batch (24 control steps of penalty physics, terminations
    included), then returns/GAE, the NPG step, the baseline fit and the
    statistics, against the reference's."""
    jb = ref["batch"]
    assert not jb.valid.all() and jb.terminated.any(), "window holds no termination"
    agent = _port_agent(ref)
    batch = run_episodes(agent.env, agent.policy, ref["noise"])
    for name in ("valid", "done", "terminated"):
        np.testing.assert_array_equal(getattr(batch, name).numpy(), getattr(jb, name),
                                      err_msg=name)
    # 24 control steps of two f32 engines through hopper's floor contacts
    for name, tol in (("observations", 1e-3), ("rewards", 1e-3), ("log_prob", 1e-3)):
        np.testing.assert_allclose(getattr(batch, name).numpy(), getattr(jb, name), rtol=tol,
                                   atol=tol, err_msg=name)
    got = {k: float(v) for k, v in agent.finish_train_step(batch, fit_perms=ref["perms"]).items()}
    want = ref["metrics"]
    assert set(got) == set(want) and got["num_samples"] == want["num_samples"]
    # the physics drift of the batch reaches every metric; alpha and the
    # step come out of 10 CG iterations of f32 Fisher products
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name], rtol=2e-3, atol=1e-5, err_msg=name)
    got_flat, _ = ravel({k: v.detach() for k, v in agent.policy.named_parameters()})
    want_flat = policy_flat_from_jax(np.asarray(ravel_pytree(ref["state1"].params)[0]),
                                     agent.policy)
    np.testing.assert_allclose(got_flat.numpy(), want_flat.numpy(), rtol=1e-3, atol=3e-4)
