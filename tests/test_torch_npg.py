"""Parity of the port's sampler, NPG update, baseline fit and train step
(mjrl_tpu_torch.samplers / .algos / .models.baselines) with the JAX package.

One tiny ant run (N=4 envs, T=4 steps, policy hidden (8, 8), MLPBaseline
epochs=2 batch_size=4) goes through the JAX agent's ``sample_batch`` and
``_finish_train_step`` (= its ``train_step``). The port gets the same
weights (mjrl_tpu_torch.convert), the reference-drawn reset and action
noise, and the reference's minibatch permutations. Both sides use a healthy
z range narrowed to (0.70, 0.84) so some episodes terminate inside the
window and the frozen-row and terminated masks are exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.algos import NPG as JNPG
from mjrl_tpu.envs.locomotion import AntEnv as JAntEnv
from mjrl_tpu.models import GaussianMLP as JGaussianMLP
from mjrl_tpu.models import MLPBaseline as JMLPBaseline
from mjrl_tpu.ops.ravel import ravel_pytree
from mjrl_tpu_torch.algos import NPG
from mjrl_tpu_torch.convert import baseline_from_jax, policy_flat_from_jax, policy_from_jax
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.ops.ravel import ravel
from mjrl_tpu_torch.samplers import EpisodeNoise, run_episodes
from mjrl_tpu_torch.types import TrajectoryBatch

torch.set_num_threads(1)

N, T, EPOCHS, MB = 4, 4, 2, 4
Z_RANGE = (0.70, 0.84)


class _NarrowAnt(JAntEnv):
    def _healthy(self, ps):
        z = ps.q[2]
        finite = jnp.all(jnp.isfinite(ps.q)) & jnp.all(jnp.isfinite(ps.qd))
        return finite & (z > Z_RANGE[0]) & (z < Z_RANGE[1])


def _jax_noise(jenv, k_sample):
    """The reset and action noise the reference's sample_episodes draws
    from ``k_sample``."""
    key_reset, key_scan = jax.random.split(k_sample)
    s = jenv.reset_noise_scale
    q_noise, qd_noise = [], []
    for rk in jax.random.split(key_reset, N):
        kq, kv = jax.random.split(rk)
        q_noise.append(jax.random.uniform(kq, (jenv.model.nq,), minval=-s, maxval=s))
        qd_noise.append(s * jax.random.normal(kv, (jenv.model.nv,)))
    eps, key = [], key_scan
    for _ in range(T):
        key, k_act = jax.random.split(key)
        eps.append(jax.random.normal(k_act, (N, jenv.spec.action_dim)))
    t = lambda xs: torch.as_tensor(np.array(jnp.stack(xs)))
    return EpisodeNoise(reset_q=t(q_noise), reset_qd=t(qd_noise), action=t(eps))


def _jax_perms(k_fit):
    m = N * T
    return [torch.as_tensor(np.array(jax.random.permutation(k, m)[: m // MB * MB].reshape(-1, MB)))
            for k in jax.random.split(k_fit, EPOCHS)]


@pytest.fixture(scope="module")
def ref():
    jenv = _NarrowAnt(horizon=T)
    agent = JNPG(jenv, JGaussianMLP(jenv.spec, hidden_sizes=(8, 8)),
                 JMLPBaseline(jenv.spec, epochs=EPOCHS, batch_size=MB),
                 normalized_step_size=0.05, num_traj=N, horizon=T)
    state0 = agent.init(jax.random.PRNGKey(0))
    k_sample, k_update, k_fit = jax.random.split(jax.random.PRNGKey(1), 3)
    batch = agent.sample_batch(state0, k_sample)
    state1, metrics = agent._finish_train_step(state0, batch, k_update, k_fit)
    to_np = lambda tree: jax.tree.map(np.array, tree)
    return dict(
        jenv=jenv, state0=to_np(state0), batch=to_np(batch),
        pbatch=to_np(agent.process_batch(state0, batch)), state1=to_np(state1),
        metrics={k: float(v) for k, v in metrics.items()},
        noise=_jax_noise(jenv, k_sample), perms=_jax_perms(k_fit),
    )


def _port_agent(ref):
    env = make("ant", horizon=T, device="cpu")
    env.healthy_z_range = Z_RANGE
    state0 = ref["state0"]
    policy = policy_from_jax(state0.params, env.spec)
    baseline = baseline_from_jax(state0.baseline_state, env.spec, epochs=EPOCHS, batch_size=MB)
    return NPG(env, policy, baseline, normalized_step_size=0.05, num_traj=N, horizon=T)


def _to_torch(jb) -> TrajectoryBatch:
    t = lambda x: torch.as_tensor(np.array(x))
    return TrajectoryBatch(
        observations=t(jb.observations), actions=t(jb.actions), rewards=t(jb.rewards),
        valid=t(jb.valid), done=t(jb.done), terminated=t(jb.terminated), mean=t(jb.mean),
        log_std=t(jb.log_std), log_prob=t(jb.log_prob), time=t(jb.time), returns=t(jb.returns),
        baseline=t(jb.baseline), advantages=t(jb.advantages),
        env_info={k: t(v) for k, v in jb.env_info.items()})


def test_sampler_matches_reference(ref):
    jb = ref["batch"]
    assert not jb.valid.all() and jb.terminated.any(), "window holds no termination"
    agent = _port_agent(ref)
    got = run_episodes(agent.env, agent.policy, ref["noise"])
    for name in ("valid", "done", "terminated", "time"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(jb, name), err_msg=name)
    # four control steps of physics drift between the two f32 engines
    for name, tol in (("observations", 1e-3), ("actions", 1e-4), ("mean", 1e-4),
                      ("log_std", 0.0), ("log_prob", 1e-3), ("rewards", 2e-3)):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(jb, name), rtol=tol, atol=tol,
                                   err_msg=name)
    np.testing.assert_allclose(got.env_info["x_velocity"].numpy(), jb.env_info["x_velocity"],
                               rtol=2e-3, atol=2e-3)
    # frozen rows: from the step after the terminal one, the observation
    # (the terminal state's) repeats
    obs, valid = got.observations.numpy(), got.valid.numpy()
    frozen = ~valid[:, 1:] & ~valid[:, :-1]
    assert frozen.any()
    for n, t in zip(*np.nonzero(frozen)):
        np.testing.assert_array_equal(obs[n, t + 1], obs[n, t])


def test_update_and_fit_match_reference(ref):
    """process_batch + NPG update + MLPBaseline.fit on the reference's batch."""
    agent = _port_agent(ref)
    pb = agent.process_batch(_to_torch(ref["batch"]))
    want = ref["pbatch"]
    for name in ("returns", "baseline", "advantages"):
        np.testing.assert_allclose(getattr(pb, name).numpy(), getattr(want, name),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    metrics = {**agent.update(pb), **agent.baseline.fit(pb, perms=ref["perms"])}
    wm = ref["metrics"]
    # alpha and the step come out of 10 CG iterations of f32 Fisher products
    for name, rtol, atol in (("alpha", 1e-3, 0.0), ("kl_dist", 1e-3, 1e-7),
                             ("surr_improvement", 1e-3, 1e-6), ("VF_error_before", 1e-5, 0.0),
                             ("VF_error_after", 1e-4, 0.0)):
        np.testing.assert_allclose(float(metrics[name]), wm[name], rtol=rtol, atol=atol, err_msg=name)
    got_flat, _ = ravel({k: v.detach() for k, v in agent.policy.named_parameters()})
    want_flat = policy_flat_from_jax(np.asarray(ravel_pytree(ref["state1"].params)[0]), agent.policy)
    # CG carries f32 round-off of its Fisher products (which agree to 1e-7)
    # furthest along the stiff log_std directions of the step
    np.testing.assert_allclose(got_flat.numpy(), want_flat.numpy(), rtol=1e-3, atol=3e-4)
    # 8 Adam steps; each moves a weight by about lr = 1e-3
    for lin, layer in zip(agent.baseline.mlp.layers, ref["state1"].baseline_state["mlp"]):
        np.testing.assert_allclose(lin.weight.detach().numpy(), layer["w"].T, rtol=0, atol=1e-5)
        np.testing.assert_allclose(lin.bias.detach().numpy(), layer["b"], rtol=0, atol=1e-5)


def test_train_step_matches_reference(ref):
    """The slice as a whole: sampler -> returns/GAE -> NPG -> fit -> stats."""
    agent = _port_agent(ref)
    batch = run_episodes(agent.env, agent.policy, ref["noise"])
    got = {k: float(v) for k, v in agent.finish_train_step(batch, fit_perms=ref["perms"]).items()}
    want = ref["metrics"]
    assert set(got) == set(want)
    assert got["num_samples"] == want["num_samples"] and agent.iteration == 1
    # the sampled batch carries the physics drift into every metric
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-3, atol=1e-5, err_msg=name)


def test_train_step_runs_from_a_generator(ref):
    agent = _port_agent(ref)
    gen = torch.Generator().manual_seed(0)
    for it in range(2):
        metrics = agent.train_step(gen)
        assert all(np.isfinite(float(v)) for v in metrics.values())
    assert agent.iteration == 2 and float(metrics["running_score"]) != 0.0
