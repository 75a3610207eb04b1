"""The breadth items without a kernel against the JAX package: the classic
envs (mjrl_tpu_torch.envs.classic), ``GaussianLinear``, the ``reinforce``
agent (``BatchREINFORCE.update``), NPG's ``hvp_sample_frac``,
``ops.gae.discount_sum`` and ``utils.plots.make_train_plots``.

- pendulum and cartpole: reset from the reference's draws, then 20 steps
  of random actions (cartpole's poles fall, so ``terminated`` fires), to
  atol 1e-5, the booleans exactly;
- ``GaussianLinear``'s mean and log-prob from the reference's weights, to
  atol 1e-6;
- the vanilla PG step and its metrics on the reference's processed
  point_mass batch, to atol 1e-6 (rtol 1e-5);
- the Fisher-vector product with the reference's Bernoulli mask injected,
  to atol 1e-5, and NPG's whole update with it (linear policy) to atol
  1e-5;
- ``discount_sum`` to rtol 1e-6;
- ``make_train_plots`` writes its PNG;
- the three settings through ``run_job`` on the CPU, one iteration each:
  point_mass with the linear policy and REINFORCE, cartpole NPG with
  ``hvp_sample_frac=0.5``, pendulum NPG.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.algos import NPG as JNPG
from mjrl_tpu.algos import BatchREINFORCE as JREINFORCE
from mjrl_tpu.envs.classic import CartpoleEnv as JCartpole
from mjrl_tpu.envs.classic import PendulumEnv as JPendulum
from mjrl_tpu.envs.point_mass import PointMassEnv as JPointMass
from mjrl_tpu.models import GaussianLinear as JGaussianLinear
from mjrl_tpu.models import GaussianMLP as JGaussianMLP
from mjrl_tpu.models import QuadraticBaseline as JQuadratic
from mjrl_tpu.ops.gae import discount_sum as j_discount_sum
from mjrl_tpu.ops.ravel import ravel_pytree
from mjrl_tpu_torch.algos import NPG, BatchREINFORCE
from mjrl_tpu_torch.convert import baseline_from_jax, policy_flat_from_jax, policy_from_jax
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.envs.classic import CartpoleState, PendulumState
from mjrl_tpu_torch.models import GaussianLinear
from mjrl_tpu_torch.ops import discount_sum
from mjrl_tpu_torch.ops.ravel import ravel
from mjrl_tpu_torch.train import load_config, run_job
from mjrl_tpu_torch.types import TrajectoryBatch
from mjrl_tpu_torch.utils.logger import DataLog
from mjrl_tpu_torch.utils.plots import make_train_plots

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, STEPS, N = 24, 20, 6
to_np = lambda tree: jax.tree.map(np.array, tree)
t = lambda x: torch.as_tensor(np.array(x))


def _to_torch(jb) -> TrajectoryBatch:
    return TrajectoryBatch(
        observations=t(jb.observations), actions=t(jb.actions), rewards=t(jb.rewards),
        valid=t(jb.valid), done=t(jb.done), terminated=t(jb.terminated), mean=t(jb.mean),
        log_std=t(jb.log_std), log_prob=t(jb.log_prob), time=t(jb.time), returns=t(jb.returns),
        baseline=t(jb.baseline), advantages=t(jb.advantages),
        env_info={k: t(v) for k, v in jb.env_info.items()})


@pytest.mark.parametrize("name", ["pendulum", "cartpole"])
def test_classic_env_matches_reference(name):
    jenv = JPendulum() if name == "pendulum" else JCartpole()
    env = make(name, device="cpu")
    assert (env.spec.observation_dim, env.spec.action_dim, env.spec.horizon) == \
        (jenv.spec.observation_dim, jenv.spec.action_dim, jenv.spec.horizon)
    jstate, jobs = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), B))
    if name == "pendulum":
        state, obs = env.reset_from_noise(t(jstate.theta), t(jstate.theta_dot))
        assert isinstance(state, PendulumState)
    else:
        state, obs = env.reset_from_noise(t(jnp.stack(list(jstate), -1)), torch.zeros(B, 0))
        assert isinstance(state, CartpoleState)
    np.testing.assert_allclose(obs.numpy(), np.array(jobs), rtol=0, atol=1e-6)
    step = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(3)
    terminated = np.zeros(B, bool)
    for _ in range(STEPS):
        a = rng.normal(scale=2.0, size=(B, 1)).astype(np.float32)
        jstate, jobs, jrew, jterm, jinfo = step(jstate, jnp.asarray(a))
        state, obs, rew, term, info = env.step(state, torch.as_tensor(a))
        np.testing.assert_allclose(obs.numpy(), np.array(jobs), rtol=0, atol=1e-5)
        np.testing.assert_allclose(rew.numpy(), np.array(jrew), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(term.numpy(), np.array(jterm))
        np.testing.assert_array_equal(info["success"].numpy(), np.array(jinfo["success"]))
        terminated |= term.numpy()
    if name == "cartpole":
        assert 0 < terminated.sum() < B
    # the port's own reset draws lie in the reference's ranges
    a, b = env.reset_noise(4096, torch.Generator().manual_seed(0))
    if name == "pendulum":
        assert float(a.abs().max()) <= math.pi and float(b.abs().max()) <= 1.0 and a.shape == (4096,)
    else:
        assert float(a.abs().max()) <= 0.05 and a.shape == (4096, 4) and b.shape == (4096, 0)


def test_cartpole_termination_drives_the_masks():
    """Episodes sampled on cartpole end where the pole falls: ``done`` and
    ``terminated`` at that step, ``valid`` false after it."""
    from mjrl_tpu_torch.models import GaussianMLP
    from mjrl_tpu_torch.samplers import sample_episodes

    env = make("cartpole", horizon=60, device="cpu")
    policy = GaussianMLP(env.spec, hidden_sizes=(4,), init_log_std=1.0,
                         generator=torch.Generator().manual_seed(0))
    b = sample_episodes(env, policy, 16, 60, torch.Generator().manual_seed(1))
    ended = b.terminated.any(dim=1)
    assert 0 < int(ended.sum()) and bool((b.terminated == (b.done & b.terminated)).all())
    for n in torch.nonzero(ended)[:, 0].tolist():
        t_end = int(torch.nonzero(b.terminated[n])[0])
        assert b.valid[n, : t_end + 1].all() and not b.valid[n, t_end + 1:].any()
        assert bool(b.done[n, t_end])


def test_gaussian_linear_matches_reference():
    jenv = JPointMass()
    jpol = JGaussianLinear(jenv.spec, init_log_std=-0.5)
    params = jpol.init(jax.random.PRNGKey(4))
    params = {**params, "log_std": params["log_std"] + jnp.asarray([0.1, -0.2])}
    policy = policy_from_jax(to_np(params), jenv.spec)
    assert isinstance(policy, GaussianLinear) and len(policy.mlp.layers) == 1
    assert GaussianLinear(jenv.spec).mlp.layers[0].weight.shape == (2, 6)
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(50, 6)).astype(np.float32)
    act = rng.normal(size=(50, 2)).astype(np.float32)
    jmean, _ = jpol.apply(params, jpol.init_transforms(), obs)
    jlp = jpol.log_prob(params, jpol.init_transforms(), obs, act)
    from mjrl_tpu_torch.ops.distributions import DiagGaussian

    with torch.no_grad():
        mean, log_std = policy(torch.as_tensor(obs))
        lp = DiagGaussian.log_prob(torch.as_tensor(act), mean, log_std)
    np.testing.assert_allclose(mean.numpy(), np.array(jmean), rtol=0, atol=1e-6)
    np.testing.assert_allclose(lp.numpy(), np.array(jlp), rtol=0, atol=1e-6)


def _ref_batch(jagent, key=1):
    state = jagent.init(jax.random.PRNGKey(0))
    batch = jagent.sample_batch(state, jax.random.PRNGKey(key))
    return state, jagent.process_batch(state, batch)


def test_reinforce_update_matches_reference():
    """``params += learn_rate * vpg`` then ``project`` (the log_std floor
    raised to clip one entry), with the reference's metrics."""
    jenv = JPointMass()
    jagent = JREINFORCE(jenv, JGaussianMLP(jenv.spec, hidden_sizes=(8, 8)), JQuadratic(jenv.spec),
                        num_traj=N, learn_rate=0.05)
    state, pbatch = _ref_batch(jagent)
    state1, jm = jagent.update(state, pbatch, jax.random.PRNGKey(2))
    env = make("point_mass", device="cpu")
    policy = policy_from_jax(to_np(state.params), env.spec)
    agent = BatchREINFORCE(env, policy, baseline_from_jax(to_np(state.baseline_state), env.spec),
                           num_traj=N, learn_rate=0.05)
    assert BatchREINFORCE(env, policy, agent.baseline).learn_rate == 0.01  # the reference's default
    m = agent.update(_to_torch(pbatch))
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    want = policy_from_jax(to_np(state1.params), env.spec).state_dict()
    for k, v in policy.state_dict().items():
        np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
    # project: a floor above the current log_std clamps it
    policy.min_log_std = 0.5
    agent.update(_to_torch(pbatch))
    assert float(policy.log_std.min()) == 0.5


@pytest.mark.parametrize("hidden", [(8, 8), ()], ids=["mlp", "linear"])
def test_hvp_sample_frac_fvp_and_update_match_reference(hidden):
    """``hvp_sample_frac=0.5``: the reference's Bernoulli mask of the
    update's key, injected, weights the KL inside the FVP; the product of
    a random vector to atol 1e-5; with the linear policy (whose Fisher is
    well conditioned) the whole NPG update to atol 1e-5. Without an
    injected mask the port draws one from the generator, of the rewards'
    shape and mean near 0.5; at ``hvp_sample_frac=1`` nothing is drawn."""
    jenv = JPointMass()
    jpol = JGaussianMLP(jenv.spec, hidden_sizes=hidden) if hidden else JGaussianLinear(jenv.spec)
    jagent = JNPG(jenv, jpol, JQuadratic(jenv.spec), num_traj=N, hvp_sample_frac=0.5,
                  normalized_step_size=0.05)
    state, pbatch = _ref_batch(jagent)
    key = jax.random.PRNGKey(9)
    mask = jax.random.bernoulli(key, 0.5, pbatch.rewards.shape).astype(pbatch.rewards.dtype)
    fvp, flat, _ = jagent.build_fvp(state, pbatch, key)
    v = jnp.asarray(np.random.default_rng(0).normal(size=flat.shape).astype(np.float32))
    want = np.array(fvp(v))
    env = make("point_mass", device="cpu")
    policy = policy_from_jax(to_np(state.params), env.spec)
    agent = NPG(env, policy, baseline_from_jax(to_np(state.baseline_state), env.spec),
                num_traj=N, hvp_sample_frac=0.5, normalized_step_size=0.05)
    batch = _to_torch(pbatch)
    port_fvp, port_flat, _ = agent.build_fvp(agent.params(), batch, t(mask))
    got = port_fvp(policy_flat_from_jax(np.array(v), policy))
    np.testing.assert_allclose(got.numpy(), policy_flat_from_jax(want, policy).numpy(), rtol=0,
                               atol=1e-5)
    # the mask is not a no-op: the unmasked product differs
    unmasked, _, _ = agent.build_fvp(agent.params(), batch)
    assert not torch.allclose(unmasked(policy_flat_from_jax(np.array(v), policy)), got, atol=1e-4)
    drawn = agent.hvp_mask(batch, torch.Generator().manual_seed(0))
    assert drawn.shape == batch.rewards.shape and 0.4 < float(drawn.mean()) < 0.6
    agent.hvp_sample_frac = 1.0
    gen = torch.Generator().manual_seed(0)
    assert agent.hvp_mask(batch, gen) is None and torch.equal(gen.get_state(),
                                                              torch.Generator().manual_seed(0).get_state())
    agent.hvp_sample_frac = 0.5
    if hidden:
        return
    state1, jm = jagent.update(state, pbatch, key)
    m = agent.update(batch, hvp_mask=t(mask))
    for k in ("alpha", "kl_dist", "surr_improvement"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    want_flat, _ = ravel_pytree(to_np(state1.params))
    got_flat, _ = ravel(agent.params())
    np.testing.assert_allclose(got_flat.numpy(), policy_flat_from_jax(np.array(want_flat),
                                                                       policy).numpy(),
                               rtol=0, atol=1e-5)


def test_discount_sum_matches_reference():
    x = np.random.default_rng(0).normal(size=37).astype(np.float32)
    for gamma, terminal in ((0.99, 0.0), (0.9, 2.5), (1.0, -1.0)):
        want = np.array(j_discount_sum(jnp.asarray(x), gamma, terminal))
        got = discount_sum(torch.as_tensor(x), gamma, terminal)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # leading dims are a batch
    xs = torch.as_tensor(np.stack([x, 2 * x]))
    torch.testing.assert_close(discount_sum(xs, 0.9)[1], discount_sum(2 * torch.as_tensor(x), 0.9))


def test_make_train_plots_writes_its_png(tmp_path):
    log = DataLog(str(tmp_path / "logs"))
    for i in range(5):
        log.log_dict({"stoc_pol_mean": -10.0 + i, "running_score": -10.0 + 0.5 * i,
                      "dyn_error": 1.0 / (i + 1)})
    log.save_log()
    log.close()
    make_train_plots(log=log, keys=("stoc_pol_mean", "running_score", "dyn_error"),
                     save_loc=str(tmp_path / "a"))
    png = tmp_path / "a" / "train_curves.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and png.stat().st_size > 1000
    make_train_plots(log_path=str(tmp_path / "logs" / "log.csv"), save_loc=str(tmp_path / "b"))
    assert (tmp_path / "b" / "train_curves.png").exists()
    make_train_plots(log=log, keys=("absent",), save_loc=str(tmp_path / "c"))
    assert not (tmp_path / "c").exists()


@pytest.mark.parametrize("name,overrides,agent_type,policy_type", [
    ("point_mass_npg.json", ["policy=\"linear\"", "algorithm=\"reinforce\"", "agent_kwargs={}"],
     "BatchREINFORCE", "GaussianLinear"),
    ("point_mass_npg.json", ["env_name=\"cartpole\"", "agent_kwargs.hvp_sample_frac=0.5",
                             "horizon=30"], "NPG", "GaussianMLP"),
    ("point_mass_npg.json", ["env_name=\"pendulum\"", "horizon=30"], "NPG", "GaussianMLP"),
], ids=["linear_reinforce", "cartpole_hvp", "pendulum"])
def test_breadth_settings_run_through_the_entry_point(tmp_path, name, overrides, agent_type,
                                                      policy_type):
    cfg = load_config(os.path.join(ROOT, "examples", name),
                      [*overrides, "num_traj=8", "niter=1", "evaluation_rollouts=0"])
    agent = run_job(cfg, str(tmp_path), device="cpu")
    assert type(agent).__name__ == agent_type and type(agent.policy).__name__ == policy_type
    assert agent.iteration == 1
    with open(tmp_path / "logs" / "log.csv") as f:
        header, row = [line.strip().split(",") for line in f]
    values = dict(zip(header, row))
    assert all(math.isfinite(float(v)) for v in values.values())
    if "hvp_sample_frac" in overrides[1]:
        assert agent.hvp_sample_frac == 0.5
