"""The port's point_mass env, eval-mode sampler, ridge solve and
least-squares baselines (mjrl_tpu_torch.envs.point_mass, .samplers,
.ops.lstsq, .models.baselines) against the JAX package, and
``examples/point_mass_npg.json`` through the port's entry point.

The same inputs go through both: reset draws the reference makes from its
key are injected into the port, weights cross over with
mjrl_tpu_torch.convert, batches are sampled by the reference. Each
comparison states its tolerance.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.algos import NPG as JNPG
from mjrl_tpu.envs.point_mass import PointMassEnv as JPointMass
from mjrl_tpu.models import GaussianMLP as JGaussianMLP
from mjrl_tpu.models import LinearBaseline as JLinear
from mjrl_tpu.models import QuadraticBaseline as JQuadratic
from mjrl_tpu.models import ZeroBaseline as JZero
from mjrl_tpu.ops.lstsq import ridge_solve as j_ridge_solve
from mjrl_tpu.samplers.rollout import sample_episodes as j_sample_episodes
from mjrl_tpu_torch.convert import baseline_from_jax, policy_from_jax
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.envs.point_mass import PointMassState
from mjrl_tpu_torch.models import LinearBaseline, QuadraticBaseline, ZeroBaseline
from mjrl_tpu_torch.models.baselines import quadratic_features
from mjrl_tpu_torch.ops.lstsq import ridge_solve
from mjrl_tpu_torch.samplers import EpisodeNoise, run_episodes, sample_episodes
from mjrl_tpu_torch.train import load_config, run_job
from mjrl_tpu_torch.types import TrajectoryBatch
from mjrl_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, T = 6, 25
t = lambda x: torch.as_tensor(np.array(x))


def _to_torch(jb) -> TrajectoryBatch:
    return TrajectoryBatch(
        observations=t(jb.observations), actions=t(jb.actions), rewards=t(jb.rewards),
        valid=t(jb.valid), done=t(jb.done), terminated=t(jb.terminated), mean=t(jb.mean),
        log_std=t(jb.log_std), log_prob=t(jb.log_prob), time=t(jb.time), returns=t(jb.returns),
        baseline=t(jb.baseline), advantages=t(jb.advantages),
        env_info={k: t(v) for k, v in jb.env_info.items()})


def _reset_draws(jenv, key, n):
    """The reference's per-env reset of ``sample_episodes(key)``: (pos, target)."""
    key_reset, _ = jax.random.split(key)
    states, _ = jax.vmap(jenv.reset)(jax.random.split(key_reset, n))
    return t(states.pos), t(states.target)


def test_reset_and_step_match_reference():
    """Reset from the reference's draws, then 12 steps of random actions
    (half outside the +-1 clip, some driving the mass into the +-2 arena
    clip): obs, reward and success bit for bit up to f32 round-off
    (rtol 1e-6, atol 1e-6)."""
    jenv, env = JPointMass(), make("point_mass", device="cpu")
    assert env.spec == env.spec.__class__(6, 2, 25) and env.device.type == "cpu"
    keys = jax.random.split(jax.random.PRNGKey(0), 16)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    state, obs = env.reset_from_noise(t(jstate.pos), t(jstate.target))
    assert isinstance(state, PointMassState)
    np.testing.assert_array_equal(obs.numpy(), np.array(jobs))
    rng = np.random.default_rng(0)
    step = jax.jit(jax.vmap(jenv.step))
    success = 0.0
    for _ in range(12):
        a = (3.0 * rng.normal(size=(16, 2))).astype(np.float32)
        jstate, jobs, jrew, jterm, jinfo = step(jstate, jnp.asarray(a))
        state, obs, rew, term, info = env.step(state, torch.as_tensor(a))
        np.testing.assert_allclose(obs.numpy(), np.array(jobs), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(rew.numpy(), np.array(jrew), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(term.numpy(), np.array(jterm))
        np.testing.assert_array_equal(info["success"].numpy(), np.array(jinfo["success"]))
        success += float(info["success"].sum())
    assert np.abs(state.pos.numpy()).max() == 4.0  # the arena clip was hit
    # the reset noise's range
    pos, target = env.reset_noise(4096, torch.Generator().manual_seed(0))
    for x in (pos, target):
        assert x.shape == (4096, 2) and float(x.abs().max()) <= 2.0 and float(x.abs().max()) > 1.99


@pytest.fixture(scope="module")
def ref():
    """A point_mass NPG agent of the reference with a quadratic baseline, its
    initial state, a sampled and processed batch."""
    jenv = JPointMass()
    agent = JNPG(jenv, JGaussianMLP(jenv.spec, hidden_sizes=(8, 8)), JQuadratic(jenv.spec),
                 normalized_step_size=0.05, num_traj=N)
    state = agent.init(jax.random.PRNGKey(0))
    batch = agent.sample_batch(state, jax.random.PRNGKey(1))
    pbatch = agent.process_batch(state, batch)
    to_np = lambda tree: jax.tree.map(np.array, tree)
    return dict(jenv=jenv, agent=agent, state=state, pbatch=to_np(pbatch),
                params=to_np(state.params))


def test_eval_mode_sampler_matches_reference(ref):
    """``sample_episodes(eval_mode=True)``: the action is the policy mean and
    ``log_prob`` is taken there; with the reference's reset draws injected,
    every field matches its ``sample_episodes(eval_mode=True)`` to rtol 1e-5
    (atol 1e-5), and no action noise is drawn."""
    jenv, state = ref["jenv"], ref["state"]
    key = jax.random.PRNGKey(7)
    jb = j_sample_episodes(jenv, ref["agent"].policy, state.params, state.transforms, key, N,
                           T, eval_mode=True)
    env = make("point_mass", device="cpu")
    policy = policy_from_jax(ref["params"], env.spec)
    pos, target = _reset_draws(jenv, key, N)
    noise = EpisodeNoise(reset_q=pos, reset_qd=target, action=torch.empty(T, N, 0))
    got = run_episodes(env, policy, noise, eval_mode=True)
    np.testing.assert_array_equal(got.actions.numpy(), got.mean.numpy())
    for name in ("valid", "done", "terminated", "time"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.array(getattr(jb, name)))
    for name in ("observations", "actions", "rewards", "mean", "log_std", "log_prob"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.array(getattr(jb, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got.env_info["success"].numpy(),
                                  np.array(jb.env_info["success"]))
    # through sample_episodes: the generator gives the resets and nothing else
    gen = torch.Generator().manual_seed(3)
    a = sample_episodes(env, policy, N, T, gen, eval_mode=True)
    after = gen.get_state()
    gen2 = torch.Generator().manual_seed(3)
    env.reset_noise(N, gen2)
    assert torch.equal(after, gen2.get_state())
    np.testing.assert_array_equal(a.actions.numpy(), a.mean.numpy())


def test_ridge_solve_matches_reference():
    """A well-posed solve and one with a 0/1 mask, against the reference's
    ridge_solve (rtol 1e-5, atol 1e-6) and numpy's f64 solve (rtol 1e-3)."""
    rng = np.random.default_rng(3)
    m, k = 200, 7
    f = rng.normal(size=(m, k)).astype(np.float32)
    y = rng.normal(size=m).astype(np.float32)
    for w, reg in ((np.ones(m, np.float32), 1e-3),
                   ((rng.uniform(size=m) < 0.6).astype(np.float32), 1e-4)):
        got = ridge_solve(t(f), t(y), t(w), reg).numpy()
        want = np.array(j_ridge_solve(jnp.asarray(f), jnp.asarray(y), jnp.asarray(w), reg))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        fw, yw = f[w > 0].astype(np.float64), y[w > 0].astype(np.float64)
        np.testing.assert_allclose(got, np.linalg.solve(fw.T @ fw + reg * np.eye(k), fw.T @ yw),
                                   rtol=1e-3, atol=1e-3)


def test_ridge_solve_retries_a_rank_deficient_gram():
    """Two equal columns of 64s: the f32 Gram is exactly singular and
    ``g + reg == g`` until reg reaches 0.1, so the Cholesky factor fails at
    reg 1e-5, 1e-4, 1e-3 and 1e-2 (exactly 4 retries needed). Both packages
    return NaN with 3 retries allowed and a finite solution with 4 and with
    the default 10; the split between the equal columns is round-off, so
    the predictions ``F w`` are compared: to each other (rtol 1e-5) and to
    numpy's f64 ridge solve at reg 0.1 (rtol 1e-4)."""
    rng = np.random.default_rng(0)
    m = 64
    z = rng.normal(size=m).astype(np.float32)
    f = np.stack([np.full(m, 64.0, np.float32), np.full(m, 64.0, np.float32), z], axis=1)
    y = (3.0 + rng.normal(size=m) + 2.0 * z).astype(np.float32)
    w = np.ones(m, np.float32)
    f64 = f.astype(np.float64)
    ridge = f64 @ np.linalg.lstsq(f64.T @ f64 + 0.1 * np.eye(3), f64.T @ y, rcond=None)[0]
    for retries, finite in ((3, False), (4, True), (10, True)):
        got = ridge_solve(t(f), t(y), t(w), max_retries=retries).numpy()
        want = np.array(j_ridge_solve(jnp.asarray(f), jnp.asarray(y), jnp.asarray(w),
                                      max_retries=retries))
        assert np.isfinite(got).all() == np.isfinite(want).all() == finite, retries
        if finite:
            np.testing.assert_allclose(f @ got, f @ want, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(f @ got, ridge, rtol=1e-4, atol=1e-4)


def test_quadratic_features_match_reference():
    """The upper-triangle products in ``triu_indices`` order (exact)."""
    from mjrl_tpu.models.baselines import _quadratic_features

    rng = np.random.default_rng(1)
    obs = (20.0 * rng.normal(size=(3, 5, 6))).astype(np.float32)  # some beyond the +-10 clip
    time = rng.integers(0, 1000, size=(3, 5)).astype(np.int32)
    want = _quadratic_features(jnp.asarray(obs), jnp.asarray(time))
    np.testing.assert_array_equal(quadratic_features(t(obs), t(time)).numpy(), np.array(want))


@pytest.mark.parametrize("name", ["zero", "linear", "quadratic"])
def test_least_squares_baselines_match_reference(ref, name):
    """Zero, Linear and Quadratic: fit on the reference's processed point_mass
    batch (its ``returns``) and predict, twice in a row (the second fit's
    ``VF_error_before`` reads the first fit's coefficients): errors rtol
    1e-4 (atol 1e-6), predictions rtol 1e-3 (atol 1e-3). The time columns
    ``al, al^2, al^3, 1`` (``al <= 0.024``) are nearly collinear, and the
    quadratic baseline's 37 features on 150 steps more so: f32 round-off of
    the Gram moves the coefficients along those directions (by up to 4e-4
    relative for the linear one, held at rtol 1e-3; by O(1) for the
    quadratic one, not held) while the predictions move by ~2e-4."""
    jcls, cls = {"zero": (JZero, ZeroBaseline), "linear": (JLinear, LinearBaseline),
                 "quadratic": (JQuadratic, QuadraticBaseline)}[name]
    spec = ref["jenv"].spec
    jbl = jcls(spec)
    jstate = jbl.init(jax.random.PRNGKey(0))
    bl = baseline_from_jax(jax.tree.map(np.array, jstate), make("point_mass", device="cpu").spec)
    assert isinstance(bl, cls) and not hasattr(bl, "optimizer")
    pb = ref["pbatch"]
    batch = _to_torch(pb)
    for _ in range(2):
        jstate, jm = jbl.fit(jstate, pb, jax.random.PRNGKey(1))
        m = bl.fit(batch)
        for k in ("VF_error_before", "VF_error_after"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
        if name == "linear":
            np.testing.assert_allclose(bl.coef.numpy(), np.array(jstate["coef"]), rtol=1e-3,
                                       atol=1e-3)
        np.testing.assert_allclose(bl.predict(batch.observations, batch.time).numpy(),
                                   np.array(jbl.predict(jstate, pb.observations, pb.time)),
                                   rtol=1e-3, atol=1e-3)
    if name != "zero":
        assert float(m["VF_error_after"]) < 0.5


def test_point_mass_config_runs_evaluates_and_resumes(tmp_path):
    """``examples/point_mass_npg.json`` (its quadratic baseline and 16
    evaluation rollouts) at 2 envs x 25 steps through ``run_job``: two
    iterations, then a third resumed from the checkpoint; ``eval_score`` is
    logged and finite, the best state is the one of the best
    ``eval_score``, and a straight three-iteration run ends with the same
    policy (exact)."""
    path = os.path.join(ROOT, "examples", "point_mass_npg.json")
    small = ["num_traj=2", "save_freq=1"]
    run_job(load_config(path, [*small, "niter=2"]), str(tmp_path / "a"), device="cpu")
    agent = run_job(load_config(path, [*small, "niter=3"]), str(tmp_path / "a"), device="cpu")
    straight = run_job(load_config(path, [*small, "niter=3"]), str(tmp_path / "b"), device="cpu")
    assert agent.iteration == 3 and isinstance(agent.baseline, QuadraticBaseline)
    for (k, a), (_, b) in zip(agent.policy.state_dict().items(),
                              straight.policy.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    torch.testing.assert_close(agent.baseline.coef, straight.baseline.coef, rtol=0, atol=0)
    import csv

    with open(tmp_path / "a" / "logs" / "log.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 3
    scores = [float(r["eval_score"]) for r in rows]
    assert all(math.isfinite(float(v)) for r in rows for v in r.values())
    assert all(-200.0 < s < 0.0 for s in scores)
    best = CheckpointManager(str(tmp_path / "b")).restore_best()
    assert best["baseline_optimizer"] is None
    with open(tmp_path / "b" / "logs" / "log.csv", newline="") as f:
        b_scores = [float(r["eval_score"]) for r in csv.DictReader(f)]
    assert best["iteration"] == int(np.argmax(b_scores)) + 1
