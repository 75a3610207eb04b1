"""Env-axis data parallelism of the port (``mjrl_tpu_torch/parallel/dist.py``)
on the CPU: two ranks over gloo against one rank and against the JAX
package's sharded agents on ``make_mesh(2)``.

One spawn of two ranks (``dist.spawn``, one torch thread each) runs every
case of :func:`run_cases` and saves what the checks read; the same function
runs once in this process, with no group, as the single-rank run. Rank r's
rows are the block ``dist.row_block`` gives it.

- point_mass NPG, linear policy, quadratic baseline (8 envs): each rank's
  sampled rows equal the single-rank rows bit for bit; the parameters after
  the step are the same bits on both ranks and within 1e-6 of the
  single-rank step and of the JAX package's sharded NPG update
  (``make_mesh(2)``) on the same batch; the logged metrics agree;
- the same with a (16, 16) MLP policy, where NPG's ten CG iterations grow
  the sums' new order: 1e-4 (measured 4.3e-5);
- TRPO's three line-search cases (linear policy, two batches): the same
  probes and decision as one rank, the parameters within 1e-6;
- DAPG (linear policy) with a planted large advantage in rank 1's rows:
  ``demo_adv`` is the global max and the demo term counts once, so the
  gradient (1e-5) and the step (1e-6) are the single-rank ones;
- PPO's sharded path against ``mjrl_tpu``'s ``_minibatch_adam_sharded``
  (through ``PPO.update`` on ``make_mesh(2)``), each rank given the
  reference's per-shard ``permutation(fold_in(ekey, shard), m_loc)`` as
  ``perms``, with humanoid_ppo_v4.json's flags and without; PPO refuses a
  ``num_traj`` that the ranks do not divide;
- the zero, linear, quadratic and MLP baselines' fits (the MLP one with
  ``vf_clip_coef`` and ``reg_coef``, from the same global permutations);
- samples mode: three windows of NPG with the carry, the first window's rows
  bit for bit and the gathered carry of the checkpoint state within 1e-4
  of one rank's (the steps' round-off carried through two windows); the twin of ``tests/test_sharding.py``'s PPO carry test (every
  row 5 steps into its second episode after 3 windows of 10 at horizon 25).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.algos import NPG as JNPG
from mjrl_tpu.algos import PPO as JPPO
from mjrl_tpu.envs.point_mass import PointMassEnv as JPointMass
from mjrl_tpu.models import GaussianLinear as JGaussianLinear
from mjrl_tpu.models import GaussianMLP as JGaussianMLP
from mjrl_tpu.models import MLPBaseline as JMLPBaseline
from mjrl_tpu.models import QuadraticBaseline as JQuadratic
from mjrl_tpu.ops.ravel import ravel_pytree
from mjrl_tpu.parallel import make_mesh, shard_env_pytree
from mjrl_tpu.types import TrajectoryBatch as JTrajectoryBatch
from mjrl_tpu_torch.algos import DAPG, NPG, PPO, TRPO
from mjrl_tpu_torch.convert import policy_flat_from_jax, policy_from_jax
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.models import (
    GaussianLinear,
    GaussianMLP,
    LinearBaseline,
    MLPBaseline,
    QuadraticBaseline,
    ZeroBaseline,
)
from mjrl_tpu_torch.ops.ravel import ravel
from mjrl_tpu_torch.parallel import dist
from mjrl_tpu_torch.samplers import sample_episodes
from mjrl_tpu_torch.types import TrajectoryBatch

torch.set_num_threads(1)

WORLD, N, T = 2, 8, 10
BATCH_FIELDS = ("observations", "actions", "rewards", "valid", "done", "terminated", "mean",
                "log_std", "log_prob", "time")
# TRPO's line-search cases: (the batch's seed, kl_dist, probes)
TRPO_CASES = {"accepted": (1, 1e-2, 1.0), "backtracked": (0, 1e-2, 2.0),
              "rejected": (0, 1e-30, 10.0)}
PPO_FLAGS = {"v4": dict(entropy_coef=0.01, lr_anneal_iters=8, norm_adv_per_minibatch=True),
             "plain": dict()}
PPO_EPOCHS, PPO_MB, PPO_ITERATION = 2, 16, 3
HIDDEN = {"linear": (), "mlp": (16, 16)}


def _flat(policy) -> torch.Tensor:
    return ravel({k: v.detach() for k, v in policy.named_parameters()})[0]


def _random_batch(seed, policy, n=N, horizon=T):
    """A processed batch of ``policy`` on random point_mass-sized
    observations, two rows ending early (numpy dict)."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, horizon, 6)).astype(np.float32)
    with torch.no_grad():
        mean, log_std = policy(torch.as_tensor(obs))
    mean = mean.numpy()
    log_std = np.broadcast_to(log_std.detach().numpy(), mean.shape).astype(np.float32)
    actions = (mean + np.exp(log_std) * rng.normal(size=mean.shape)).astype(np.float32)
    valid = np.ones((n, horizon), bool)
    valid[1, 6:] = valid[n - 2, 3:] = False
    adv = (rng.normal(size=(n, horizon)) * valid).astype(np.float32)
    returns = (rng.normal(size=(n, horizon)) * 5.0 + 3.0).astype(np.float32)
    zero = np.zeros((n, horizon), np.float32)
    time = np.tile(np.arange(horizon, dtype=np.int32), (n, 1))
    return dict(observations=obs, actions=actions, rewards=zero, valid=valid,
                done=zero.astype(bool), terminated=zero.astype(bool), mean=mean,
                log_std=log_std, log_prob=zero, time=time, returns=returns, baseline=zero,
                advantages=adv)


def _local(batch) -> TrajectoryBatch:
    """This rank's rows of a numpy batch, as a port batch."""
    return TrajectoryBatch(**{k: dist.local_rows(torch.as_tensor(v)) for k, v in batch.items()},
                           env_info={})


def _policy(state_dict, hidden):
    env = make("point_mass", device="cpu")
    policy = GaussianMLP(env.spec, hidden_sizes=hidden) if hidden else GaussianLinear(env.spec)
    policy.load_state_dict(state_dict)
    return env, policy


# -- the cases, run on each rank and in one process ----------------------------
def case_npg(inputs, name):
    env, policy = _policy(inputs[f"{name}_policy"], HIDDEN[name])
    agent = NPG(env, policy, QuadraticBaseline(env.spec), num_traj=N, normalized_step_size=0.05)
    gen = torch.Generator().manual_seed(1)
    batch = sample_episodes(env, policy, N, env.spec.horizon, gen)
    metrics = agent.finish_train_step(batch, generator=gen)
    return dict(batch={k: getattr(batch, k) for k in BATCH_FIELDS}, flat=_flat(policy),
                metrics={k: float(v) for k, v in metrics.items()})


def case_trpo(inputs):
    out = {}
    for case, (seed, kl_dist, _) in TRPO_CASES.items():
        env, policy = _policy(inputs["linear_policy"], ())
        agent = TRPO(env, policy, ZeroBaseline(env.spec), kl_dist=kl_dist, num_traj=N)
        metrics = agent.update(_local(inputs["trpo_batches"][seed]))
        out[case] = dict(flat=_flat(policy), metrics={k: float(v) for k, v in metrics.items()})
    return out


def case_dapg(inputs):
    env, policy = _policy(inputs["linear_policy"], ())
    demos = TrajectoryBatch(**{k: torch.as_tensor(v) for k, v in inputs["demos"].items()},
                            env_info={})
    agent = DAPG(env, policy, ZeroBaseline(env.spec), demo_batch=demos, num_traj=N,
                 normalized_step_size=0.05, lam_0=0.5, lam_1=0.9)
    agent.iteration = 3
    batch = _local(inputs["dapg_batch"])
    grad = ravel(agent.vpg_grad(agent.params(), batch))[0]
    metrics = agent.update(batch)
    return dict(grad=grad, flat=_flat(policy), metrics={k: float(v) for k, v in metrics.items()})


def case_ppo(inputs):
    """The sharded path: two ranks only."""
    out = {}
    if dist.world_size() == 1:
        return out
    for flags, kw in PPO_FLAGS.items():
        env, policy = _policy(inputs["ppo_policy"], (16, 16))
        agent = PPO(env, policy, ZeroBaseline(env.spec), num_traj=N, epochs=PPO_EPOCHS,
                    mb_size=PPO_MB, learn_rate=3e-3, **kw)
        agent.iteration = PPO_ITERATION
        perms = [torch.as_tensor(p) for p in inputs["ppo_perms"][dist.rank()]]
        metrics = agent.update(_local(inputs["ppo_batch"]), perms=perms)
        out[flags] = dict(flat=_flat(policy), metrics={k: float(v) for k, v in metrics.items()})
    try:
        PPO(env, policy, ZeroBaseline(env.spec), num_traj=N - 1)
        out["uneven"] = "built"
    except ValueError as e:
        out["uneven"] = str(e)
    return out


def case_baselines(inputs):
    env = make("point_mass", device="cpu")
    batch = _local(inputs["fit_batch"])
    out = {}
    for name, base in (("zero", ZeroBaseline(env.spec)), ("linear", LinearBaseline(env.spec)),
                       ("quadratic", QuadraticBaseline(env.spec)),
                       ("mlp", MLPBaseline(env.spec, hidden_sizes=(16, 16), epochs=2,
                                           batch_size=16, vf_clip_coef=0.2, reg_coef=1e-3,
                                           generator=torch.Generator().manual_seed(3)))):
        perms = [torch.as_tensor(p) for p in inputs["fit_perms"]] if name == "mlp" else None
        metrics = base.fit(batch, perms=perms)
        with torch.no_grad():
            pred = base.predict(batch.observations, batch.time)
        out[name] = dict(state={k: v.clone() for k, v in base.state_dict().items()},
                         pred=pred, metrics={k: float(v) for k, v in metrics.items()})
    return out


def case_samples(inputs):
    env, policy = _policy(inputs["linear_policy"], ())
    agent = NPG(env, policy, QuadraticBaseline(env.spec), num_traj=N, num_samples=N * 10,
                sample_mode="samples", normalized_step_size=0.05)
    first = None
    for i in range(3):
        metrics = agent.train_step(torch.Generator().manual_seed(10 + i))
        if first is None:
            first = dict(obs=agent.sampler_carry.obs,
                         metrics={k: float(v) for k, v in metrics.items()})
    state = agent.state_dict()["sampler_carry"]
    # the twin of tests/test_sharding.py::test_sharded_samples_mode_ppo_with_carry
    ppo_env = make("point_mass", device="cpu")
    ppo = PPO(ppo_env, GaussianMLP(ppo_env.spec, hidden_sizes=(16, 16),
                                   generator=torch.Generator().manual_seed(0)),
              MLPBaseline(ppo_env.spec, epochs=1, batch_size=64), num_traj=16, num_samples=160,
              sample_mode="samples", horizon=25, mb_size=64, epochs=2, entropy_coef=0.001)
    finite = True
    for i in range(3):
        m = ppo.train_step(torch.Generator().manual_seed(i))
        finite &= all(bool(torch.isfinite(v)) for v in m.values())
    return dict(first=first, carry=state, flat=_flat(policy),
                ppo=dict(finite=finite, t_in_ep=ppo.sampler_carry.t_in_ep.clone(),
                         rows=ppo.sampler_carry.obs.shape[0], flat=_flat(ppo.policy)))


def run_cases(inputs):
    return dict(npg_linear=case_npg(inputs, "linear"), npg_mlp=case_npg(inputs, "mlp"),
                trpo=case_trpo(inputs), dapg=case_dapg(inputs), ppo=case_ppo(inputs),
                baselines=case_baselines(inputs), samples=case_samples(inputs))


def _rank_main(device, inputs, out_dir):
    torch.save(run_cases(inputs), os.path.join(out_dir, f"rank{dist.rank()}.pt"))


# -- the reference's inputs ------------------------------------------------------
def _jax_policy_params(hidden, seed=0):
    jenv = JPointMass()
    jpol = JGaussianMLP(jenv.spec, hidden_sizes=hidden) if hidden else JGaussianLinear(jenv.spec)
    params = jax.tree.map(np.asarray, jpol.init(jax.random.PRNGKey(seed)))
    return jpol, params, policy_from_jax(params, jenv.spec).state_dict()


def _ppo_perms(key, m_loc, mb_loc, num_mb):
    """The reference's per-shard minibatches: for each epoch key, shard s
    permutes its ``m_loc`` steps with ``fold_in(ekey, s)``."""
    return {s: [np.asarray(jax.random.permutation(jax.random.fold_in(k, s), m_loc)
                           [: num_mb * mb_loc].reshape(num_mb, mb_loc))
                for k in jax.random.split(key, PPO_EPOCHS)] for s in range(WORLD)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(inputs, single, ranks)``: the cases' inputs, the single-rank
    results and each rank's."""
    inputs = {f"{name}_policy": _jax_policy_params(hidden)[2] for name, hidden in HIDDEN.items()}
    inputs["ppo_policy"] = _jax_policy_params((16, 16), seed=4)[2]
    _, linear = _policy(inputs["linear_policy"], ())
    inputs["trpo_batches"] = {seed: _random_batch(seed, linear) for seed in (0, 1)}
    dapg = _random_batch(1, linear)
    dapg["advantages"][N - 1, 2] = 25.0  # the max, in rank 1's rows
    inputs["dapg_batch"] = dapg
    demo = _random_batch(2, linear, n=3, horizon=7)
    _, policy = _policy(inputs["ppo_policy"], (16, 16))
    inputs["demos"] = {k: demo[k] for k in dapg}
    inputs["ppo_batch"] = _random_batch(3, policy)
    m_loc, mb_loc = N // WORLD * T, PPO_MB // WORLD
    inputs["ppo_perms"] = _ppo_perms(jax.random.PRNGKey(1), m_loc, mb_loc, m_loc // mb_loc)
    inputs["fit_batch"] = _random_batch(5, policy)
    rng = np.random.default_rng(6)
    inputs["fit_perms"] = [rng.permutation(N * T)[: N * T // 16 * 16].reshape(-1, 16)
                           for _ in range(2)]
    out = tmp_path_factory.mktemp("ranks")
    dist.spawn(_rank_main, WORLD, "cpu", (inputs, str(out)))
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return inputs, run_cases(inputs), ranks


def _blocks(x):
    """Each rank's block of the single-rank rows of ``x``."""
    out = []
    for r in range(WORLD):
        start, stop = dist.row_block(x.shape[0], r, WORLD)
        out.append(x[start:stop])
    return out


def _metrics_close(got, want, rtol, atol, skip=()):
    assert set(got) == set(want)
    for k in want:
        if k not in skip:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("hidden", ["linear", "mlp"])
def test_npg_step_matches_one_rank(runs, hidden):
    """Rows bit for bit, the ranks' parameters the same bits, the step and
    the metrics within the tolerance (linear 1e-6; MLP 1e-5, CG's round-off)."""
    _, single, ranks = runs
    key = f"npg_{hidden}"
    for name in BATCH_FIELDS:
        for r, want in enumerate(_blocks(single[key]["batch"][name])):
            assert torch.equal(ranks[r][key]["batch"][name], want), (name, r)
    assert torch.equal(ranks[0][key]["flat"], ranks[1][key]["flat"])
    atol = 1e-6 if hidden == "linear" else 1e-4
    np.testing.assert_allclose(ranks[0][key]["flat"].numpy(), single[key]["flat"].numpy(),
                               rtol=0, atol=atol)
    assert ranks[0][key]["metrics"] == ranks[1][key]["metrics"]
    _metrics_close(ranks[0][key]["metrics"], single[key]["metrics"], rtol=1e-4, atol=1e-6)
    assert ranks[0][key]["metrics"]["num_samples"] == single[key]["metrics"]["num_samples"]
    assert single[key]["metrics"]["kl_dist"] > 1e-3  # the policy moved


def test_npg_step_matches_the_jax_sharded_step(runs):
    """The JAX package's NPG ``process_batch`` + ``update`` on ``make_mesh(2)``,
    the batch sharded over its env axis, from the same weights and the port's
    sampled batch: the port's two-rank step within 1e-6."""
    inputs, single, ranks = runs
    jenv = JPointMass()
    jpol, params, _ = _jax_policy_params(())
    mesh = make_mesh(WORLD)
    jagent = JNPG(jenv, jpol, JQuadratic(jenv.spec), num_traj=N, normalized_step_size=0.05,
                  mesh=mesh)
    state = jagent.init(jax.random.PRNGKey(0)).replace(params=jax.tree.map(jnp.asarray, params))
    b = {k: v.numpy() for k, v in single["npg_linear"]["batch"].items()}
    zero = np.zeros(b["rewards"].shape, np.float32)
    jbatch = JTrajectoryBatch(**b, returns=zero, baseline=zero, advantages=zero, env_info={})

    @jax.jit
    def step(state, batch):
        batch = shard_env_pytree(jax.tree.map(jnp.asarray, batch), mesh)
        return jagent.update(state, jagent.process_batch(state, batch), jax.random.PRNGKey(2))

    new_state, jm = step(state, jbatch)
    env, policy = _policy(inputs["linear_policy"], ())
    want = policy_flat_from_jax(np.asarray(ravel_pytree(new_state.params)[0]), policy)
    np.testing.assert_allclose(ranks[0]["npg_linear"]["flat"].numpy(), want.numpy(), rtol=0,
                               atol=1e-6)
    for k in ("alpha", "kl_dist", "surr_improvement"):
        np.testing.assert_allclose(ranks[0]["npg_linear"]["metrics"][k], float(jm[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("case", sorted(TRPO_CASES))
def test_trpo_line_search_matches_one_rank(runs, case):
    """The linear policy on two batches: the first probe accepted, one
    backtrack, every probe rejected (``kl_dist`` 1e-30)."""
    _, single, ranks = runs
    want, got = single["trpo"][case], ranks[0]["trpo"][case]
    assert want["metrics"]["backtrack_iters"] == TRPO_CASES[case][2], want["metrics"]
    for k in ("backtrack_iters", "step_accepted"):
        assert got["metrics"][k] == want["metrics"][k] == ranks[1]["trpo"][case]["metrics"][k]
    assert torch.equal(got["flat"], ranks[1]["trpo"][case]["flat"])
    np.testing.assert_allclose(got["flat"].numpy(), want["flat"].numpy(), rtol=0, atol=1e-6)
    _metrics_close(got["metrics"], want["metrics"], rtol=1e-4, atol=1e-7)


def test_dapg_counts_the_demos_once_and_takes_the_global_max(runs):
    """The planted advantage (25) lies in rank 1's rows: rank 0's own max is
    under 4. With the global max and the demo term on one rank, the
    gradient and the step are one rank's."""
    inputs, single, ranks = runs
    assert inputs["dapg_batch"]["advantages"][: N // 2].max() < 4.0
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["dapg"]["grad"].numpy(),
                                   single["dapg"]["grad"].numpy(), rtol=1e-5, atol=1e-6)
    assert torch.equal(ranks[0]["dapg"]["flat"], ranks[1]["dapg"]["flat"])
    np.testing.assert_allclose(ranks[0]["dapg"]["flat"].numpy(), single["dapg"]["flat"].numpy(),
                               rtol=0, atol=1e-6)
    _metrics_close(ranks[0]["dapg"]["metrics"], single["dapg"]["metrics"], rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("flags", sorted(PPO_FLAGS))
def test_ppo_sharded_path_matches_the_reference(runs, flags):
    """The JAX PPO update on ``make_mesh(2)`` (its ``_minibatch_adam_sharded``)
    and the port's two ranks with the same per-shard permutations: the
    parameters within 3e-5 (each Adam step moves a weight by about lr)."""
    inputs, _, ranks = runs
    jenv = JPointMass()
    kw = dict(clip_coef=0.2, epochs=PPO_EPOCHS, mb_size=PPO_MB, learn_rate=3e-3,
              **PPO_FLAGS[flags])
    jpol, params, _ = _jax_policy_params((16, 16), seed=4)
    mesh = make_mesh(WORLD)
    jagent = JPPO(jenv, jpol, JMLPBaseline(jenv.spec), num_traj=N, horizon=T, mesh=mesh, **kw)
    state = jagent.init(jax.random.PRNGKey(0)).replace(
        params=jax.tree.map(jnp.asarray, params), iteration=jnp.asarray(PPO_ITERATION))
    state = state.replace(opt_state=jagent.init_opt_state(state.params))
    b = inputs["ppo_batch"]
    jbatch = JTrajectoryBatch(**{k: jnp.asarray(v) for k, v in b.items()}, env_info={})
    new_state, jm = jax.jit(lambda s, bb: jagent.update(s, shard_env_pytree(bb, mesh),
                                                        jax.random.PRNGKey(1)))(state, jbatch)
    got = ranks[0]["ppo"][flags]
    assert torch.equal(got["flat"], ranks[1]["ppo"][flags]["flat"])
    _, policy = _policy(inputs["ppo_policy"], (16, 16))
    want = policy_flat_from_jax(np.asarray(ravel_pytree(new_state.params)[0]), policy)
    np.testing.assert_allclose(got["flat"].numpy(), want.numpy(), rtol=0, atol=3e-5)
    assert float((got["flat"] - _flat(policy)).abs().max()) > 1e-3  # the policy moved
    for k, rtol in (("kl_dist", 1e-3), ("surr_improvement", 1e-3), ("log_std_mean", 1e-4),
                    ("alpha", 1e-6)):
        np.testing.assert_allclose(got["metrics"][k], float(jm[k]), rtol=rtol, atol=1e-6,
                                   err_msg=k)
    assert "divide over the 2 ranks" in ranks[0]["ppo"]["uneven"]


@pytest.mark.parametrize("name", ["zero", "linear", "quadratic", "mlp"])
def test_baseline_fits_match_one_rank(runs, name):
    """The fits on two ranks' rows: the same state on both ranks and, within
    f32 round-off of the sums' order, the single-rank fit's: the MLP's
    weights to 1e-6; each rank's predictions to 1e-4 of the targets' scale
    (the random features' ridge solves are ill-conditioned: the quadratic
    one's coefficients reach 340 and part by up to 2e-2 between the two
    orders of the Gram matrix's sums)."""
    _, single, ranks = runs
    got, want = ranks[0]["baselines"][name], single["baselines"][name]
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k], ranks[1]["baselines"][name]["state"][k]), k
        if name == "mlp":
            np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)
    for r, pred in enumerate(_blocks(want["pred"])):
        np.testing.assert_allclose(ranks[r]["baselines"][name]["pred"].numpy(), pred.numpy(),
                                   rtol=0, atol=1e-4 * 5.0)
    _metrics_close(got["metrics"], want["metrics"], rtol=1e-5, atol=1e-7)
    if name != "zero":
        assert want["metrics"]["VF_error_after"] < want["metrics"]["VF_error_before"]


def test_samples_mode_carries_each_ranks_rows(runs):
    """Three NPG windows on the carry: the first window's end rows bit for
    bit, the checkpoint state's carry (every rank's rows, gathered) the same
    on both ranks and the single-rank one's within 1e-4; PPO's twin of
    tests/test_sharding.py: 8 rows a rank, every one 5 steps into its second
    episode, finite metrics, the same parameters on both ranks."""
    _, single, ranks = runs
    for r, want in enumerate(_blocks(single["samples"]["first"]["obs"])):
        assert torch.equal(ranks[r]["samples"]["first"]["obs"], want)
    _metrics_close(ranks[0]["samples"]["first"]["metrics"], single["samples"]["first"]["metrics"],
                   rtol=1e-4, atol=1e-6)
    for k, v in single["samples"]["carry"].items():
        if v is None:
            continue
        assert torch.equal(ranks[0]["samples"]["carry"][k], ranks[1]["samples"]["carry"][k]), k
        assert ranks[0]["samples"]["carry"][k].shape == v.shape == (N, *v.shape[1:]), k
        np.testing.assert_allclose(ranks[0]["samples"]["carry"][k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for r in range(WORLD):
        ppo = ranks[r]["samples"]["ppo"]
        assert ppo["finite"] and ppo["rows"] == 8 and bool((ppo["t_in_ep"] == 5).all())
    assert torch.equal(ranks[0]["samples"]["ppo"]["flat"], ranks[1]["samples"]["ppo"]["flat"])
