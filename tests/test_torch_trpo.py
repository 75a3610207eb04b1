"""Parity of the port's TRPO (``mjrl_tpu_torch.algos.TRPO``) with the JAX
package's, and TRPO through the entry point on the CPU.

One reference ``TrajectoryBatch`` (N=6 rows x T=10 steps of walker2d-sized
observations drawn with numpy, two rows ending early; the actions drawn
from the policy's own Gaussian; random advantages) goes through
``mjrl_tpu.algos.TRPO.update`` and the port's ``update`` with the same
weights (``mjrl_tpu_torch.convert``). Three line-search cases: the first
probe accepted (``kl_dist`` 0.01), a backtrack (``kl_dist`` 3: the first
step leaves the quadratic model's trust region) and every probe rejected
(``kl_dist`` 1e-30: the steps are below f32 resolution, so the surrogate
never improves).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import envs as jenvs
from mjrl_tpu.algos import TRPO as JTRPO
from mjrl_tpu.models import GaussianMLP as JGaussianMLP
from mjrl_tpu.models import MLPBaseline as JMLPBaseline
from mjrl_tpu.ops.ravel import ravel_pytree
from mjrl_tpu.types import TrajectoryBatch as JTrajectoryBatch
from mjrl_tpu_torch.algos import TRPO
from mjrl_tpu_torch.convert import policy_flat_from_jax, policy_from_jax
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.models import MLPBaseline
from mjrl_tpu_torch.ops.ravel import ravel
from mjrl_tpu_torch.train import load_config, run_job
from mjrl_tpu_torch.types import TrajectoryBatch

torch.set_num_threads(1)

N, T, OBS = 6, 10, 17
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {"accepted": (1e-2, 1.0), "backtracked": (3.0, 2.0), "rejected": (1e-30, 10.0)}


@pytest.fixture(scope="module")
def jenv():
    return jenvs.make("walker2d", horizon=T)


def _reference(jenv, kl_dist):
    """The JAX update on the reference batch: (state0, batch, metrics,
    new flat params), numpy."""
    agent = JTRPO(jenv, JGaussianMLP(jenv.spec, hidden_sizes=(16, 16)),
                  JMLPBaseline(jenv.spec, epochs=1, batch_size=4), kl_dist=kl_dist, num_traj=N,
                  horizon=T)
    state = agent.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(N, T, OBS)).astype(np.float32)
    mean, log_std = agent.policy.apply(state.params, state.transforms, jnp.asarray(obs))
    mean = np.asarray(mean)
    log_std = np.broadcast_to(np.asarray(log_std), mean.shape).astype(np.float32)
    actions = (mean + np.exp(log_std) * rng.normal(size=mean.shape)).astype(np.float32)
    valid = np.ones((N, T), bool)
    valid[1, 6:] = valid[4, 3:] = False
    adv = (rng.normal(size=(N, T)) * valid).astype(np.float32)
    zero = np.zeros((N, T), np.float32)
    batch = dict(observations=obs, actions=actions, rewards=zero, valid=valid,
                 done=zero.astype(bool), terminated=zero.astype(bool), mean=mean, log_std=log_std,
                 log_prob=zero, time=zero, returns=zero, baseline=zero, advantages=adv)
    jbatch = JTrajectoryBatch(**{k: jnp.asarray(v) for k, v in batch.items()}, env_info={})
    new_state, metrics = agent.update(state, jbatch, jax.random.PRNGKey(1))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    return (to_np(state.params), batch, {k: float(v) for k, v in metrics.items()},
            np.asarray(ravel_pytree(new_state.params)[0]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_matches_reference(jenv, case):
    kl_dist, probes = CASES[case]
    params0, batch, want, want_flat = _reference(jenv, kl_dist)
    assert want["backtrack_iters"] == probes, want
    env = make("walker2d", horizon=T, device="cpu")
    policy = policy_from_jax(params0, env.spec)
    agent = TRPO(env, policy, MLPBaseline(env.spec), kl_dist=kl_dist, num_traj=N, horizon=T)
    before, _ = ravel({k: v.detach() for k, v in policy.named_parameters()})
    tb = TrajectoryBatch(**{k: torch.as_tensor(v) for k, v in batch.items()}, env_info={})
    got = {k: float(v) for k, v in agent.update(tb).items()}
    assert set(got) == set(want)
    # the ladder's decisions are exact
    for name in ("backtrack_iters", "step_accepted", "delta"):
        assert got[name] == want[name], name
    # alpha and the step come out of 10 CG iterations of f32 Fisher products
    # (test_torch_npg.py's bounds for NPG's update)
    for name, rtol, atol in (("alpha", 1e-3, 0.0), ("kl_dist", 1e-3, 1e-7),
                             ("surr_improvement", 1e-3, 1e-6)):
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=atol, err_msg=name)
    got_flat, _ = ravel({k: v.detach() for k, v in policy.named_parameters()})
    np.testing.assert_allclose(got_flat.numpy(), policy_flat_from_jax(want_flat, policy).numpy(),
                               rtol=1e-3, atol=3e-4)
    if case == "rejected":
        assert got["alpha"] == got["kl_dist"] == got["surr_improvement"] == 0.0
        assert torch.equal(got_flat, before)  # the old parameters stay
    else:
        assert got["kl_dist"] <= kl_dist and got["surr_improvement"] > 0.0


def test_backtracked_step_is_halved(jenv):
    """The accepted probe of the backtracked case is NPG's step times the
    backtrack ratio."""
    params0, batch, want, _ = _reference(jenv, CASES["backtracked"][0])
    env = make("walker2d", horizon=T, device="cpu")
    agent = TRPO(env, policy_from_jax(params0, env.spec), MLPBaseline(env.spec),
                 kl_dist=CASES["backtracked"][0], num_traj=N, horizon=T)
    tb = TrajectoryBatch(**{k: torch.as_tensor(v) for k, v in batch.items()}, env_info={})
    _, alpha0, _, _ = agent.step_direction(agent.params(), tb)
    got = agent.update(tb)
    torch.testing.assert_close(got["alpha"], alpha0 * agent.backtrack_ratio, rtol=1e-6, atol=0)


def test_cli_runs_walker2d_trpo_and_resumes(tmp_path):
    """examples/walker2d_trpo.json through the entry point at a tiny
    width, then resumed for one more iteration."""
    config = os.path.join(ROOT, "examples", "walker2d_trpo.json")
    small = ["num_traj=4", "horizon=20", "save_freq=1"]
    agent = run_job(load_config(config, [*small, "niter=2"]), str(tmp_path), device="cpu")
    assert isinstance(agent, TRPO) and agent.kl_dist == 0.01 and agent.iteration == 2
    agent = run_job(load_config(config, [*small, "niter=3"]), str(tmp_path), device="cpu")
    assert agent.iteration == 3
    with open(tmp_path / "logs" / "log.csv") as f:
        header, *rows = f.read().splitlines()
    assert {"backtrack_iters", "step_accepted"} <= set(header.split(",")) and len(rows) == 3
