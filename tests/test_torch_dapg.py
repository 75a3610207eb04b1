"""The port's DAPG (mjrl_tpu_torch.algos.dapg) against the JAX package, and
the five DAPG configs through the port's entry point on the CPU.

``DAPG.update`` runs on the same processed point_mass batch and demos as
the reference's, at iterations 0 and 3, with ``test_torch_npg.py``'s
tolerances; without demos it is NPG's update. Each DAPG config runs at 2
envs x 2 steps through ``run_job`` (BC warm start from its demo pickle,
then DAPG); pen and hopper resume without rerunning BC, and a pen run warm
starts from another's checkpoint (``init_policy_from``) as relocate's
second generation does.
"""

import copy
import csv
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.algos import DAPG as JDAPG
from mjrl_tpu.envs.point_mass import PointMassEnv as JPointMass
from mjrl_tpu.models import GaussianMLP as JGaussianMLP
from mjrl_tpu.models import QuadraticBaseline as JQuadratic
from mjrl_tpu.ops.ravel import ravel_pytree
from mjrl_tpu.utils.demos import paths_to_batch as j_paths_to_batch
from mjrl_tpu_torch.algos import DAPG, NPG
from mjrl_tpu_torch.convert import baseline_from_jax, policy_flat_from_jax, policy_from_jax
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.ops.ravel import ravel
from mjrl_tpu_torch.train import load_config, run_job
from mjrl_tpu_torch.types import TrajectoryBatch
from mjrl_tpu_torch.utils.checkpoint import CheckpointManager
from mjrl_tpu_torch.utils.demos import paths_to_batch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 6
LAM_0, LAM_1, STEP = 0.5, 0.9, 0.05
t = lambda x: torch.as_tensor(np.array(x))


def _to_torch(jb) -> TrajectoryBatch:
    return TrajectoryBatch(
        observations=t(jb.observations), actions=t(jb.actions), rewards=t(jb.rewards),
        valid=t(jb.valid), done=t(jb.done), terminated=t(jb.terminated), mean=t(jb.mean),
        log_std=t(jb.log_std), log_prob=t(jb.log_prob), time=t(jb.time), returns=t(jb.returns),
        baseline=t(jb.baseline), advantages=t(jb.advantages),
        env_info={k: t(v) for k, v in jb.env_info.items()})


def _demo_paths():
    """Five demo paths of 7-25 steps (the batch pads them), obs near the
    sampled ones, actions of a PD controller plus noise."""
    rng = np.random.default_rng(0)
    paths = []
    for L in (25, 7, 18, 25, 12):
        obs = rng.normal(size=(L, 6)).astype(np.float32)
        act = 0.8 * obs[:, 4:6] - 0.15 * obs[:, 2:4] + 0.1 * rng.normal(size=(L, 2))
        paths.append(dict(observations=obs, actions=act.astype(np.float32)))
    return paths


@pytest.fixture(scope="module")
def ref():
    """The reference DAPG's processed point_mass batch (with 5 steps of row
    0 masked out and a large advantage planted there, which the demo
    advantage's max must skip) and its updates at iterations 0 and 3."""
    jenv = JPointMass()
    agent = JDAPG(jenv, JGaussianMLP(jenv.spec, hidden_sizes=(8, 8)), JQuadratic(jenv.spec),
                  demo_batch=j_paths_to_batch(_demo_paths()), lam_0=LAM_0, lam_1=LAM_1,
                  normalized_step_size=STEP, num_traj=N)
    state = agent.init(jax.random.PRNGKey(0))
    batch = agent.process_batch(state, agent.sample_batch(state, jax.random.PRNGKey(1)))
    valid = batch.valid.at[0, 20:].set(False)
    batch = batch.replace(valid=valid, advantages=jnp.where(valid, batch.advantages, 1e3))
    update = jax.jit(agent.update)
    out = {}
    for it in (0, 3):
        new, metrics = update(state.replace(iteration=jnp.asarray(it, jnp.int32)), batch,
                              jax.random.PRNGKey(2))
        out[it] = (np.asarray(ravel_pytree(new.params)[0]),
                   {k: float(v) for k, v in metrics.items()})
    to_np = lambda tree: jax.tree.map(np.array, tree)
    return dict(state=to_np(state), batch=to_np(batch), out=out)


def _port_agent(ref, demos=True, cls=DAPG):
    env = make("point_mass", device="cpu")
    state = ref["state"]
    kw = dict(demo_batch=paths_to_batch(_demo_paths()) if demos else None,
              lam_0=LAM_0, lam_1=LAM_1) if cls is DAPG else {}
    return cls(env, policy_from_jax(state.params, env.spec),
               baseline_from_jax(state.baseline_state, env.spec),
               normalized_step_size=STEP, num_traj=N, **kw)


@pytest.mark.parametrize("iteration", [0, 3])
def test_update_matches_reference(ref, iteration):
    """The union-surrogate gradient, CG on the sampled Fisher and the step:
    ``demo_coef`` rtol 1e-6; alpha, kl_dist and surr_improvement and the new
    parameters by test_torch_npg.py's tolerances."""
    agent = _port_agent(ref)
    agent.iteration = iteration
    batch = _to_torch(ref["batch"])
    assert not bool(batch.valid.all()) and float(batch.advantages.max()) == 1e3
    metrics = agent.update(batch)
    want_flat, want = ref["out"][iteration]
    np.testing.assert_allclose(float(metrics["demo_coef"]), LAM_0 * LAM_1**iteration, rtol=1e-6)
    np.testing.assert_allclose(float(metrics["demo_coef"]), want["demo_coef"], rtol=1e-6)
    for name, rtol, atol in (("alpha", 1e-3, 0.0), ("kl_dist", 1e-3, 1e-7),
                             ("surr_improvement", 1e-3, 1e-6), ("delta", 0.0, 0.0)):
        np.testing.assert_allclose(float(metrics[name]), want[name], rtol=rtol, atol=atol,
                                   err_msg=name)
    got, _ = ravel({k: v.detach() for k, v in agent.policy.named_parameters()})
    np.testing.assert_allclose(got.numpy(), policy_flat_from_jax(want_flat, agent.policy).numpy(),
                               rtol=1e-3, atol=3e-4)
    # the demos moved the step: NPG's own step from the same start differs
    npg = _port_agent(ref, cls=NPG)
    npg.update(batch)
    npg_flat, _ = ravel({k: v.detach() for k, v in npg.policy.named_parameters()})
    assert float((npg_flat - got).abs().max()) > 1e-3


def test_without_demos_the_update_is_npg(ref):
    """``demo_batch=None``: the same metrics (no ``demo_coef``) and the same
    parameters as NPG's update, bit for bit."""
    batch = _to_torch(ref["batch"])
    dapg, npg = _port_agent(ref, demos=False), _port_agent(ref, cls=NPG)
    dapg.iteration = npg.iteration = 3
    got, want = dapg.update(batch), npg.update(batch)
    assert set(got) == set(want) and "demo_coef" not in got
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    for (k, a), (_, b) in zip(dapg.policy.state_dict().items(), npg.policy.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def _rows(path):
    with open(path, newline="") as f:
        return [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]


SMALL = ["num_traj=2", "horizon=2", "save_freq=1"]


@pytest.mark.parametrize("name", ["adroit_pen_dapg.json", "adroit_door_dapg.json",
                                  "adroit_hammer_dapg.json", "adroit_relocate_dapg.json",
                                  "hopper_dapg.json"])
def test_dapg_config_runs_through_the_entry_point(tmp_path, capsys, name):
    """One DAPG iteration at 2 envs x 2 steps after BC on the config's demo
    pickle (its loss falls); every logged value finite, ``demo_coef`` =
    lam_0. Pen and hopper then resume for a second iteration, which reruns
    no BC and logs lam_0 * lam_1."""
    path = os.path.join(ROOT, "examples", name)
    agent = run_job(load_config(path, [*SMALL, "niter=1"]), str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    assert isinstance(agent, DAPG) and agent.iteration == 1
    loss = [line for line in out.splitlines() if line.startswith("BC warm start")]
    before, after = (float(x) for x in loss[0].split("loss ")[1].split(" -> "))
    assert len(loss) == 1 and after < before
    lam_0, lam_1 = agent.lam_0, agent.lam_1
    niter = 1
    if name in ("adroit_pen_dapg.json", "hopper_dapg.json"):
        niter = 2
        agent = run_job(load_config(path, [*SMALL, "niter=2"]), str(tmp_path), device="cpu")
        assert "BC warm start" not in capsys.readouterr().out and agent.iteration == 2
    rows = _rows(str(tmp_path / "logs" / "log.csv"))
    assert len(rows) == niter and all(math.isfinite(v) for r in rows for v in r.values())
    np.testing.assert_allclose([r["demo_coef"] for r in rows],
                               [lam_0 * lam_1**i for i in range(niter)], rtol=1e-6)


def test_init_policy_from_chain(tmp_path):
    """Pen DAPG into ``a``, then a run with ``init_policy_from=a`` and no BC
    (relocate generation 2's pattern): it starts from ``a``'s latest policy
    (parameters and BC's transforms) and baseline, with a fresh iteration
    and running score (exact); a missing source raises."""
    path = os.path.join(ROOT, "examples", "adroit_pen_dapg.json")
    run_job(load_config(path, [*SMALL, "niter=1"]), str(tmp_path / "a"), device="cpu")
    src = CheckpointManager(str(tmp_path / "a")).restore_latest()
    chain = [*SMALL, f"init_policy_from=\"{tmp_path / 'a'}\"", "bc_init=false"]
    agent = run_job(load_config(path, [*chain, "niter=0"]), str(tmp_path / "b"), device="cpu")
    for group in ("policy", "baseline"):
        got = getattr(agent, group).state_dict()
        assert set(got) == set(src[group])
        for k, v in src[group].items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    assert float(src["policy"]["mlp.in_scale"].min()) < 1.0  # BC's transforms came along
    opt = agent.baseline.optimizer.state_dict()
    torch.testing.assert_close(opt["state"][0]["exp_avg"],
                               src["baseline_optimizer"]["state"][0]["exp_avg"], rtol=0, atol=0)
    assert agent.iteration == 0 and float(agent.running_score) == 0.0
    first = copy.deepcopy(agent.policy.state_dict())
    agent = run_job(load_config(path, [*chain, "niter=1"]), str(tmp_path / "b"), device="cpu")
    assert agent.iteration == 1
    assert any(not torch.equal(first[k], v) for k, v in agent.policy.state_dict().items())
    with pytest.raises(FileNotFoundError, match="init_policy_from"):
        run_job(load_config(path, [*SMALL, f"init_policy_from=\"{tmp_path / 'none'}\"",
                                   "niter=1"]), str(tmp_path / "c"), device="cpu")
    assert not (tmp_path / "none").exists()
