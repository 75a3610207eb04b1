"""The port's entry point, ``python -m mjrl_tpu_torch.train``, on the CPU.

Hopper NPG from ``examples/hopper_npg.json`` cut to 4 envs x 20 steps:
the CLI writes ``config.json``, a ``log.csv`` with every column of the JAX
package's hopper run (``runs/hopper_npg_expert/logs/log.csv``) and
checkpoints; a resumed run continues at the checkpoint's iteration with
the log cut to match and ends with the policy of a straight run;
``mesh_devices=2`` raises in ``build`` outside a group of two ranks and
trains through ``run_job``, which starts them; the settings the port
had refused until BC, DAPG, the warm starts, the evaluation rollouts, the
least-squares baselines, model-based NPG, the linear policy, REINFORCE and
the classic envs were ported build; every other config the port runs goes through the
entry point at 2 envs x 2 steps; the humanoid PPO and TRPO configs run
with their obs_norm at a small width and resume; and a run on the card
never falls back to the CPU; the Adroit pen NPG configs run at 2 envs x 2
steps and the Adroit DAPG configs build a DAPG agent with their demos.
"""

import csv
import glob
import math
import os
import subprocess
import sys

import pytest
import torch

from mjrl_tpu_torch.train import load_config, run_job
from mjrl_tpu_torch.utils.checkpoint import CheckpointManager
from mjrl_tpu_torch.utils.configs import RunConfig, build

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOPPER = os.path.join(ROOT, "examples", "hopper_npg.json")
SMALL = ["num_traj=4", "horizon=20", "save_freq=1"]


def _header(path):
    with open(path, newline="") as f:
        return next(csv.reader(f))


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_every_example_config_parses():
    paths = sorted(glob.glob(os.path.join(ROOT, "examples", "*.json")))
    assert len(paths) > 30
    for path in paths:
        assert isinstance(RunConfig.from_json(path), RunConfig), path


def test_cli_writes_config_log_and_checkpoints(tmp_path):
    out = tmp_path / "job"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "mjrl_tpu_torch.train", "--device", "cpu", "--config", HOPPER,
           "--output", str(out), "--set", *SMALL, "niter=2"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert RunConfig.from_json(str(out / "config.json")).num_traj == 4
    want = _header(os.path.join(ROOT, "runs", "hopper_npg_expert", "logs", "log.csv"))
    got = _header(str(out / "logs" / "log.csv"))
    assert set(want) <= set(got) and "total_env_steps" in got
    assert [r["iteration"] for r in _rows(str(out / "logs" / "log.csv"))] == ["0", "1"]
    ckpt = CheckpointManager(str(out))
    assert ckpt.latest_step() == 2
    best = ckpt.restore_best()
    assert best["iteration"] in (1, 2) and set(best["policy"]) == set(ckpt.restore(2)["policy"])


def test_resume_continues_a_run_exactly(tmp_path):
    straight = run_job(load_config(HOPPER, [*SMALL, "niter=3"]), str(tmp_path / "a"), device="cpu")
    run_job(load_config(HOPPER, [*SMALL, "niter=2"]), str(tmp_path / "b"), device="cpu")
    resumed = run_job(load_config(HOPPER, [*SMALL, "niter=3"]), str(tmp_path / "b"), device="cpu")
    assert resumed.iteration == straight.iteration == 3
    rows = _rows(str(tmp_path / "b" / "logs" / "log.csv"))
    assert len(rows) == 3 and float(rows[-1]["iteration"]) == 2
    for (name, a), (_, b) in zip(straight.policy.state_dict().items(),
                                 resumed.policy.state_dict().items()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=name)
    torch.testing.assert_close(resumed.running_score, straight.running_score, rtol=0, atol=0)
    assert float(rows[-1]["running_score"]) == pytest.approx(float(straight.running_score))


@pytest.mark.parametrize("override", ["mesh_devices=2"])
def test_unported_settings_raise(override, tmp_path):
    """``mesh_devices=2``, refused until data parallelism was ported (the
    name is kept from then): ``build`` outside a group of two ranks raises,
    saying how to start them; ``run_job`` starts them and trains."""
    with pytest.raises(RuntimeError, match="start it through mjrl_tpu_torch.train.run_job"):
        build(load_config(HOPPER, [override]), device="cpu")
    agent = run_job(load_config(HOPPER, [override, "num_traj=4", "horizon=4", "niter=1"]),
                    str(tmp_path), device="cpu")
    assert agent.iteration == 1 and agent.num_traj == 4
    (row,) = _rows(str(tmp_path / "logs" / "log.csv"))
    assert all(math.isfinite(float(v)) for v in row.values()), row


@pytest.mark.parametrize("overrides,agent_type,policy_type,env_type", [
    (("policy=\"linear\"",), "NPG", "GaussianLinear", "HopperEnv"),
    (("algorithm=\"reinforce\"", "agent_kwargs={}"), "BatchREINFORCE", "GaussianMLP", "HopperEnv"),
    (("algorithm=\"model_npg\"",), "ModelAccelNPG", "GaussianMLP", "HopperEnv"),
    (("env_name=\"pendulum\"",), "NPG", "GaussianMLP", "PendulumEnv"),
], ids=["linear", "reinforce", "model_npg", "pendulum"])
def test_formerly_unported_settings_build(overrides, agent_type, policy_type, env_type):
    """The settings refused until model-based NPG and the breadth items
    were ported build on the CPU, with the agent, policy and env they
    name."""
    env, policy, _, agent = build(load_config(HOPPER, list(overrides)), device="cpu")
    assert (type(agent).__name__, type(policy).__name__, type(env).__name__) == \
        (agent_type, policy_type, env_type)
    if agent_type == "ModelAccelNPG":
        assert agent.dynamics.K == 4 and agent.img_traj == 256 and agent.img_horizon == 1000


DEMOS = "demo_file=\"demos/hopper_expert.pickle\""


@pytest.mark.parametrize("overrides", [
    ("algorithm=\"dapg\"", DEMOS), ("evaluation_rollouts=1",),
    ("baseline=\"quadratic\"", "baseline_kwargs={}"), ("bc_init=true", DEMOS),
    ("init_policy_from=\"runs/x\"",), (DEMOS,),
])
def test_formerly_refused_settings_build(overrides):
    """The settings refused until BC, DAPG, the warm starts, the evaluation
    rollouts and the least-squares baselines were ported now build (the
    warm starts themselves run in ``run_job``); DAPG without demos raises
    as in the reference."""
    env, policy, baseline, agent = build(load_config(HOPPER, list(overrides)), device="cpu")
    assert type(baseline).__name__ == ("QuadraticBaseline" if "quadratic" in overrides[0]
                                       else "MLPBaseline")
    if "dapg" in overrides[0]:
        assert type(agent).__name__ == "DAPG" and agent.demo_batch.num_envs == 9
        with pytest.raises(ValueError, match="demo_file"):
            build(load_config(HOPPER, [overrides[0]]), device="cpu")


# the example configs the port runs and no other test drives through the
# entry point (hopper, hopper Newton, swimmer, walker2d TRPO and the two
# humanoid configs of the slice have theirs)
OTHER_CONFIGS = ("ant_npg.json", "ant_npg_newton.json", "ant_npg_newton1.json",
                 "ant_npg_newton_fast.json", "ant_npg_newton_samples.json",
                 "half_cheetah_trpo.json", "walker2d_trpo_newton.json", "ant_ppo.json",
                 "ant_ppo2.json", "ant_ppo3.json", "ant_ppo_v5.json", "humanoid_ppo.json",
                 "humanoid_ppo3.json", "adroit_pen_npg.json", "adroit_pen_npg_small.json")


@pytest.mark.parametrize("name", OTHER_CONFIGS)
def test_cli_runs_each_other_config_at_a_tiny_width(tmp_path, name):
    """One iteration of 2 envs x 2 steps (samples mode: 4 samples) of the
    config through ``run_job``, every logged value finite."""
    path = os.path.join(ROOT, "examples", name)
    small = ["num_traj=2", "horizon=2", "niter=1", "save_freq=1"]
    if RunConfig.from_json(path).sample_mode == "samples":
        small.append("num_samples=4")
    config = load_config(path, small)
    agent = run_job(config, str(tmp_path), device="cpu")
    assert agent.iteration == 1 and type(agent).__name__ == config.algorithm.upper()
    assert agent.env.model.constraint_solver == config.env_kwargs.get("constraint_solver", "penalty")
    (row,) = _rows(str(tmp_path / "logs" / "log.csv"))
    assert all(math.isfinite(float(v)) for v in row.values()), row


# driven through the entry point by tests/test_torch_adroit_newton.py
NEWTON_PEN = ("adroit_pen_npg_newton.json",)
# door, hammer and relocate NPG: built by tests/test_torch_adroit_entry.py
# (and door's small config driven through the entry point there)
OTHER_TASKS = ("adroit_door_npg.json", "adroit_door_npg_small.json",
               "adroit_hammer_curr.json", "adroit_hammer_npg.json", "adroit_hammer_npg2.json",
               "adroit_hammer_npg3.json", "adroit_hammer_npg_small.json",
               "adroit_relocate_curr.json", "adroit_relocate_scratch.json")


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "examples", "adroit_*.json"))
    if os.path.basename(p) not in OTHER_CONFIGS + NEWTON_PEN + OTHER_TASKS))
def test_other_adroit_configs_raise(name):
    """The Adroit DAPG configs, which raised naming their ROADMAP item until
    DAPG was ported (the name is kept from then), build a DAPG agent with
    their 25 demos on the env's device and a BC warm start configured;
    tests/test_torch_dapg.py drives each through the entry point."""
    config = load_config(os.path.join(ROOT, "examples", name), [])
    env, _, _, agent = build(config, device="cpu")
    assert type(agent).__name__ == "DAPG" and config.bc_init
    assert agent.demo_batch.num_envs == 25 and agent.demo_batch.observations.device == env.device
    assert agent.demo_batch.observations.shape[-1] == env.spec.observation_dim


@pytest.mark.parametrize("name", ["humanoid_ppo_v4.json", "humanoid_trpo.json"])
def test_cli_runs_the_humanoid_configs_with_obs_norm(tmp_path, name):
    """The slice's two humanoid configs, one iteration at a small width
    (``--set`` overrides of the envs, steps and widths): the policy's input
    normalization comes from the obs_norm rollout, every logged value is
    finite, and a resumed run keeps the checkpoint's normalization."""
    path = os.path.join(ROOT, "examples", name)
    small = ["num_traj=3", "num_samples=12", "horizon=5", "hidden_sizes=[8,8]",
             "baseline_kwargs.hidden_sizes=[8,8]", "save_freq=1"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "mjrl_tpu_torch.train", "--device", "cpu", "--config", path,
           "--output", str(tmp_path), "--set", *small, "niter=1"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (row,) = _rows(str(tmp_path / "logs" / "log.csv"))
    assert all(math.isfinite(float(v)) for v in row.values()), row
    state = CheckpointManager(str(tmp_path)).restore(1)
    shift, scale = state["policy"]["mlp.in_shift"], state["policy"]["mlp.in_scale"]
    assert shift.shape == (376,) and shift.abs().max() > 0.1 and (scale != 1.0).any()
    assert float(scale.min()) == pytest.approx(1e-2)  # constant channels: the floor
    agent = run_job(load_config(path, [*small, "niter=2"]), str(tmp_path), device="cpu")
    assert agent.iteration == 2
    torch.testing.assert_close(agent.policy.mlp.in_shift, shift, rtol=0, atol=0)
    if name == "humanoid_ppo_v4.json":
        assert agent.lr_anneal_iters == 600 and agent.optimizer.state  # Adam resumed


def test_cuda_run_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_job(load_config(HOPPER, SMALL), str(tmp_path / "job"))
    assert not (tmp_path / "job").exists()
