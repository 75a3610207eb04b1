"""The port's entry point, ``python -m mjrl_tpu_torch.train``, on the CPU.

Hopper NPG from ``examples/hopper_npg.json`` cut to 4 envs x 20 steps:
the CLI writes ``config.json``, a ``log.csv`` with every column of the JAX
package's hopper run (``runs/hopper_npg_expert/logs/log.csv``) and
checkpoints; a resumed run continues at the checkpoint's iteration with
the log cut to match and ends with the policy of a straight run; settings
the port does not have raise; and a run on the card never falls back to
the CPU.
"""

import csv
import glob
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


@pytest.mark.parametrize("override", [
    "algorithm=\"trpo\"", "evaluation_rollouts=1", "policy=\"linear\"", "baseline=\"quadratic\"",
    "bc_init=true", "init_policy_from=\"runs/x\"", "obs_norm=true", "mesh_devices=2",
])
def test_unported_settings_raise(override):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build(load_config(HOPPER, [override]), device="cpu")


def test_cuda_run_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_job(load_config(HOPPER, SMALL), str(tmp_path / "job"))
    assert not (tmp_path / "job").exists()
