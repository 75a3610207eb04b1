"""The new Adroit configs through the port's entry point on the CPU, and
which example configs the port builds.

``adroit_door_npg_small.json`` runs at 4 envs x 5 steps through
``run_job`` and resumes from its checkpoint. Every ``examples/*.json``
either builds (``build``'s checks and ``envs.make``: all 39 since
model-based NPG was ported) or raises naming, by its title, the ROADMAP.md
queue item that ports what it needs (none is left).
"""

import glob
import math
import os
import re

import pytest
import torch

from mjrl_tpu_torch.train import load_config, run_job
from mjrl_tpu_torch.utils.checkpoint import CheckpointManager
from mjrl_tpu_torch.utils.configs import build

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_door_small_config_runs_and_resumes(tmp_path):
    """``adroit_door_npg_small.json`` at 4 envs x 5 steps through
    ``run_job``: one iteration, then a second resumed from its checkpoint;
    every logged value finite."""
    path = os.path.join(ROOT, "examples", "adroit_door_npg_small.json")
    small = ["num_traj=4", "horizon=5", "save_freq=1"]
    run_job(load_config(path, [*small, "niter=1"]), str(tmp_path), device="cpu")
    agent = run_job(load_config(path, [*small, "niter=2"]), str(tmp_path), device="cpu")
    assert agent.iteration == 2 and CheckpointManager(str(tmp_path)).latest_step() == 2
    with open(tmp_path / "logs" / "log.csv") as f:
        header, *rows = [line.strip().split(",") for line in f]
    assert len(rows) == 2 and all(math.isfinite(float(v)) for r in rows for v in r)
    assert "success_rate" in header


ROADMAP = open(os.path.join(ROOT, "ROADMAP.md")).read()
CONFIGS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "examples", "*.json")))
REFUSED = set()


@pytest.mark.parametrize("name", CONFIGS)
def test_config_builds_or_names_a_roadmap_title(name):
    """Each example config either builds (``build``'s checks and
    ``envs.make``) or raises naming the ROADMAP queue item that ports it,
    by a title that starts an item of that queue in ROADMAP.md."""
    config = load_config(os.path.join(ROOT, "examples", name), [])
    if name not in REFUSED:
        env = build(config, device="cpu")[0]
        assert env.spec.horizon > 0
        return
    with pytest.raises(NotImplementedError) as info:
        build(config, device="cpu")
    found = re.search(r'ROADMAP queue (\d+), "([^"]+)"', str(info.value))
    assert found, str(info.value)
    queue, title = found.groups()
    section = ROADMAP[ROADMAP.index(f"### {queue}. "):]
    section = section[: section.index("\n### ", 1)]
    assert re.search(rf"^\d+\. \*\*{re.escape(title)}", section, re.M), title


def test_port_builds_31_of_the_39_example_configs():
    """The count of example configs the port builds: 39 of 39 since
    model-based NPG was ported (the name is kept from when it was 31); the
    two model-based configs build a ``ModelAccelNPG`` with their ensemble
    and imagined batch."""
    assert len(CONFIGS) == 39 and not REFUSED and len(CONFIGS) - len(REFUSED) == 39
    for name, env_name, img in (("hopper_model_npg.json", "HopperEnv", (1024, 500)),
                                ("point_mass_model_npg.json", "PointMassEnv", (256, 25))):
        env, _, _, agent = build(load_config(os.path.join(ROOT, "examples", name), []),
                                 device="cpu")
        assert type(agent).__name__ == "ModelAccelNPG" and type(env).__name__ == env_name
        assert (agent.img_traj, agent.img_horizon) == img and agent.dynamics.K == 4
        assert agent.dynamics.hidden_sizes == (256, 256)
