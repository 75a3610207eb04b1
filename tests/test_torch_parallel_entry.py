"""Data parallelism of the port through its configs and its entry point, on
the CPU over gloo (``mjrl_tpu_torch/parallel/dist.py``).

- hopper NPG (``examples/hopper_npg.json``, K1's plain version on the
  CPU) at 5 envs x 4 steps on two ranks, an uneven split (3 + 2 rows):
  the linear policy: each rank's rows within 1e-5 of the single-rank rows
  (see the test), the parameters the same bits on both ranks and within
  5e-3 of one rank's (see there), the metrics within 5e-3 and
  ``num_samples`` equal;
- ``examples/point_mass_model_npg.json`` at its CPU size (4 real envs x 5
  steps, 256 imagined episodes from the start pool of both ranks), with
  the linear policy: the real rows bit for bit, the ensemble and the
  policy within 1e-4 of one rank's, the metrics within 1e-3. (With the
  config's (32, 32) MLP policy the NPG step on the imagined batch is
  ill-conditioned: one rank's alpha moves by 5% when the imagined
  observations move by 1e-7, so it cannot be held closer than that.)
- ``python -m mjrl_tpu_torch.train --set mesh_devices=2`` on
  ``examples/point_mass_npg.json`` at 2 envs x 2 steps for one iteration,
  then ``run_job`` resuming it to two: its log, row by row, within 1e-4 of
  the single-rank run's (``num_samples`` equal; the second step's columns
  within 2e-2, see the test), the first checkpoint's policy within 1e-5,
  rank 0 alone writing the log, and the agent that ``run_job`` returns
  that of the last checkpoint;
- a rank that raises fails the whole run, with an error that names the
  rank, while the other waits in a collective;
- callers that want one kernel library at once compile it once (the file
  lock around ``pkernel.build_library``).
"""

import csv
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from mjrl_tpu_torch.ops.ravel import ravel
from mjrl_tpu_torch.parallel import dist
from mjrl_tpu_torch.samplers import sample_episodes
from mjrl_tpu_torch.train import load_config, run_job
from mjrl_tpu_torch.utils.checkpoint import CheckpointManager
from mjrl_tpu_torch.utils.configs import build

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
HOPPER = os.path.join(ROOT, "examples", "hopper_npg.json")
MODEL = os.path.join(ROOT, "examples", "point_mass_model_npg.json")
POINT_MASS = os.path.join(ROOT, "examples", "point_mass_npg.json")
FIELDS = ("observations", "actions", "rewards", "valid", "done", "mean", "log_std")
STEP_COLUMNS = ("alpha", "kl_dist", "surr_improvement", "VF_error_before", "VF_error_after",
                "eval_score")


def _flat(module) -> torch.Tensor:
    return ravel({k: v.detach() for k, v in module.named_parameters()})[0]


def _build(path, overrides):
    ranks = dist.world_size()
    return build(load_config(path, [*overrides, f"mesh_devices={ranks if ranks > 1 else 0}"]),
                 device="cpu")


def case_hopper():
    env, policy, _, agent = _build(HOPPER, ["num_traj=5", "horizon=4", "policy=\"linear\""])
    gen = torch.Generator().manual_seed(1)
    batch = sample_episodes(env, policy, 5, 4, gen)
    metrics = agent.finish_train_step(batch, generator=gen)
    return dict(batch={k: getattr(batch, k) for k in FIELDS}, flat=_flat(policy),
                metrics={k: float(v) for k, v in metrics.items()})


def case_model():
    env, policy, _, agent = _build(MODEL, ["num_traj=4", "horizon=5", "policy=\"linear\""])
    gen = torch.Generator().manual_seed(2)
    real = sample_episodes(env, policy, 4, 5, gen)
    metrics = agent.finish_model_step(real, gen)
    return dict(batch={k: getattr(real, k) for k in FIELDS}, flat=_flat(policy),
                dynamics=_flat(agent.dynamics), metrics={k: float(v) for k, v in metrics.items()})


def _rank_main(device, out_dir):
    torch.save(dict(hopper=case_hopper(), model=case_model()),
               os.path.join(out_dir, f"rank{dist.rank()}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    dist.spawn(_rank_main, WORLD, "cpu", (str(out),))
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return dict(hopper=case_hopper(), model=case_model()), ranks


def _blocks(x):
    return [x[slice(*dist.row_block(x.shape[0], r, WORLD))] for r in range(WORLD)]


# hopper's parameters: its rows part by up to 3.6e-7 (see the test), and
# NPG on 20 steps of nearly alike reset states is ill-conditioned: one rank's
# own step moves by 8.8e-4 when its observations move by 1e-7
@pytest.mark.parametrize("case,atol,rtol", [("hopper", 5e-3, 5e-3), ("model", 1e-4, 1e-3)])
def test_config_step_matches_one_rank(runs, case, atol, rtol):
    """The rows of each rank against one rank's: point_mass's bit for bit;
    hopper's to 1e-5, since the plain physics on the CPU is not invariant to
    the batch's size in the last bit (the same env's state parts by up to
    3.6e-7 over 4 steps between batches of 3 and 5; K1 on the card is, and
    chip_smoke.py holds its ranks' rows bit for bit)."""
    single, ranks = runs
    for name in FIELDS:
        for r, want in enumerate(_blocks(single[case]["batch"][name])):
            got = ranks[r][case]["batch"][name]
            if case == "model" or not want.is_floating_point():
                assert torch.equal(got, want), (name, r)
            else:
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5,
                                           err_msg=name)
    if case == "hopper":
        assert [ranks[r][case]["batch"]["rewards"].shape[0] for r in range(WORLD)] == [3, 2]
    for part in ("flat", "dynamics") if case == "model" else ("flat",):
        assert torch.equal(ranks[0][case][part], ranks[1][case][part]), part
        np.testing.assert_allclose(ranks[0][case][part].numpy(), single[case][part].numpy(),
                                   rtol=0, atol=atol, err_msg=part)
    got, want = ranks[0][case]["metrics"], single[case]["metrics"]
    assert got == ranks[1][case]["metrics"] and set(got) == set(want)
    assert got["num_samples"] == want["num_samples"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-5, err_msg=k)


def _rows(path):
    with open(path, newline="") as f:
        return [{k: float(v) for k, v in row.items()} for row in csv.DictReader(f)]


def test_entry_point_trains_two_ranks_and_resumes(tmp_path):
    """The CLI with ``mesh_devices=2`` for one iteration, then ``run_job``
    resuming it, against one rank's two iterations, row by row."""
    small = ["num_traj=2", "horizon=2", "save_freq=1"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "mjrl_tpu_torch.train", "--device", "cpu", "--config",
           POINT_MASS, "--output", str(tmp_path / "two"), "--set", *small, "mesh_devices=2",
           "niter=1"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("backend gloo") == 1 and proc.stdout.count("iter 0:") == 1
    two = run_job(load_config(POINT_MASS, [*small, "mesh_devices=2", "niter=2"]),
                  str(tmp_path / "two"), device="cpu")
    one = run_job(load_config(POINT_MASS, [*small, "niter=2"]), str(tmp_path / "one"),
                  device="cpu")
    assert two.iteration == one.iteration == 2
    got, want = (_rows(str(tmp_path / d / "logs" / "log.csv")) for d in ("two", "one"))
    assert len(got) == len(want) == 2 and set(got[0]) == set(want[0])
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["num_samples"] == w["num_samples"] == 4.0
        assert g["total_env_steps"] == w["total_env_steps"] and g["iteration"] == i
        for k in w:
            if k in ("time_step", "steps_per_sec"):
                continue
            # the second step: NPG's CG on the (32, 32) MLP policy and the
            # quadratic baseline's ridge solve on 4 steps turn the first
            # step's round-off (1e-7) into up to 1.5e-2 of alpha, kl_dist,
            # surr_improvement, VF_error_* and eval_score (measured; one rank
            # moves as far when its observations move by 1e-7)
            rtol = 2e-2 if i and k in STEP_COLUMNS else 1e-4
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-6, err_msg=k)
    # the first step's policy (checkpoint 1) within f32 round-off of one rank's
    first = [CheckpointManager(str(tmp_path / d), create=False).restore(1)["policy"]
             for d in ("two", "one")]
    for k, v in first[1].items():
        np.testing.assert_allclose(first[0][k].numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)
    assert sorted(os.listdir(tmp_path / "two" / "iterations")) == ["1.pt", "2.pt"]
    last = CheckpointManager(str(tmp_path / "two"), create=False).restore(2)["policy"]
    assert all(torch.equal(two.policy.state_dict()[k], v) for k, v in last.items())
    with open(tmp_path / "two" / "logs" / "log.jsonl") as f:
        assert len(f.readlines()) == 2  # rank 0 alone writes the log


def _failing_rank(device):
    if dist.rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_sum(torch.ones(1))  # waits for rank 1, which never comes


def test_a_failing_rank_fails_the_run():
    """Rank 1 raises while rank 0 waits for it in an all-reduce: the run
    raises within a minute, naming the rank whose failure it saw first
    (rank 1's error, or rank 0's all-reduce that lost its peer)."""
    t0 = time.perf_counter()
    with pytest.raises(mp.ProcessRaisedException, match="Process [01] terminated") as info:
        dist.spawn(_failing_rank, WORLD, "cpu")
    message = str(info.value)
    assert "rank 1 fails on purpose" in message or "all_reduce" in message, message
    assert time.perf_counter() - t0 < 60.0


def test_ranks_that_build_one_kernel_at_once_compile_it_once(tmp_path):
    """``pkernel.build_library`` under a file lock: four callers that ask
    for the same library at once (as the ranks of a run do at their first
    launch) run the compiler once and all load its output."""
    from concurrent.futures import ThreadPoolExecutor

    from mjrl_tpu_torch.physics.pkernel import build_library

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    log = tmp_path / "compiles"
    compiler = tmp_path / "cc.sh"  # called as: cc.sh -o OUT SOURCE
    compiler.write_text(f"#!/bin/sh\necho x >> {log}\nsleep 0.5\ncp \"$3\" \"$2\"\n")
    compiler.chmod(0o755)
    with ThreadPoolExecutor(4) as pool:
        paths = list(pool.map(lambda _: build_library("k.cu", [str(compiler)], tmp_path / "b",
                                                      csrc), range(4)))
    assert len(set(paths)) == 1 and paths[0].read_text() == "// a kernel\n"
    assert log.read_text().count("x") == 1
