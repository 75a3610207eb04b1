"""The training loop: train steps, logging, best-policy tracking, checkpoints
and resume.

Twin of ``mjrl_tpu/utils/train_agent.py``. Each iteration runs
``agent.train_step`` with a generator on the env's device seeded from
``seed`` and the iteration, so a resumed run draws the noise the straight
run would have drawn; reads the metrics back in one transfer; logs them
with ``iteration``, ``time_step`` (seconds, ending in that read),
``steps_per_sec`` (valid env-steps per second) and ``total_env_steps``;
keeps a snapshot of the best state by running score; and every
``save_freq`` iterations (and at the last) writes a checkpoint, the best
state and ``log.csv``. A run continues from the latest checkpoint in
``job_name``, with the log cut to match.

Left out against the reference: evaluation rollouts (``build`` refuses
them), the training-curve plots and the tabulate table (the card's machine
has neither matplotlib nor tabulate; a plain line is printed), and the
retry loop around a failed step: a CUDA error in PyTorch poisons the
context, so a retry in the same process would hide it rather than recover.
A crashed run resumes from its latest checkpoint when started again.
"""

from __future__ import annotations

import copy
import math
import os
import time

import numpy as np
import torch

from mjrl_tpu_torch.algos.base import BatchREINFORCE
from mjrl_tpu_torch.utils.checkpoint import CheckpointManager
from mjrl_tpu_torch.utils.logger import DataLog


def iteration_seed(seed: int, iteration: int) -> int:
    """The generator seed of one iteration of a run."""
    return int(np.random.SeedSequence([seed, iteration]).generate_state(1)[0])


def train_agent(job_name: str, agent: BatchREINFORCE, seed: int = 0, niter: int = 101,
                save_freq: int = 10) -> BatchREINFORCE:
    os.makedirs(job_name, exist_ok=True)
    logdir = os.path.join(job_name, "logs")
    logger = DataLog(logdir)
    ckpt = CheckpointManager(job_name)
    device = agent.env.device

    start_iter = 0
    restored = ckpt.restore_latest(map_location=device)
    if restored is not None:
        agent.load_state_dict(restored)
        start_iter = agent.iteration
        print(f"Resuming {job_name} from iteration {start_iter}")
        # reload the earlier rows, so save_log keeps them
        prev_csv = os.path.join(logdir, "log.csv")
        if os.path.exists(prev_csv):
            logger.read_log(prev_csv)
            logger.shrink_to(start_iter)

    best_perf, best_state = -math.inf, None
    # cumulative valid env-steps, recovered from the log on resume
    total_env_steps = 0.0
    if start_iter > 0 and logger.log.get("total_env_steps"):
        total_env_steps = float(logger.log["total_env_steps"][-1])

    for i in range(start_iter, niter):
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(iteration_seed(seed, i))
        metrics = agent.train_step(gen)
        # one device -> host transfer for all metrics; it waits for the step
        values = torch.stack([v.detach().float().reshape(()) for v in metrics.values()]).tolist()
        t_step = time.perf_counter() - t0

        row = dict(zip(metrics, values))
        row["iteration"] = i
        row["time_step"] = t_step
        row["steps_per_sec"] = row.get("num_samples", 0.0) / max(t_step, 1e-9)
        total_env_steps += row.get("num_samples", 0.0)
        row["total_env_steps"] = total_env_steps
        logger.log_dict(row)

        if row["running_score"] > best_perf:
            best_perf = row["running_score"]
            best_state = copy.deepcopy(agent.state_dict())  # stays on the device

        if i % save_freq == 0 or i == niter - 1:
            ckpt.save(i + 1, agent.state_dict())
            if best_state is not None:
                ckpt.save_best(best_state)
                best_state = None
            logger.save_log(logdir)

        print(f"iter {i}: " + " ".join(f"{k}={v:.4f}" for k, v in sorted(row.items())))

    logger.save_log(logdir)
    logger.close()
    return agent
