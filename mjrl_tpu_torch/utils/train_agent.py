"""The training loop: train steps, logging, best-policy tracking, checkpoints
and resume.

Twin of ``mjrl_tpu/utils/train_agent.py``. Each iteration runs
``agent.train_step`` with a generator on the env's device seeded from
``seed`` and the iteration, so a resumed run draws the noise the straight
run would have drawn; reads the metrics back in one transfer; logs them
with ``iteration``, ``time_step`` (seconds, ending in that read),
``steps_per_sec`` (valid env-steps per second) and ``total_env_steps``;
with ``evaluation_rollouts`` runs that many full episodes in eval mode
(the policy mean, at ``agent.horizon``) after each step, from a generator
seeded by ``iteration_seed(seed, 10_000_000 + i)``, and logs their mean
score as ``eval_score``; keeps a snapshot of the best state by
``eval_score`` where there is one, else by running score; and every
``save_freq`` iterations (and at the last) writes a checkpoint, the best
state and ``log.csv``. A run continues from the latest checkpoint in
``job_name``, with the log cut to match.

Left out against the reference: the training-curve plots (the card's
machine has no matplotlib; ``utils/plots.make_train_plots`` draws them
from a run's ``log.csv`` on the CPU afterwards), the tabulate table (nor
tabulate; a plain line is printed), and the retry loop around a failed step: a CUDA
error in PyTorch poisons the context, so a retry in the same process
would hide it rather than recover.
A crashed run resumes from its latest checkpoint when started again.

Under data parallelism (``parallel/dist.py``) every rank runs this loop on
its own rows with the same generators; the metrics are all-reduced, so
every rank takes the same decisions. Rank 0 alone writes the log and the
checkpoints and prints; every rank restores from the checkpoint on resume
(each reads it before its first collective, and rank 0 cannot write a
newer one before that); at each checkpoint the ranks' replicated state is
held bit for bit (``dist.check_replicated``).
"""

from __future__ import annotations

import copy
import math
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from mjrl_tpu_torch.algos.base import BatchREINFORCE
from mjrl_tpu_torch.parallel import dist
from mjrl_tpu_torch.samplers.rollout import rollout_statistics, sample_episodes
from mjrl_tpu_torch.utils.checkpoint import CheckpointManager
from mjrl_tpu_torch.utils import trace
from mjrl_tpu_torch.utils.logger import DataLog


def iteration_seed(seed: int, iteration: int) -> int:
    """The generator seed of one iteration of a run."""
    return int(np.random.SeedSequence([seed, iteration]).generate_state(1)[0])


def replicated_tensors(state: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tensors of an agent's ``state_dict()`` that every rank holds
    alike, by dotted name: all but the sampler carry's rows."""
    out = {}
    for k, v in state.items():
        name = f"{prefix}{k}"
        if isinstance(v, torch.Tensor):
            out[name] = v
        elif isinstance(v, dict) and k != "sampler_carry":
            out.update(replicated_tensors(v, name + "."))
    return out


def train_agent(job_name: str, agent: BatchREINFORCE, seed: int = 0, niter: int = 101,
                save_freq: int = 10, evaluation_rollouts: int = 0) -> BatchREINFORCE:
    main = dist.is_main()
    logdir = os.path.join(job_name, "logs")
    if main:
        os.makedirs(job_name, exist_ok=True)
    logger = DataLog(logdir if main else None)
    ckpt = CheckpointManager(job_name, create=main)
    device = agent.env.device

    start_iter = 0
    restored = ckpt.restore_latest(map_location=device)
    if restored is not None:
        agent.load_state_dict(restored)
        start_iter = agent.iteration
        if main:
            print(f"Resuming {job_name} from iteration {start_iter}")
        # reload the earlier rows, so save_log keeps them
        prev_csv = os.path.join(logdir, "log.csv")
        if main and os.path.exists(prev_csv):
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
        values = trace.host_read("train_agent.metrics", torch.stack(
            [v.detach().float().reshape(()) for v in metrics.values()]))
        t_step = time.perf_counter() - t0

        row = dict(zip(metrics, values))
        row["iteration"] = i
        row["time_step"] = t_step
        row["steps_per_sec"] = row.get("num_samples", 0.0) / max(t_step, 1e-9)
        total_env_steps += row.get("num_samples", 0.0)
        row["total_env_steps"] = total_env_steps
        if evaluation_rollouts > 0:
            eval_gen = torch.Generator(device=device).manual_seed(
                iteration_seed(seed, 10_000_000 + i))
            with trace.span("evaluation"):
                batch = sample_episodes(agent.env, agent.policy, evaluation_rollouts,
                                        agent.horizon, eval_gen, eval_mode=True)
                row["eval_score"] = trace.host_read("train_agent.eval_score",
                                                    rollout_statistics(batch).mean)
        logger.log_dict(row)

        perf = row.get("eval_score", row["running_score"])
        if perf > best_perf:
            best_perf = perf
            best_state = copy.deepcopy(agent.state_dict())  # stays on the device

        if i % save_freq == 0 or i == niter - 1:
            state = agent.state_dict()
            dist.check_replicated(replicated_tensors(state))
            if main:
                ckpt.save(i + 1, state)
                if best_state is not None:
                    ckpt.save_best(best_state)
                logger.save_log(logdir)
            best_state = None

        if main:
            print(f"iter {i}: " + " ".join(f"{k}={v:.4f}" for k, v in sorted(row.items())))

    if main:
        logger.save_log(logdir)
    logger.close()
    return agent
