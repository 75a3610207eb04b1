"""CLI: ``python -m mjrl_tpu_torch.train --config <cfg.json> --output <dir>``.

Twin of ``mjrl_tpu/train.py``: builds the env, policy, baseline and agent
from a JSON config (the same ``examples/*.json``) and trains into
``--output``, resuming from its latest checkpoint. ``--set key=value``
overrides a field (JSON-parsed; dotted keys reach into dict fields, e.g.
``env_kwargs.n_substeps=1``). A fresh run first applies the warm starts
of ``utils.configs`` in the reference's order: ``init_policy_from``
(``policy_warm_start``), then ``bc_init`` (``warm_start``: BC on the
demos), then ``obs_norm`` (``obs_norm_init``, which overwrites BC's input
transforms as in the reference); a run that resumes from its own
checkpoint skips all three and keeps its checkpoint's state.
The run is on the card (``--device cuda``, the default) unless ``--device
cpu`` is asked for; without a card a CUDA run fails and never falls back
to the CPU.

``--trace PATH`` turns the program's tracer on (``utils/trace.py``) and
writes every span and device read of the run to PATH as Chrome trace JSON
(``chrome://tracing``, Perfetto): each iteration's ``train_step`` with its
phases (the rollout's control steps, policy, env and physics; the update's
CG; the fit's Adam steps; model-based NPG's ensemble fit and imagined
rollout), BC's warm start and the evaluation rollouts. It holds every span
in memory, so trace a few iterations; one process only.

``mesh_devices: D > 1`` trains as D ranks (``parallel/dist.py``), each with
a block of the env rows. Under ``torchrun`` (``WORLD_SIZE`` set, and equal
to D) this process is one rank and joins the group torchrun set up; else
``run_job`` starts D ranks on this host (``torch.multiprocessing``'s
``spawn``) that meet through a file in a temporary directory. Rank r runs on
``cuda:(r % device_count)`` (or the CPU): NCCL when each rank has a card of
its own, gloo when ranks share a card or run on the CPU. Rank 0 writes the
config, log and checkpoints; a rank that fails stops the run.

    python -m mjrl_tpu_torch.train --config examples/hopper_npg.json --output runs/hopper
    python -m mjrl_tpu_torch.train --config examples/adroit_pen_npg_newton.json \
        --output runs/pen --set niter=3 --trace runs/pen/trace.json
    torchrun --nproc-per-node 2 -m mjrl_tpu_torch.train --config examples/humanoid_ppo_v4.json \
        --output runs/hppo --set mesh_devices=2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from mjrl_tpu_torch.algos.base import BatchREINFORCE
from mjrl_tpu_torch.parallel import dist
from mjrl_tpu_torch.utils import trace
from mjrl_tpu_torch.utils.checkpoint import CheckpointManager
from mjrl_tpu_torch.utils.configs import (
    RunConfig,
    build,
    obs_norm_init,
    policy_warm_start,
    warm_start,
)
from mjrl_tpu_torch.utils.train_agent import train_agent


def side_generator(seed: int, key: int, device) -> torch.Generator:
    """A generator of its own for a warm start, apart from the iterations'
    (``train_agent``): the twin of the reference's ``fold_in(PRNGKey(seed),
    key)`` (1: BC, 2: obs_norm)."""
    state = np.random.SeedSequence(seed, spawn_key=(key,)).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def run_job(cfg: RunConfig, output: str, device="cuda") -> BatchREINFORCE:
    """Train ``cfg`` into ``output`` on ``device``; returns the agent. With
    ``mesh_devices > 1`` outside a group, the ranks run in processes of
    their own and the agent returned is the run's last checkpoint, loaded
    into a single-rank agent on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU")
    if cfg.mesh_devices > 1 and dist.world_size() == 1:
        if "WORLD_SIZE" in os.environ:  # one rank of torchrun's group
            world, r = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
            local = int(os.environ.get("LOCAL_RANK", r))
            dist.init_group(r, world, dist.rank_device(device, local), "env://")
            try:
                return run_job(cfg, output, dist.rank_device(device, local))
            finally:
                dist.shutdown()
        dist.spawn(_run_rank, cfg.mesh_devices, device, (cfg, output))
        single = dataclasses.replace(cfg, mesh_devices=0)
        _, _, _, agent = build(single, device=device)
        agent.load_state_dict(CheckpointManager(output, create=False).restore_latest(
            map_location=device))
        return agent
    if dist.is_main():
        cfg.to_json(os.path.join(output, "config.json"))
    _, _, _, agent = build(cfg, device=device)
    if CheckpointManager(output, create=False).latest_step() is None:
        if cfg.init_policy_from:
            policy_warm_start(cfg, agent)
        if cfg.bc_init:
            warm_start(cfg, agent, side_generator(cfg.seed, 1, device))
        if cfg.obs_norm:
            obs_norm_init(agent, side_generator(cfg.seed, 2, device))
    return train_agent(output, agent, seed=cfg.seed, niter=cfg.niter, save_freq=cfg.save_freq,
                       evaluation_rollouts=cfg.evaluation_rollouts)


def _run_rank(device: torch.device, cfg: RunConfig, output: str) -> None:
    """One rank of a run that ``run_job`` spawned."""
    run_job(cfg, output, device)


def load_config(config_path=None, overrides=()) -> RunConfig:
    raw = {}
    if config_path:
        with open(config_path) as f:
            raw = json.load(f)
    for kv in overrides:
        k, _, v = kv.partition("=")
        try:
            val = json.loads(v)
        except json.JSONDecodeError:
            val = v
        # dotted paths override inside dict-valued fields
        node, parts = raw, k.split(".")
        for i, part in enumerate(parts[:-1]):
            if node.get(part) is None:
                node[part] = {}
            node = node[part]
            if not isinstance(node, dict):
                raise SystemExit(f"cannot apply override {k!r}: {'.'.join(parts[: i + 1])!r} "
                                 f"is {type(node).__name__}, not a dict")
        node[parts[-1]] = val
    return RunConfig.from_dict(raw)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="mjrl_tpu_torch policy optimization job")
    p.add_argument("--output", required=True, help="job directory")
    p.add_argument("--config", default=None, help="JSON config path")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="config overrides, JSON-parsed values (e.g. niter=50)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="trace the run (utils/trace.py) and write its host spans and device "
                        "reads to PATH as Chrome trace JSON")
    args = p.parse_args(argv)
    cfg = load_config(args.config, args.set)
    if args.trace is None:
        run_job(cfg, args.output, device=args.device)
        return
    if cfg.mesh_devices > 1:
        raise SystemExit("--trace traces one process: run it without mesh_devices > 1")
    trace.enable()
    try:
        run_job(cfg, args.output, device=args.device)
    finally:
        trace.disable()
        trace.write_chrome(args.trace)


if __name__ == "__main__":
    main()
