"""Typed run configs and the factory: config -> env, policy, baseline, agent.

Twin of ``mjrl_tpu/utils/configs.py``. ``RunConfig`` has the reference's
fields, names and defaults, so every ``examples/*.json`` parses and a run's
``config.json`` diffs field for field against the JAX package's. ``build``
makes REINFORCE, NPG, TRPO, PPO, DAPG (with the demos of ``demo_file``) or
model-based NPG with a ``GaussianMLP`` or ``GaussianLinear`` policy and any
of the four baselines, on the env's device.
The warm starts, applied by ``train.run_job`` in this order:
``policy_warm_start`` (``init_policy_from``: another run's latest policy
and baseline), ``warm_start`` (``bc_init``: BC on the demos) and
``obs_norm_init`` (``obs_norm``). ``mesh_devices: D > 1`` builds one rank
of D in a ``torch.distributed`` group (``parallel/dist.py``), which
``train.run_job`` starts or joins; ``build`` outside such a group raises.
An unknown algorithm, policy, baseline or env raises ``KeyError``, as in
the reference; no setting is ignored.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from mjrl_tpu_torch import envs
from mjrl_tpu_torch.algos import BC, DAPG, NPG, PPO, TRPO, ModelAccelNPG
from mjrl_tpu_torch.algos.base import BatchREINFORCE
from mjrl_tpu_torch.models import (
    GaussianLinear,
    GaussianMLP,
    LinearBaseline,
    MLPBaseline,
    QuadraticBaseline,
    ZeroBaseline,
)
from mjrl_tpu_torch.parallel import dist
from mjrl_tpu_torch.samplers import init_autoreset_carry, sample_autoreset, sample_episodes
from mjrl_tpu_torch.utils.checkpoint import CheckpointManager
from mjrl_tpu_torch.utils import trace
from mjrl_tpu_torch.utils.demos import load_demo_pickle


@dataclasses.dataclass
class RunConfig:
    """One training run. Field names follow the reference's hyperparameters."""

    env_name: str = "point_mass"
    env_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    algorithm: str = "npg"
    seed: int = 0
    niter: int = 100
    # policy
    policy: str = "mlp"
    hidden_sizes: Tuple[int, ...] = (64, 64)
    init_log_std: float = 0.0
    min_log_std: float = -3.0
    # baseline
    baseline: str = "quadratic"
    baseline_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # sampling
    num_traj: int = 64
    num_samples: Optional[int] = None
    sample_mode: str = "trajectories"
    horizon: Optional[int] = None
    # algorithm hyperparameters (reference names)
    gamma: float = 0.995
    gae_lambda: Optional[float] = 0.97
    agent_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # demonstrations (DAPG, BC warm start)
    demo_file: Optional[str] = None
    bc_init: bool = False
    bc_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # warm start from another run's latest checkpoint
    init_policy_from: Optional[str] = None
    # observation normalization from a random-policy rollout at init
    obs_norm: bool = False
    # parallelism: shard the env axis over this many ranks (0 = single)
    mesh_devices: int = 0
    # harness
    save_freq: int = 10
    evaluation_rollouts: int = 0
    plot_keys: Tuple[str, ...] = ("stoc_pol_mean", "running_score")

    def to_json(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, default=list)

    @classmethod
    def from_json(cls, path: str) -> "RunConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "RunConfig":
        unknown = set(raw) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"Unknown config keys: {sorted(unknown)}")
        cfg = cls(**raw)
        for name in ("hidden_sizes", "plot_keys"):
            setattr(cfg, name, tuple(getattr(cfg, name)))
        return cfg


AGENTS = {"reinforce": BatchREINFORCE, "npg": NPG, "trpo": TRPO, "ppo": PPO, "dapg": DAPG,
          "model_npg": ModelAccelNPG}
BASELINES = {"zero": ZeroBaseline, "linear": LinearBaseline, "quadratic": QuadraticBaseline,
             "mlp": MLPBaseline}
POLICIES = {"mlp": GaussianMLP, "linear": GaussianLinear}


def check_group(cfg: RunConfig) -> None:
    """Raise unless this process is one of ``mesh_devices`` ranks of a
    ``torch.distributed`` group (or, for 0 or 1, in none), each with at
    least one of the ``num_traj`` rows and of the evaluation episodes."""
    ranks = max(cfg.mesh_devices, 1)
    if dist.world_size() != ranks:
        raise RuntimeError(
            f"mesh_devices={cfg.mesh_devices} trains as {ranks} rank(s) of one torch.distributed "
            f"group and this process is in a group of {dist.world_size()}: start it through "
            f"mjrl_tpu_torch.train.run_job or python -m mjrl_tpu_torch.train, which start "
            f"the ranks, or under torchrun --nproc-per-node {ranks} -m mjrl_tpu_torch.train")
    if cfg.num_traj < ranks or 0 < cfg.evaluation_rollouts < ranks:
        raise ValueError(f"num_traj={cfg.num_traj} and evaluation_rollouts="
                         f"{cfg.evaluation_rollouts} must give each of the {ranks} ranks a row")


def build(cfg: RunConfig, device="cuda"):
    """``(env, policy, baseline, agent)`` from a config, on ``device``. The
    policy's and the MLP baseline's initial weights come from ``cfg.seed``;
    ``demo_file``'s demos are loaded onto the env's device. With
    ``mesh_devices > 1``, this rank's (see :func:`check_group`)."""
    check_group(cfg)
    env = envs.make(cfg.env_name, device=device, **cfg.env_kwargs)
    demo_batch = None
    if cfg.demo_file is not None:
        demo_batch = load_demo_pickle(cfg.demo_file, device=env.device)
    init = torch.Generator().manual_seed(cfg.seed)
    policy_kwargs = dict(min_log_std=cfg.min_log_std, init_log_std=cfg.init_log_std,
                         generator=init)
    if cfg.policy == "mlp":
        policy_kwargs["hidden_sizes"] = cfg.hidden_sizes
    policy = POLICIES[cfg.policy](env.spec, **policy_kwargs).to(env.device)
    baseline_kwargs = dict(cfg.baseline_kwargs)
    if cfg.baseline == "mlp":
        baseline_kwargs["generator"] = init
    baseline = BASELINES[cfg.baseline](env.spec, **baseline_kwargs).to(env.device)
    agent_kwargs = dict(cfg.agent_kwargs)
    if cfg.algorithm == "dapg":
        if demo_batch is None:
            raise ValueError("algorithm 'dapg' requires demo_file")
        agent_kwargs["demo_batch"] = demo_batch
    if cfg.algorithm == "model_npg":
        agent_kwargs["generator"] = init  # the ensemble's initial weights
    agent = AGENTS[cfg.algorithm](
        env, policy, baseline, num_traj=cfg.num_traj, num_samples=cfg.num_samples,
        sample_mode=cfg.sample_mode, horizon=cfg.horizon, gamma=cfg.gamma,
        gae_lambda=cfg.gae_lambda, **agent_kwargs)
    return env, policy, baseline, agent


def policy_warm_start(cfg: RunConfig, agent: BatchREINFORCE) -> None:
    """Load the policy (parameters and buffers) and the baseline (its state
    and its optimizer's) of ``cfg.init_policy_from``'s latest checkpoint
    into a fresh agent; the architectures must match. Iteration, running
    score and sampler carry stay fresh, so the run's metrics are its own."""
    src = CheckpointManager(cfg.init_policy_from, create=False)
    restored = src.restore_latest(map_location=agent.env.device)
    if restored is None:
        raise FileNotFoundError(f"init_policy_from: no checkpoint under {cfg.init_policy_from}")
    if dist.is_main():
        print(f"Policy warm start from {cfg.init_policy_from} iteration "
              f"{int(restored['iteration'])}")
    agent.load_policy_and_baseline(restored)


def warm_start(cfg: RunConfig, agent: BatchREINFORCE,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """BC on ``demo_file``'s demos (DAPG's stage 1), from the agent's
    current policy; returns BC's ``loss_before`` and ``loss_after``."""
    if cfg.demo_file is None:
        raise ValueError("bc_init requires demo_file")
    with trace.span("bc.warm_start"):
        demos = load_demo_pickle(cfg.demo_file, device=agent.env.device)
        metrics = BC(demos, agent.policy, **cfg.bc_kwargs).train(generator)
    if dist.is_main():
        before, after = trace.host_read(
            "bc.loss", torch.stack([metrics["loss_before"], metrics["loss_after"]]))
        print(f"BC warm start: loss {before:.6g} -> {after:.6g}")
    return metrics


@torch.no_grad()
def obs_norm_init(agent: BatchREINFORCE, generator: Optional[torch.Generator] = None,
                  scale_min: float = 1e-2) -> None:
    """Set the policy's ``in_shift`` / ``in_scale`` to the mean and the
    std (at least ``scale_min``, for constant channels) of the observations
    of one batch of the initial policy, over its valid steps. The batch
    comes from the agent's sampler with a fresh reset: a samples-mode
    agent's persistent carry is untouched. One-shot statistics, not running
    ones, keep the policy fixed for the on-policy ratios. Over every rank's
    rows."""
    env, policy = agent.env, agent.policy
    if agent.sample_mode == "trajectories":
        batch = sample_episodes(env, policy, agent.num_traj, agent.horizon, generator)
    else:
        carry = init_autoreset_carry(env, agent.num_traj, generator)
        window = -(-int(agent.num_samples) // agent.num_traj)
        batch, _ = sample_autoreset(env, policy, carry, window, agent.horizon, generator)
    obs = batch.observations.reshape(-1, batch.observations.shape[-1])
    w = batch.valid.reshape(-1).to(obs.dtype)[:, None]
    sums = dist.all_sum_dict({"n": w.sum(), "obs": (obs * w).sum(0)})
    n = torch.clamp(sums["n"], min=1.0)
    mean = sums["obs"] / n
    var = dist.all_sum((torch.square(obs - mean) * w).sum(0)) / n
    policy.mlp.in_shift.copy_(mean)
    policy.mlp.in_scale.copy_(torch.clamp(torch.sqrt(var), min=scale_min))
