"""Typed run configs and the factory: config -> env, policy, baseline, agent.

Twin of ``mjrl_tpu/utils/configs.py``. ``RunConfig`` has the reference's
fields, names and defaults, so every ``examples/*.json`` parses and a run's
``config.json`` diffs field for field against the JAX package's. ``build``
makes what the port has: NPG, TRPO or PPO with a ``GaussianMLP`` policy and
an ``MLPBaseline``, on the env's device; ``obs_norm_init`` sets the
policy's input normalization for ``obs_norm``. Every other choice raises
``NotImplementedError`` naming, by its title, the ROADMAP item that ports
it; none is ignored.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from mjrl_tpu_torch import envs
from mjrl_tpu_torch.algos import NPG, PPO, TRPO
from mjrl_tpu_torch.algos.base import BatchREINFORCE
from mjrl_tpu_torch.models import GaussianMLP, MLPBaseline
from mjrl_tpu_torch.samplers import init_autoreset_carry, sample_autoreset, sample_episodes


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
    # parallelism: shard the env axis over this many devices (0 = single)
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


AGENTS = {"npg": NPG, "trpo": TRPO, "ppo": PPO}

# the titles of ROADMAP.md's queue 1 items that port what the port lacks
BC_DAPG = "BC, DAPG, demos, warm starts and evaluation rollouts"
BREADTH = "Breadth without kernels"
MODEL_NPG = "Model-based NPG"
DATA_PARALLEL = "Env-axis data parallel"
_ALGORITHM_ITEMS = {"bc": BC_DAPG, "dapg": BC_DAPG, "model_npg": MODEL_NPG}


def check_ported(cfg: RunConfig) -> None:
    """Raise ``NotImplementedError`` for a setting the port does not have."""
    unported = [
        (cfg.algorithm not in AGENTS, f"algorithm {cfg.algorithm!r}",
         _ALGORITHM_ITEMS.get(cfg.algorithm, BREADTH)),
        (cfg.policy != "mlp", f"policy {cfg.policy!r}", BREADTH),
        (cfg.baseline != "mlp", f"baseline {cfg.baseline!r}", BREADTH),
        (cfg.demo_file is not None or cfg.bc_init, "demo_file / bc_init (BC, DAPG)", BC_DAPG),
        (cfg.init_policy_from is not None, "init_policy_from", BC_DAPG),
        (cfg.mesh_devices > 1, "mesh_devices > 1", DATA_PARALLEL),
        (cfg.evaluation_rollouts > 0, "evaluation_rollouts > 0", BC_DAPG),
    ]
    for bad, what, title in unported:
        if bad:
            raise NotImplementedError(f'{what} is not ported yet (ROADMAP queue 1, "{title}")')


def build(cfg: RunConfig, device="cuda"):
    """``(env, policy, baseline, agent)`` from a config, on ``device``. The
    policy's and baseline's initial weights come from ``cfg.seed``."""
    check_ported(cfg)
    env = envs.make(cfg.env_name, device=device, **cfg.env_kwargs)
    init = torch.Generator().manual_seed(cfg.seed)
    policy = GaussianMLP(env.spec, hidden_sizes=cfg.hidden_sizes, min_log_std=cfg.min_log_std,
                         init_log_std=cfg.init_log_std, generator=init).to(env.device)
    baseline = MLPBaseline(env.spec, generator=init, **cfg.baseline_kwargs).to(env.device)
    agent = AGENTS[cfg.algorithm](
        env, policy, baseline, num_traj=cfg.num_traj, num_samples=cfg.num_samples,
        sample_mode=cfg.sample_mode, horizon=cfg.horizon, gamma=cfg.gamma,
        gae_lambda=cfg.gae_lambda, **cfg.agent_kwargs)
    return env, policy, baseline, agent


@torch.no_grad()
def obs_norm_init(agent: BatchREINFORCE, generator: Optional[torch.Generator] = None,
                  scale_min: float = 1e-2) -> None:
    """Set the policy's ``in_shift`` / ``in_scale`` to the mean and the
    std (at least ``scale_min``, for constant channels) of the observations
    of one batch of the initial policy, over its valid steps. The batch
    comes from the agent's sampler with a fresh reset: a samples-mode
    agent's persistent carry is untouched. One-shot statistics, not running
    ones, keep the policy fixed for the on-policy ratios."""
    env, policy = agent.env, agent.policy
    if agent.sample_mode == "trajectories":
        batch = sample_episodes(env, policy, agent.num_traj, agent.horizon, generator)
    else:
        carry = init_autoreset_carry(env, agent.num_traj, generator)
        window = -(-int(agent.num_samples) // agent.num_traj)
        batch, _ = sample_autoreset(env, policy, carry, window, agent.horizon, generator)
    obs = batch.observations.reshape(-1, batch.observations.shape[-1])
    w = batch.valid.reshape(-1).to(obs.dtype)[:, None]
    n = torch.clamp(w.sum(), min=1.0)
    mean = (obs * w).sum(0) / n
    var = (torch.square(obs - mean) * w).sum(0) / n
    policy.mlp.in_shift.copy_(mean)
    policy.mlp.in_scale.copy_(torch.clamp(torch.sqrt(var), min=scale_min))
