"""Typed run configs and the factory: config -> env, policy, baseline, agent.

Twin of ``mjrl_tpu/utils/configs.py``. ``RunConfig`` has the reference's
fields, names and defaults, so every ``examples/*.json`` parses and a run's
``config.json`` diffs field for field against the JAX package's. ``build``
makes what the port has: NPG with a ``GaussianMLP`` policy and an
``MLPBaseline``, on the env's device. Every other choice raises
``NotImplementedError`` naming the ROADMAP item that ports it; none is
ignored.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from mjrl_tpu_torch import envs
from mjrl_tpu_torch.algos import NPG
from mjrl_tpu_torch.models import GaussianMLP, MLPBaseline


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


def check_ported(cfg: RunConfig) -> None:
    """Raise ``NotImplementedError`` for a setting the port does not have."""
    unported = [
        (cfg.algorithm != "npg", f"algorithm {cfg.algorithm!r}", "queue 1 item 12"),
        (cfg.policy != "mlp", f"policy {cfg.policy!r}", "queue 1 item 3"),
        (cfg.baseline != "mlp", f"baseline {cfg.baseline!r}", "queue 1 item 3"),
        (cfg.demo_file is not None or cfg.bc_init, "demo_file / bc_init (BC, DAPG)",
         "queue 1 item 12"),
        (cfg.init_policy_from is not None or cfg.obs_norm, "init_policy_from / obs_norm",
         "queue 1 item 9, warm starts"),
        (cfg.mesh_devices > 1, "mesh_devices > 1", "queue 1 item 15"),
        (cfg.evaluation_rollouts > 0, "evaluation_rollouts > 0",
         "queue 1 item 9, evaluation rollouts"),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def build(cfg: RunConfig, device="cuda"):
    """``(env, policy, baseline, agent)`` from a config, on ``device``. The
    policy's and baseline's initial weights come from ``cfg.seed``."""
    check_ported(cfg)
    env = envs.make(cfg.env_name, device=device, **cfg.env_kwargs)
    init = torch.Generator().manual_seed(cfg.seed)
    policy = GaussianMLP(env.spec, hidden_sizes=cfg.hidden_sizes, min_log_std=cfg.min_log_std,
                         init_log_std=cfg.init_log_std, generator=init).to(env.device)
    baseline = MLPBaseline(env.spec, generator=init, **cfg.baseline_kwargs).to(env.device)
    agent = NPG(env, policy, baseline, num_traj=cfg.num_traj, num_samples=cfg.num_samples,
                sample_mode=cfg.sample_mode, horizon=cfg.horizon, gamma=cfg.gamma,
                gae_lambda=cfg.gae_lambda, **cfg.agent_kwargs)
    return env, policy, baseline, agent
