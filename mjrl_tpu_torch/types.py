"""Core data types: the batched trajectory container and env specs.

Twins of ``mjrl_tpu/types.py``: a fixed-shape, mask-padded batch of
trajectories laid out env-major ``(num_envs, horizon, ...)``, here a
dataclass of tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Static env metadata: flat observation size, action size, horizon."""

    observation_dim: int
    action_dim: int
    horizon: int


@dataclasses.dataclass(frozen=True)
class TrajectoryBatch:
    """A fixed-shape batch of (possibly padded) trajectories, ``N`` envs by
    ``T`` steps; fields and masks as in ``mjrl_tpu.types.TrajectoryBatch``:

    - ``observations (N, T, do)``, ``actions (N, T, da)``, ``rewards (N, T)``;
    - ``valid`` (step inside an episode), ``done`` (last valid step of an
      episode) and ``terminated`` (that episode ended in a true
      termination), all bool ``(N, T)``;
    - the behavior policy's ``mean``/``log_std`` ``(N, T, da)`` and
      ``log_prob (N, T)``; ``time (N, T)`` int32 step index;
    - ``returns``/``baseline``/``advantages (N, T)``, zeros until computed;
    - ``env_info``: dict of extra ``(N, T)`` tensors.
    """

    observations: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    valid: torch.Tensor
    done: torch.Tensor
    terminated: torch.Tensor
    mean: torch.Tensor
    log_std: torch.Tensor
    log_prob: torch.Tensor
    time: torch.Tensor
    returns: torch.Tensor
    baseline: torch.Tensor
    advantages: torch.Tensor
    env_info: Dict[str, torch.Tensor]

    @property
    def num_envs(self) -> int:
        return self.rewards.shape[0]

    @property
    def horizon(self) -> int:
        return self.rewards.shape[1]

    @property
    def num_valid(self) -> torch.Tensor:
        """Total number of valid transitions (0-d tensor)."""
        return self.valid.float().sum()

    def replace(self, **kwargs: Any) -> "TrajectoryBatch":
        return dataclasses.replace(self, **kwargs)
