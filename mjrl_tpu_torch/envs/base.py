"""Env protocol: batched environments over explicit state tensors.

Twin of ``mjrl_tpu/envs/base.py`` with the env batch written out instead of
``vmap``: ``reset`` returns the state and observations of ``num_envs``
envs, ``step`` advances them all. ``terminated`` is true env termination
only; horizon truncation is the sampler's job.

    state, obs                          = env.reset(num_envs, generator)
    state, obs, reward, terminated, info = env.step(state, action)
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from mjrl_tpu_torch.types import EnvSpec


class EnvState(NamedTuple):
    q: torch.Tensor  # (B, nq)
    qd: torch.Tensor  # (B, nv)


StepResult = Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]


class Env(abc.ABC):
    """Base class. Subclasses hold static config and a device."""

    spec: EnvSpec
    device: torch.device

    @abc.abstractmethod
    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        """Initial ``(state, obs)`` of ``num_envs`` envs."""

    @abc.abstractmethod
    def step(self, state: EnvState, action: torch.Tensor) -> StepResult:
        """One control step: ``(state, obs, reward, terminated, info)``."""


_REGISTRY: Dict[str, Callable[..., Env]] = {}


def register(env_id: str, factory: Callable[..., Env]) -> None:
    _REGISTRY[env_id] = factory


def make(env_id: str, **kwargs: Any) -> Env:
    if env_id not in _REGISTRY:
        raise KeyError(f"Unknown env '{env_id}'. Registered: {sorted(_REGISTRY)}")
    return _REGISTRY[env_id](**kwargs)
