"""Gaussian policy: tanh-MLP mean + state-independent learned log_std, and
its linear-mean variant ``GaussianLinear`` (the MLP with no hidden layer).

Twin of ``mjrl_tpu/models/gaussian_mlp.py``. The module's parameters are
the policy; ``project`` is the min_log_std clamp applied after every
update, written on a parameter dict so the NPG step can apply it to the
functional parameters it builds.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from mjrl_tpu_torch.models.mlp import MLP
from mjrl_tpu_torch.types import EnvSpec


class GaussianMLP(nn.Module):
    """Diagonal-Gaussian MLP policy (reference defaults: hidden (64, 64),
    ``min_log_std=-3``, ``init_log_std=0``)."""

    def __init__(self, spec: EnvSpec, hidden_sizes: Sequence[int] = (64, 64),
                 min_log_std: float = -3.0, init_log_std: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        self.hidden_sizes = tuple(hidden_sizes)
        self.min_log_std = float(min_log_std)
        self.mlp = MLP((spec.observation_dim, *self.hidden_sizes, spec.action_dim),
                       generator=generator)
        self.log_std = nn.Parameter(torch.full((spec.action_dim,), float(init_log_std)))

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(mean, log_std)`` for obs with any leading batch dims."""
        mean = self.mlp(obs)
        return mean, self.log_std.expand_as(mean)

    def project(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Clamp log_std from below."""
        return {**params, "log_std": torch.clamp(params["log_std"], min=self.min_log_std)}


class GaussianLinear(GaussianMLP):
    """Linear-mean variant (``policy="linear"``): :class:`GaussianMLP` with
    ``hidden_sizes=()``, one affine layer from obs to mean."""

    def __init__(self, spec: EnvSpec, min_log_std: float = -3.0, init_log_std: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(spec, hidden_sizes=(), min_log_std=min_log_std,
                         init_log_std=init_log_std, generator=generator)
