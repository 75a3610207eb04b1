"""Value-function baseline: the MLP baseline of the main path.

Twin of ``mjrl_tpu/models/baselines.py`` (``Baseline``, ``_base_features``,
``MLPBaseline``). Features are the reference's ``[o, o^2, al, al^2, al^3,
1]`` with ``o = clip(obs, -10, 10) / 10`` and ``al = t / 1000``; the fit is
minibatch Adam over shuffled fixed-size minibatches against the in-episode
returns, with padded steps weighted 0, reporting
``VF_error_before/after = sum((y - yhat)^2) / sum(y^2)``.
"""

from __future__ import annotations

import abc
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from mjrl_tpu_torch.models.mlp import MLP
from mjrl_tpu_torch.types import EnvSpec, TrajectoryBatch


def base_features(obs: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
    """The reference's shared feature map, shape ``(..., 2*do + 4)``."""
    o = torch.clamp(obs, -10.0, 10.0) / 10.0
    al = time.to(o.dtype)[..., None] / 1000.0
    return torch.cat([o, torch.square(o), al, al**2, al**3, torch.ones_like(al)], dim=-1)


def relative_error(pred, target, w) -> torch.Tensor:
    return torch.sum(w * torch.square(target - pred)) / (torch.sum(w * torch.square(target)) + 1e-8)


class Baseline(nn.Module, abc.ABC):
    """A value function ``V(s)`` fit to ``batch.returns``."""

    def __init__(self, spec: EnvSpec):
        super().__init__()
        self.spec = spec

    @abc.abstractmethod
    def predict(self, obs: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        """V(s) for obs ``(..., do)`` and episode-time ``(...,)``."""

    @abc.abstractmethod
    def fit(self, batch: TrajectoryBatch, generator: Optional[torch.Generator] = None,
            perms: Optional[List[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Fit against ``batch.returns``; returns the error metrics."""


class MLPBaseline(Baseline):
    """Reference defaults: lr 1e-3, minibatch 64, hidden (128, 128),
    ``epochs`` passes per fit; a partial trailing minibatch is dropped."""

    def __init__(self, spec: EnvSpec, learn_rate: float = 1e-3, batch_size: int = 64,
                 epochs: int = 1, hidden_sizes: Sequence[int] = (128, 128),
                 generator: Optional[torch.Generator] = None):
        super().__init__(spec)
        self.batch_size = batch_size
        self.epochs = epochs
        self.hidden_sizes = tuple(hidden_sizes)
        nf = 2 * spec.observation_dim + 4
        self.mlp = MLP((nf, *self.hidden_sizes, 1), final_scale=1.0, generator=generator)
        self.optimizer = torch.optim.Adam(self.mlp.parameters(), lr=learn_rate)

    def predict(self, obs, time):
        return self.mlp(base_features(obs, time))[..., 0]

    def fit_perms(self, m: int, generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """One ``(num_minibatches, minibatch)`` index tensor per epoch."""
        mb = min(self.batch_size, m)
        num_mb = max(m // mb, 1)
        device = self.mlp.in_shift.device
        return [
            torch.randperm(m, generator=generator, device=device)[: num_mb * mb].reshape(num_mb, mb)
            for _ in range(self.epochs)
        ]

    def fit(self, batch, generator=None, perms=None):
        m = batch.num_envs * batch.horizon
        feats = base_features(batch.observations, batch.time).reshape(m, -1)
        target = batch.returns.reshape(m)
        w = batch.valid.reshape(m).to(target.dtype)
        with torch.no_grad():
            err_before = relative_error(self.mlp(feats)[..., 0], target, w)
        for perm in self.fit_perms(m, generator) if perms is None else perms:
            for idx in perm:
                ww = w[idx]
                sq = torch.square(self.mlp(feats[idx])[..., 0] - target[idx])
                loss = torch.sum(ww * sq) / torch.clamp(ww.sum(), min=1.0)
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                self.optimizer.step()
        with torch.no_grad():
            err_after = relative_error(self.mlp(feats)[..., 0], target, w)
        return {"VF_error_before": err_before, "VF_error_after": err_after}
