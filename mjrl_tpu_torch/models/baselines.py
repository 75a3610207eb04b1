"""Value-function baselines: zero, linear, quadratic and MLP.

Twin of ``mjrl_tpu/models/baselines.py``. Features are the reference's
``[o, o^2, al, al^2, al^3, 1]`` with ``o = clip(obs, -10, 10) / 10`` and
``al = t / 1000``; the quadratic baseline appends the products ``o_i o_j``
(``i <= j``, in ``triu_indices`` order). Every fit regresses the in-episode
returns with padded steps weighted 0 and reports ``VF_error_before/after
= sum((y - yhat)^2) / sum(y^2)``. The linear and quadratic baselines solve
the ridge normal equations (``ops/lstsq.py``); they have no optimizer.
The MLP baseline's fit is minibatch Adam over shuffled fixed-size
minibatches. Two options of the MLP baseline,
off by default as in the reference: ``reg_coef`` adds an L2 penalty on the
weights, and ``vf_clip_coef`` clips the value loss PPO-style around the
pre-fit prediction.

Under data parallelism (``parallel/dist.py``) each rank fits on its own
rows: the least-squares fits sum the normal equations over the ranks, and
the MLP fit draws the same global permutation on every rank, takes from
each minibatch the rows in its own block (the others weigh 0), divides its
loss by the minibatch's weight over every rank, and sums the gradient over
the ranks before each Adam step: the single-rank fit up to the order of the
sums, with no rows moved. The errors and the clip's target moments are over
every rank's rows.
"""

from __future__ import annotations

import abc
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from mjrl_tpu_torch.models.mlp import MLP
from mjrl_tpu_torch.ops.lstsq import ridge_solve
from mjrl_tpu_torch.parallel import dist
from mjrl_tpu_torch.types import EnvSpec, TrajectoryBatch
from mjrl_tpu_torch.utils import trace


def base_features(obs: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
    """The reference's shared feature map, shape ``(..., 2*do + 4)``."""
    o = torch.clamp(obs, -10.0, 10.0) / 10.0
    al = time.to(o.dtype)[..., None] / 1000.0
    return torch.cat([o, torch.square(o), al, al**2, al**3, torch.ones_like(al)], dim=-1)


def quadratic_features(obs: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
    """Base features plus the upper-triangle products of the scaled obs."""
    o = torch.clamp(obs, -10.0, 10.0) / 10.0
    iu, ju = torch.triu_indices(o.shape[-1], o.shape[-1], device=o.device)
    return torch.cat([base_features(obs, time), o[..., iu] * o[..., ju]], dim=-1)


def relative_error(pred, target, w) -> torch.Tensor:
    """``sum(w (y - yhat)^2) / sum(w y^2)`` over every rank's rows."""
    num, den = dist.all_sum(torch.stack([torch.sum(w * torch.square(target - pred)),
                                         torch.sum(w * torch.square(target))]))
    return num / (den + 1e-8)


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


def _flat_fit_data(batch: TrajectoryBatch, features):
    m = batch.num_envs * batch.horizon
    feats = features(batch.observations, batch.time).reshape(m, -1)
    return feats, batch.returns.reshape(m), batch.valid.reshape(m).to(batch.returns.dtype)


class ZeroBaseline(Baseline):
    """Predicts 0 (an ablation)."""

    def predict(self, obs, time):
        return torch.zeros(obs.shape[:-1], dtype=obs.dtype, device=obs.device)

    def fit(self, batch, generator=None, perms=None):
        zero = torch.zeros((), device=batch.returns.device)
        return {"VF_error_before": zero, "VF_error_after": zero}


class LinearBaseline(Baseline):
    """``V = features(s) @ coef``, ``coef`` the ridge solution over the
    batch (reference default ``reg_coef=1e-5``)."""

    features = staticmethod(base_features)

    def __init__(self, spec: EnvSpec, reg_coef: float = 1e-5):
        super().__init__(spec)
        self.reg_coef = reg_coef
        nf = self.features(torch.zeros(spec.observation_dim), torch.zeros((), dtype=torch.int32))
        self.register_buffer("coef", torch.zeros(nf.shape[-1]))

    def predict(self, obs, time):
        return self.features(obs, time) @ self.coef

    @torch.no_grad()
    def fit(self, batch, generator=None, perms=None):
        feats, target, w = _flat_fit_data(batch, self.features)
        err_before = relative_error(feats @ self.coef, target, w)
        self.coef.copy_(ridge_solve(feats, target, w, reg_coef=self.reg_coef))
        err_after = relative_error(feats @ self.coef, target, w)
        return {"VF_error_before": err_before, "VF_error_after": err_after}


class QuadraticBaseline(LinearBaseline):
    """The linear baseline on :func:`quadratic_features`."""

    features = staticmethod(quadratic_features)


class MLPBaseline(Baseline):
    """Reference defaults: lr 1e-3, minibatch 64, hidden (128, 128),
    ``epochs`` passes per fit; a partial trailing minibatch is dropped.

    ``reg_coef > 0`` adds ``reg_coef * sum(w^2)`` over the layers' weights
    (not the biases) to each minibatch loss. ``vf_clip_coef > 0`` takes the
    loss as ``max((v - y)^2, (v_clip - y)^2)`` with ``v_clip = v_old +
    clip(v - v_old, +-eps)``, ``v_old`` the prediction before the fit and
    ``eps = vf_clip_coef * std(targets)`` over the valid steps."""

    def __init__(self, spec: EnvSpec, learn_rate: float = 1e-3, reg_coef: float = 0.0,
                 batch_size: int = 64, epochs: int = 1, hidden_sizes: Sequence[int] = (128, 128),
                 vf_clip_coef: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__(spec)
        self.reg_coef = reg_coef
        self.vf_clip_coef = vf_clip_coef
        self.batch_size = batch_size
        self.epochs = epochs
        self.hidden_sizes = tuple(hidden_sizes)
        nf = 2 * spec.observation_dim + 4
        self.mlp = MLP((nf, *self.hidden_sizes, 1), final_scale=1.0, generator=generator)
        self.optimizer = torch.optim.Adam(self.mlp.parameters(), lr=learn_rate)

    def predict(self, obs, time):
        return self.mlp(base_features(obs, time))[..., 0]

    def fit_perms(self, m: int, generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """One ``(num_minibatches, minibatch)`` index tensor per epoch, of
        the ``m`` steps of every rank."""
        mb = min(self.batch_size, m)
        num_mb = max(m // mb, 1)
        device = self.mlp.in_shift.device
        return [
            torch.randperm(m, generator=generator, device=device)[: num_mb * mb].reshape(num_mb, mb)
            for _ in range(self.epochs)
        ]

    def fit(self, batch, generator=None, perms=None):
        """``perms`` (one ``(num_mb, mb)`` tensor per epoch, indices into
        every rank's steps) fixes the minibatches, else they are drawn from
        ``generator``."""
        feats, target, w = _flat_fit_data(batch, base_features)
        offset, m = dist.block(target.shape[0], target.device)
        with torch.no_grad():
            pred0 = self.mlp(feats)[..., 0]
            err_before = relative_error(pred0, target, w)
            if self.vf_clip_coef > 0.0:
                count, total = dist.all_sum(torch.stack([w.sum(), torch.sum(target * w)]))
                n = torch.clamp(count, min=1.0)
                t_mu = total / n
                vf_eps = self.vf_clip_coef * torch.sqrt(
                    dist.all_sum(torch.sum(torch.square(target - t_mu) * w)) / n + 1e-8)
        for perm in self.fit_perms(m, generator) if perms is None else perms:
            perm, weights = dist.local_index(perm, offset, target.shape[0], w)
            dens = torch.clamp(dist.all_sum(weights.sum(dim=-1)), min=1.0)
            for idx, ww, den in zip(perm, weights, dens):
                with trace.span("fit.adam_step"):
                    y = target[idx]
                    pred = self.mlp(feats[idx])[..., 0]
                    sq = torch.square(pred - y)
                    if self.vf_clip_coef > 0.0:
                        v_old = pred0[idx]
                        v_clip = v_old + torch.clamp(pred - v_old, -vf_eps, vf_eps)
                        sq = torch.maximum(sq, torch.square(v_clip - y))
                    loss = torch.sum(ww * sq) / den
                    if self.reg_coef > 0.0 and dist.is_main():  # replicated: counted once
                        loss = loss + self.reg_coef * sum(
                            torch.sum(torch.square(layer.weight)) for layer in self.mlp.layers)
                    self.optimizer.zero_grad(set_to_none=True)
                    loss.backward()
                    dist.all_sum_grads(self.mlp.parameters())
                    self.optimizer.step()
        with torch.no_grad():
            err_after = relative_error(self.mlp(feats)[..., 0], target, w)
        return {"VF_error_before": err_before, "VF_error_after": err_after}
