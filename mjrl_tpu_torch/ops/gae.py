"""Returns and GAE advantages over ``(N, T)`` batches (twin of
``mjrl_tpu/ops/gae.py``).

The reference's reverse ``lax.scan`` over time becomes a reverse loop over
the ``T`` columns, each step a vector op over all envs. Returns are
in-episode Monte-Carlo sums; GAE bootstraps a terminated episode with 0 and
a truncated one with the value of its own last state; ``done`` resets the
carry at episode boundaries.
"""

from __future__ import annotations

from typing import Optional

import torch

from mjrl_tpu_torch.types import TrajectoryBatch


def _reverse_scan(xs: torch.Tensor, done: torch.Tensor, decay: float,
                  carry: torch.Tensor) -> torch.Tensor:
    """``y_t = x_t + decay * (0 if done_t else y_{t+1})`` along dim 1."""
    out = torch.empty_like(xs)
    for t in range(xs.shape[1] - 1, -1, -1):
        carry = xs[:, t] + decay * torch.where(done[:, t], torch.zeros_like(carry), carry)
        out[:, t] = carry
    return out


def compute_returns(rewards, done, valid, gamma: float) -> torch.Tensor:
    """Masked in-episode discounted returns (episodes mode: no bootstrap)."""
    validf = valid.to(rewards.dtype)
    rewards = rewards * validf
    return _reverse_scan(rewards, done, gamma, rewards.new_zeros(rewards.shape[0])) * validf


def compute_gae(rewards, values, done, terminated, valid, gamma: float,
                gae_lambda: float) -> torch.Tensor:
    """GAE(lambda) with mjrl's bootstrap semantics."""
    validf = valid.to(rewards.dtype)
    rewards = rewards * validf
    values = values * validf
    v_next = torch.cat([values[:, 1:], values[:, -1:]], dim=1)
    v_next = torch.where(done, torch.where(terminated, torch.zeros_like(values), values), v_next)
    deltas = (rewards + gamma * v_next - values) * validf
    return _reverse_scan(deltas, done, gamma * gae_lambda, rewards.new_zeros(rewards.shape[0])) * validf


def masked_mean_std(x: torch.Tensor, valid: torch.Tensor, eps: float = 1e-8):
    """Mean/std over valid entries."""
    validf = valid.to(x.dtype)
    n = torch.clamp(validf.sum(), min=1.0)
    mean = torch.sum(x * validf) / n
    var = torch.sum(torch.square(x - mean) * validf) / n
    return mean, torch.sqrt(var + eps)


def compute_advantages(batch: TrajectoryBatch, values: torch.Tensor, gamma: float,
                       gae_lambda: Optional[float] = None, normalize: bool = False,
                       eps: float = 1e-8) -> TrajectoryBatch:
    """Fill ``batch.advantages`` and ``batch.baseline``; ``gae_lambda``
    outside ``[0, 1]`` (or None) selects ``returns - V(s)``."""
    validf = batch.valid.to(values.dtype)
    if gae_lambda is not None and 0.0 <= float(gae_lambda) <= 1.0:
        adv = compute_gae(batch.rewards, values, batch.done, batch.terminated,
                          batch.valid, gamma, float(gae_lambda))
    else:
        adv = (batch.returns - values) * validf
    if normalize:
        mean, std = masked_mean_std(adv, batch.valid, eps=0.0)
        adv = (adv - mean) / (std + eps) * validf
    return batch.replace(advantages=adv, baseline=values * validf)
