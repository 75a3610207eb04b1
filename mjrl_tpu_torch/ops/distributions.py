"""Diagonal-Gaussian policy distribution math (twin of
``mjrl_tpu/ops/distributions.py``): log-likelihood, likelihood ratio and
``KL(old || new)`` of ``N(mean, diag(exp(log_std))^2)``, broadcasting over
leading batch dims."""

from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


class DiagGaussian:
    """Stateless namespace of diagonal-Gaussian ops (mean, log_std params)."""

    @staticmethod
    def sample(mean: torch.Tensor, log_std: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """Reparameterized sample ``mean + exp(log_std) * eps`` for standard
        normal ``eps``."""
        return mean + torch.exp(log_std) * eps

    @staticmethod
    def log_prob(actions, mean, log_std) -> torch.Tensor:
        """``-0.5*||(a-mu)/sigma||^2 - sum(log_std) - (da/2) log(2 pi)``."""
        z = (actions - mean) * torch.exp(-log_std)
        return (
            -0.5 * torch.sum(torch.square(z), dim=-1)
            - torch.sum(log_std, dim=-1)
            - 0.5 * _LOG_2PI * actions.shape[-1]
        )

    @staticmethod
    def likelihood_ratio(actions, new_mean, new_log_std, old_mean, old_log_std) -> torch.Tensor:
        """``exp(LL_new - LL_old)`` per sample."""
        ll_new = DiagGaussian.log_prob(actions, new_mean, new_log_std)
        ll_old = DiagGaussian.log_prob(actions, old_mean, old_log_std)
        return torch.exp(ll_new - ll_old)

    @staticmethod
    def kl(old_mean, old_log_std, new_mean, new_log_std) -> torch.Tensor:
        """Per-sample ``KL(old || new)``, reduced over the action dim."""
        var_ratio = torch.exp(2.0 * (old_log_std - new_log_std))
        mean_term = torch.square(new_mean - old_mean) * torch.exp(-2.0 * new_log_std)
        per_dim = 0.5 * (var_ratio + mean_term) + new_log_std - old_log_std - 0.5
        return torch.sum(per_dim, dim=-1)
