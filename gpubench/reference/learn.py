"""The learning half of the reference: a tanh MLP, the Gaussian policy,
returns and GAE, NPG with conjugate gradient, and the MLP baseline's
minibatch Adam fit, as mjrl (Rajeswaran et al., 2017) defines them.

Plain PyTorch on float32; nothing of ``mjrl_tpu_torch`` is imported. A
network is a list of ``(weight (out, in), bias (out,))`` pairs; the policy
adds its state-independent ``log_std``. The Fisher-vector product is the
Hessian of the mean KL by double backward (the port differentiates
forward-over-reverse: the same matrix, other rounding).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

Layers = List[Tuple[torch.Tensor, torch.Tensor]]
_LOG_2PI = math.log(2.0 * math.pi)


def mlp(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """tanh hidden layers, a linear last layer."""
    for i, (w, b) in enumerate(layers):
        x = torch.nn.functional.linear(x, w, b)
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


def log_prob(a, mean, log_std):
    z = (a - mean) * torch.exp(-log_std)
    return (-0.5 * torch.sum(z * z, dim=-1) - torch.sum(log_std, dim=-1)
            - 0.5 * _LOG_2PI * a.shape[-1])


def kl(old_mean, old_log_std, new_mean, new_log_std):
    """``KL(old || new)`` of diagonal Gaussians, summed over the action."""
    var_ratio = torch.exp(2.0 * (old_log_std - new_log_std))
    mean_term = torch.square(new_mean - old_mean) * torch.exp(-2.0 * new_log_std)
    return torch.sum(0.5 * (var_ratio + mean_term) + new_log_std - old_log_std - 0.5, dim=-1)


def features(obs: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
    """mjrl's baseline features ``[o, o^2, t, t^2, t^3, 1]``, ``o`` the
    observation clipped to +-10 over 10 and ``t`` the step over 1000."""
    o = torch.clamp(obs, -10.0, 10.0) / 10.0
    t = time.to(o.dtype)[..., None] / 1000.0
    return torch.cat([o, o * o, t, t * t, t * t * t, torch.ones_like(t)], dim=-1)


def discounted(x: torch.Tensor, done: torch.Tensor, decay: float) -> torch.Tensor:
    """``y_t = x_t + decay * y_{t+1}``, the sum cut after each ``done``."""
    out = torch.empty_like(x)
    carry = x.new_zeros(x.shape[0])
    for t in range(x.shape[1] - 1, -1, -1):
        carry = x[:, t] + decay * torch.where(done[:, t], torch.zeros_like(carry), carry)
        out[:, t] = carry
    return out


def returns_and_advantages(b: Dict[str, torch.Tensor], values: torch.Tensor, gamma: float,
                           lam: float, eps: float = 1e-6):
    """Masked in-episode returns and GAE(lambda) advantages (a terminated
    episode bootstraps with 0, a truncated one with its last value),
    normalized over the valid steps to mean 0 and std 1 (std + ``eps``)."""
    validf = b["valid"].to(values.dtype)
    rewards = b["rewards"] * validf
    ret = discounted(rewards, b["done"], gamma) * validf
    v = values * validf
    v_next = torch.cat([v[:, 1:], v[:, -1:]], dim=1)
    v_next = torch.where(b["done"], torch.where(b["terminated"], torch.zeros_like(v), v), v_next)
    adv = discounted((rewards + gamma * v_next - v) * validf, b["done"], gamma * lam) * validf
    n = torch.clamp(validf.sum(), min=1.0)
    mean = torch.sum(adv * validf) / n
    std = torch.sqrt(torch.sum(torch.square(adv - mean) * validf) / n)
    return ret, (adv - mean) / (std + eps) * validf


class Policy:
    """The Gaussian MLP policy's parameters as a flat list of leaves:
    ``[w0, b0, w1, b1, ..., log_std]``."""

    def __init__(self, leaves: List[torch.Tensor], min_log_std: float):
        self.leaves = [x.detach().clone() for x in leaves]
        self.min_log_std = min_log_std

    @staticmethod
    def forward(leaves, obs):
        layers = list(zip(leaves[:-1:2], leaves[1:-1:2]))
        mean = mlp(layers, obs)
        return mean, leaves[-1].expand_as(mean)


def npg_update(policy: Policy, b: Dict[str, torch.Tensor], adv: torch.Tensor, step_size: float,
               cg_iters: int = 10, damping: float = 1e-4, residual_tol: float = 1e-10):
    """One NPG step on ``policy`` in place: the surrogate's gradient ``g``,
    ``x = F^-1 g`` by CG on damped Fisher products, ``alpha =
    sqrt(2 step / |g.x|)``, ``log_std`` clamped from below. Returns the
    metrics and ``g``'s leaves."""
    obs, act, valid = b["observations"], b["actions"], b["valid"].to(adv.dtype)
    n = torch.clamp(valid.sum(), min=1.0)
    old = [x.detach() for x in policy.leaves]
    with torch.no_grad():
        old_mean, old_log_std = Policy.forward(old, obs)
        ll_old = log_prob(act, old_mean, old_log_std)

    def surrogate(leaves):
        mean, log_std = Policy.forward(leaves, obs)
        return torch.sum(torch.exp(log_prob(act, mean, log_std) - ll_old) * adv * valid) / n

    def mean_kl(leaves):
        mean, log_std = Policy.forward(leaves, obs)
        return torch.sum(kl(old_mean, old_log_std, mean, log_std) * valid) / n

    theta = [x.clone().requires_grad_(True) for x in old]
    surr_before = surrogate(theta)
    g = torch.autograd.grad(surr_before, theta)
    g_flat = torch.cat([x.reshape(-1) for x in g])
    grad_kl = torch.autograd.grad(mean_kl(theta), theta, create_graph=True)
    grad_kl_flat = torch.cat([x.reshape(-1) for x in grad_kl])

    def fvp(v):
        hv = torch.autograd.grad(grad_kl_flat, theta, grad_outputs=v, retain_graph=True)
        return torch.cat([x.reshape(-1) for x in hv]) + damping * v

    x = torch.zeros_like(g_flat)
    r = g_flat.clone()
    p = r
    rdotr = torch.dot(r, r)
    for _ in range(cg_iters):
        if float(rdotr) < residual_tol:
            break
        z = fvp(p)
        v = rdotr / torch.dot(p, z)
        x = x + v * p
        r = r - v * z
        new_rdotr = torch.dot(r, r)
        p = r + (new_rdotr / rdotr) * p
        rdotr = new_rdotr
    alpha = torch.sqrt(2.0 * step_size / (torch.abs(torch.dot(g_flat, x)) + 1e-20))
    flat = torch.cat([t.detach().reshape(-1) for t in old]) + alpha * x
    new, k = [], 0
    for t in old:
        new.append(flat[k:k + t.numel()].reshape(t.shape))
        k += t.numel()
    new[-1] = torch.clamp(new[-1], min=policy.min_log_std)
    with torch.no_grad():
        surr_after = surrogate(new)
        kl_dist = mean_kl(new)
    policy.leaves = new
    return {"alpha": alpha.detach(), "kl_dist": kl_dist,
            "surr_improvement": (surr_after - surr_before).detach()}, [x.detach() for x in g]


class Baseline:
    """mjrl's MLP value function on :func:`features`, fit by minibatch Adam
    over shuffled fixed-size minibatches (a partial last one dropped), the
    loss each minibatch's mean squared error over its valid steps."""

    def __init__(self, leaves: List[torch.Tensor], learn_rate: float, batch_size: int,
                 epochs: int):
        self.leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
        self.optimizer = torch.optim.Adam(self.leaves, lr=learn_rate)
        self.batch_size, self.epochs = batch_size, epochs

    def predict(self, obs, time):
        return mlp(list(zip(self.leaves[::2], self.leaves[1::2])), features(obs, time))[..., 0]

    def fit(self, b: Dict[str, torch.Tensor], returns: torch.Tensor,
            generator: Optional[torch.Generator]):
        """The fit; its minibatches drawn from ``generator`` as one
        ``randperm`` of the steps per epoch. Returns the errors
        ``sum(w (y - yhat)^2) / sum(w y^2)`` before and after, and the
        first minibatch's gradient leaves."""
        m = returns.numel()
        feats = features(b["observations"], b["time"]).reshape(m, -1)
        y = returns.reshape(m)
        w = b["valid"].reshape(m).to(y.dtype)
        layers = lambda: list(zip(self.leaves[::2], self.leaves[1::2]))  # noqa: E731

        def error():
            with torch.no_grad():
                pred = mlp(layers(), feats)[..., 0]
                return torch.sum(w * torch.square(y - pred)) / (torch.sum(w * y * y) + 1e-8)

        before = error()
        mb = min(self.batch_size, m)
        num_mb = max(m // mb, 1)
        first = None
        for _ in range(self.epochs):
            perm = torch.randperm(m, generator=generator, device=y.device)[: num_mb * mb]
            for idx in perm.reshape(num_mb, mb):
                ww = w[idx]
                loss = torch.sum(ww * torch.square(mlp(layers(), feats[idx])[..., 0] - y[idx]))
                loss = loss / torch.clamp(ww.sum(), min=1.0)
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                if first is None:
                    first = [x.grad.detach().clone() for x in self.leaves]
                self.optimizer.step()
        return {"VF_error_before": before, "VF_error_after": error()}, first
