"""Weights from the JAX package into the port's modules.

``params_np`` / ``state_np`` are the JAX pytrees with numpy leaves
(``jax.tree.map(np.asarray, tree)``). A JAX layer ``{"w": (in, out), "b":
(out,)}`` becomes an ``nn.Linear`` with ``weight = w.T``. Flat vectors
differ in order: JAX's ``ravel_pytree`` sorts dict keys (``log_std`` before
``mlp``, ``b`` before ``w``, ``w`` row-major ``(in, out)``), the port
follows ``named_parameters()``; ``policy_flat_from_jax`` maps one to the
other. The dynamics ensemble's JAX state is vmapped: every leaf has a
leading member axis K, which becomes the stacked ``(K, in, out)`` weights
and ``(K, out)`` biases of ``DynamicsEnsemble``, in the same orientation.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from mjrl_tpu_torch.models.baselines import (
    Baseline,
    LinearBaseline,
    MLPBaseline,
    QuadraticBaseline,
    ZeroBaseline,
)
from mjrl_tpu_torch.models.dynamics import DynamicsEnsemble
from mjrl_tpu_torch.models.gaussian_mlp import GaussianLinear, GaussianMLP
from mjrl_tpu_torch.models.mlp import MLP
from mjrl_tpu_torch.types import EnvSpec


def _load_mlp(mlp: MLP, layers: List[Dict[str, Any]], transforms: Dict[str, Any] = None) -> None:
    with torch.no_grad():
        for lin, layer in zip(mlp.layers, layers):
            lin.weight.copy_(torch.as_tensor(np.asarray(layer["w"]).T))
            lin.bias.copy_(torch.as_tensor(np.asarray(layer["b"])))
        for name, value in (transforms or {}).items():
            getattr(mlp, name).copy_(torch.as_tensor(np.asarray(value)))


def _hidden(layers) -> tuple:
    return tuple(np.asarray(layer["w"]).shape[1] for layer in layers[:-1])


def policy_from_jax(params_np: Dict[str, Any], spec: EnvSpec, min_log_std: float = -3.0,
                    transforms_np: Dict[str, Any] = None) -> GaussianMLP:
    """A :class:`GaussianMLP` holding the JAX policy's parameters; a
    :class:`GaussianLinear` where it has no hidden layer."""
    hidden = _hidden(params_np["mlp"])
    policy = (GaussianMLP(spec, hidden_sizes=hidden, min_log_std=min_log_std) if hidden
              else GaussianLinear(spec, min_log_std=min_log_std))
    _load_mlp(policy.mlp, params_np["mlp"], transforms_np)
    with torch.no_grad():
        policy.log_std.copy_(torch.as_tensor(np.asarray(params_np["log_std"])))
    return policy


def baseline_from_jax(state_np: Any, spec: EnvSpec, **kwargs: Any) -> Baseline:
    """The port's twin of a JAX baseline state: ``()`` is the zero
    baseline; ``{"coef"}`` the linear or the quadratic one, told apart by
    the coefficients' count; any other an :class:`MLPBaseline` holding a
    fresh JAX baseline's weights and transforms. An MLP state whose Adam
    has taken steps is refused: its moments are not carried across."""
    if isinstance(state_np, tuple) and not state_np:
        return ZeroBaseline(spec)
    if set(state_np) == {"coef"}:
        coef = torch.as_tensor(np.asarray(state_np["coef"]))
        do = spec.observation_dim
        cls = LinearBaseline if coef.numel() == 2 * do + 4 else QuadraticBaseline
        baseline = cls(spec, **kwargs)
        baseline.coef.copy_(coef)
        return baseline
    if int(np.asarray(state_np["opt_state"][0].count)) > 0:
        raise NotImplementedError("Adam moments are not converted")
    baseline = MLPBaseline(spec, hidden_sizes=_hidden(state_np["mlp"]), **kwargs)
    _load_mlp(baseline.mlp, state_np["mlp"], state_np["transforms"])
    return baseline


def policy_flat_from_jax(flat_np: np.ndarray, policy: GaussianMLP) -> torch.Tensor:
    """A JAX flat policy vector (``ravel_pytree`` order) in the port's
    ``named_parameters()`` order."""
    flat_np = np.asarray(flat_np)
    da = policy.spec.action_dim
    parts: Dict[str, np.ndarray] = {"log_std": flat_np[:da]}
    o = da
    for i, lin in enumerate(policy.mlp.layers):
        out_f, in_f = lin.weight.shape
        parts[f"mlp.layers.{i}.bias"] = flat_np[o : o + out_f]
        o += out_f
        parts[f"mlp.layers.{i}.weight"] = flat_np[o : o + in_f * out_f].reshape(in_f, out_f).T
        o += in_f * out_f
    if o != flat_np.size:
        raise ValueError(f"flat vector has {flat_np.size} entries, policy {o}")
    return torch.cat([torch.from_numpy(np.array(parts[k])).reshape(-1)
                      for k, _ in policy.named_parameters()])


def dynamics_state_from_jax(state_np: Dict[str, Any], dynamics: DynamicsEnsemble) -> None:
    """Load a JAX ``DynamicsEnsemble`` state (``params``: a list of layers
    ``{"w": (K, in, out), "b": (K, out)}``; ``opt_state``: optax Adam's
    vmapped state; the four normalizers) into ``dynamics``: parameters,
    normalizers, and Adam's moments and step count once it has stepped
    (optax counts per member; the members step together, so the counts
    are equal and become the one count of the stacked Adam)."""
    layers = state_np["params"]
    if len(layers) != len(dynamics.weights):
        raise ValueError(f"{len(layers)} layers, the ensemble has {len(dynamics.weights)}")
    as_t = lambda x, like: torch.as_tensor(np.asarray(x)).to(like.device, like.dtype)
    with torch.no_grad():
        for w, b, layer in zip(dynamics.weights, dynamics.biases, layers):
            w.copy_(as_t(layer["w"], w))
            b.copy_(as_t(layer["b"], b))
        for name in ("in_shift", "in_scale", "delta_shift", "delta_scale"):
            getattr(dynamics, name).copy_(as_t(state_np[name], getattr(dynamics, name)))
    adam = state_np["opt_state"][0]
    counts = np.asarray(adam.count)
    if counts.max() == 0:
        return
    if counts.min() != counts.max():
        raise ValueError(f"members stepped unequally: {counts}")
    opt = dynamics.optimizer
    params = [*dynamics.weights, *dynamics.biases]
    moments = [(lay["w"], mu["w"], nu["w"]) for lay, mu, nu in zip(layers, adam.mu, adam.nu)]
    moments += [(lay["b"], mu["b"], nu["b"]) for lay, mu, nu in zip(layers, adam.mu, adam.nu)]
    for p, (_, mu, nu) in zip(params, moments):
        opt.state[p] = {"step": torch.tensor(float(counts[0])), "exp_avg": as_t(mu, p),
                        "exp_avg_sq": as_t(nu, p)}
