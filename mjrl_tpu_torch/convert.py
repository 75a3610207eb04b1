"""Weights from the JAX package into the port's modules.

``params_np`` / ``state_np`` are the JAX pytrees with numpy leaves
(``jax.tree.map(np.asarray, tree)``). A JAX layer ``{"w": (in, out), "b":
(out,)}`` becomes an ``nn.Linear`` with ``weight = w.T``. Flat vectors
differ in order: JAX's ``ravel_pytree`` sorts dict keys (``log_std`` before
``mlp``, ``b`` before ``w``, ``w`` row-major ``(in, out)``), the port
follows ``named_parameters()``; ``policy_flat_from_jax`` maps one to the
other.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from mjrl_tpu_torch.models.baselines import MLPBaseline
from mjrl_tpu_torch.models.gaussian_mlp import GaussianMLP
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
    """A :class:`GaussianMLP` holding the JAX policy's parameters."""
    policy = GaussianMLP(spec, hidden_sizes=_hidden(params_np["mlp"]), min_log_std=min_log_std)
    _load_mlp(policy.mlp, params_np["mlp"], transforms_np)
    with torch.no_grad():
        policy.log_std.copy_(torch.as_tensor(np.asarray(params_np["log_std"])))
    return policy


def baseline_from_jax(state_np: Dict[str, Any], spec: EnvSpec, **kwargs: Any) -> MLPBaseline:
    """An :class:`MLPBaseline` holding a fresh JAX baseline's weights and
    transforms. A state whose Adam has taken steps is refused: its moments
    are not carried across."""
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
