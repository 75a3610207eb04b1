"""Flat-vector views of parameter dicts (twin of ``mjrl_tpu/ops/ravel.py``).

NPG does its linear algebra on one flat vector. The port's flat order is
the order of the dict (a module's ``named_parameters()``), each tensor
flattened row-major; JAX's ``ravel_pytree`` sorts dict keys instead, and
mjrl_tpu_torch/convert.py maps between the two.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


def ravel(params: Params) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Params]]:
    """``(flat, unravel)`` for a dict of tensors."""
    names = list(params)
    shapes = [params[k].shape for k in names]
    sizes = [params[k].numel() for k in names]

    def unravel(flat: torch.Tensor) -> Params:
        return {k: part.reshape(s) for k, part, s in zip(names, torch.split(flat, sizes), shapes)}

    return torch.cat([params[k].reshape(-1) for k in names]), unravel
