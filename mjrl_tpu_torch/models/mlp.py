"""MLP with tanh hidden layers and input/output shift-scale transforms.

Twin of ``mjrl_tpu/models/mlp.py``: uniform ``+-1/sqrt(fan_in)`` init with
the final layer scaled by ``final_scale``, and the non-trainable in/out
transforms as buffers. ``sizes`` of two entries (no hidden layer) make an
affine map, as the linear policy has. A JAX layer's ``w`` is ``(in, out)``; ``nn.Linear``
keeps ``(out, in)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


class MLP(nn.Module):
    def __init__(self, sizes: Sequence[int], final_scale: float = 0.01,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1)
        )
        with torch.no_grad():
            for i, layer in enumerate(self.layers):
                bound = 1.0 / float(sizes[i]) ** 0.5
                scale = final_scale if i == len(self.layers) - 1 else 1.0
                for p in (layer.weight, layer.bias):
                    p.uniform_(-bound, bound, generator=generator).mul_(scale)
        self.register_buffer("in_shift", torch.zeros(sizes[0]))
        self.register_buffer("in_scale", torch.ones(sizes[0]))
        self.register_buffer("out_shift", torch.zeros(sizes[-1]))
        self.register_buffer("out_scale", torch.ones(sizes[-1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = (x - self.in_shift) / (self.in_scale + 1e-8)
        for layer in self.layers[:-1]:
            h = torch.tanh(layer(h))
        return self.layers[-1](h) * self.out_scale + self.out_shift
