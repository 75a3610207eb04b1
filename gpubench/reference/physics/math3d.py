"""Quaternion helpers, batch-first: the last dim holds the components.

The quaternion helpers of the port's ``physics/math3d.py`` that the link
poses (engine.py) and the pen reference env read. Quaternions are
``(..., 4)`` as ``[w, x, y, z]``; vectors ``(..., 3)``; leading dims
broadcast.
"""

from __future__ import annotations

import torch


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.sqrt(torch.sum(torch.square(q), dim=-1, keepdim=True) + eps)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a x b`` over the last dim, broadcasting the leading dims."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate ``v`` by ``q`` (body -> world for a body's orientation)."""
    qw, qv = q[..., 0:1], q[..., 1:4]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """``axis (..., 3)`` unit, ``angle (...)`` -> ``(..., 4)``."""
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None], torch.sin(half)[..., None] * axis], dim=-1)
