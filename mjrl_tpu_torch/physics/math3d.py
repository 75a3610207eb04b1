"""Quaternion helpers, batch-first: the last dim holds the components.

Twin of the parts of ``mjrl_tpu/physics/math3d.py`` that the port calls
(physics/engine.py, contact.py, csolve.py, comfeat.py, envs/adroit.py):
the quaternion helpers, the exponential-map update of ball and free joints,
and the two spatial cross products of the bias forces. Quaternions are
``(..., 4)`` as ``[w, x, y, z]``; vectors ``(..., 3)``; spatial vectors
``(..., 6)`` as ``[angular, linear]``; leading dims broadcast.
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


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


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


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate ``v`` by the inverse of ``q`` (world -> body)."""
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """``(..., 3, 3)`` rotation matrix R with ``R @ v == quat_rotate(q, v)``."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """``axis (..., 3)`` unit, ``angle (...)`` -> ``(..., 4)``."""
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None], torch.sin(half)[..., None] * axis], dim=-1)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt: float) -> torch.Tensor:
    """Advance ``q`` by the body-frame angular velocity ``omega`` over
    ``dt`` (the exponential map), renormalised."""
    angle = torch.linalg.vector_norm(omega, dim=-1, keepdim=True)
    small = angle < 1e-9
    axis = omega / torch.where(small, torch.ones_like(angle), angle)
    dq = quat_from_axis_angle(axis, (angle * dt)[..., 0])
    dq = torch.where(small, torch.cat([torch.ones_like(angle), torch.zeros_like(omega)], dim=-1), dq)
    return quat_normalize(quat_mul(q, dq))


def skew(v: torch.Tensor) -> torch.Tensor:
    """``(..., 3, 3)`` cross-product matrix: ``skew(a) @ b == a x b``."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1).reshape(
        v.shape[:-1] + (3, 3))


def crm(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Motion x motion: ``[w x w2, w x v2 + v x w2]``."""
    w, lin = v[..., :3], v[..., 3:]
    w2, l2 = m[..., :3], m[..., 3:]
    return torch.cat([cross(w, w2), cross(w, l2) + cross(lin, w2)], dim=-1)


def crf(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Motion x force: ``[w x n + v x f, w x f]``."""
    w, lin = v[..., :3], v[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, n) + cross(lin, fl), cross(w, fl)], dim=-1)


def quat_to_euler(q: torch.Tensor) -> torch.Tensor:
    """``(..., 4)`` -> XYZ-extrinsic euler angles ``(..., 3)`` (Gymnasium-
    Robotics' ``rotations.quat2euler``, which hammer's observation reads);
    near gimbal lock (``cy <= 1e-6``) z is 0 and x takes the rest."""
    m = quat_to_mat(q)
    cy = torch.sqrt(m[..., 2, 2] ** 2 + m[..., 1, 2] ** 2)
    safe = cy > 1e-6
    x = torch.where(safe, torch.atan2(-m[..., 1, 2], m[..., 2, 2]),
                    torch.atan2(m[..., 1, 0], m[..., 1, 1]))
    y = torch.atan2(m[..., 0, 2], cy)
    z = torch.where(safe, torch.atan2(-m[..., 0, 1], m[..., 0, 0]), torch.zeros_like(cy))
    return torch.stack([x, y, z], dim=-1)
