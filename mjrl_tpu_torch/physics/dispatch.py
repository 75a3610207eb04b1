"""Batched frame stepping: batch-first env state in, one kernel launch per step.

Twin of ``mjrl_tpu/physics/dispatch.py::make_frame_stepper``. The env keeps
its state batch-first (``(B, nq)``, ``(B, nv)``); the stepper transposes to
the kernels' batch-last layout once per control step and advances all
``frame_skip x n_substeps`` substeps in one call of physics/pkernel.py's
``K1`` (penalty solver), ``K2`` (Newton solver), ``K3`` (penalty, with
tendons, per-env link offsets or another of Adroit's stages) or ``K4``
(Newton, with those stages), which launch the CUDA kernel for CUDA tensors
and run the plain version for CPU tensors. Unlike the reference, no model
is sent to a per-env engine: on the card Adroit runs K3 or K4 or raises.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from mjrl_tpu_torch.physics import soa
from mjrl_tpu_torch.physics.csolve import ensure_solver_params
from mjrl_tpu_torch.physics.model import Model
from mjrl_tpu_torch.physics.pkernel import K1, K2, K3, K4

FrameStepper = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def kernel_for(model: Model, with_link_delta: bool = False):
    """The kernel that steps ``model``: K1 or K3 (penalty), K2 or K4
    (Newton), the latter of each when the env carries link offsets or the
    model has a stage only their builds have."""
    ext = with_link_delta or soa.needs_ext(model)
    if model.constraint_solver == "newton":
        return K4 if ext else K2
    return K3 if ext else K1


def make_frame_stepper(model: Model, frame_skip: int, with_link_delta: bool = False
                       ) -> FrameStepper:
    """``(q (B, nq), qd (B, nv), ctrl (B, nu)[, link_delta (B, nlink, 3)])
    -> (q, qd)`` over ``frame_skip`` control frames; ``with_link_delta``
    adds the per-env link offsets and sends the model to K3 (penalty) or
    K4 (Newton), as does a model with tendons or another stage only their
    builds have. The stepper's ``check()`` raises if its kernel flagged a
    fault in the steps so far (K2's and K4's held-row overflow; the others
    flag none)."""
    kernel = kernel_for(model, with_link_delta)
    if model.constraint_solver == "newton":
        # the rows' static constants (invweight0 and the solver defaults)
        # are load-time numpy, filled once before the first launch
        ensure_solver_params(model)

    def frame_step(q: torch.Tensor, qd: torch.Tensor, ctrl: torch.Tensor, *delta):
        args = (model, q.T.contiguous(), qd.T.contiguous(), ctrl.T.contiguous(), frame_skip)
        if delta and kernel in (K3, K4):
            q2, qd2 = kernel(*args, link_delta=delta[0].reshape(q.shape[0], -1).T.contiguous())
        else:
            q2, qd2 = kernel(*args)
        return q2.T, qd2.T

    frame_step.check = kernel.check
    return frame_step
