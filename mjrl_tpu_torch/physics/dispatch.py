"""Batched frame stepping: batch-first env state in, one kernel launch per step.

Twin of ``mjrl_tpu/physics/dispatch.py::make_frame_stepper``. The env keeps
its state batch-first (``(B, nq)``, ``(B, nv)``); the stepper transposes to
the kernels' batch-last layout once per control step and advances all
``frame_skip x n_substeps`` substeps in one call of physics/pkernel.py's
``K1`` (penalty solver), ``K2`` (Newton solver) or ``K3`` (penalty, with
tendons, per-env link offsets or another of Adroit's stages), which launch
the CUDA kernel for CUDA tensors and run the plain version for CPU tensors.
Unlike the reference, no model is sent to a per-env engine: on the card
Adroit runs K3 or raises.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from mjrl_tpu_torch.physics import soa
from mjrl_tpu_torch.physics.csolve import ensure_solver_params
from mjrl_tpu_torch.physics.model import Model
from mjrl_tpu_torch.physics.pkernel import K1, K2, K3

FrameStepper = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def make_frame_stepper(model: Model, frame_skip: int, with_link_delta: bool = False
                       ) -> FrameStepper:
    """``(q (B, nq), qd (B, nv), ctrl (B, nu)[, link_delta (B, nlink, 3)])
    -> (q, qd)`` over ``frame_skip`` control frames; ``with_link_delta``
    adds the per-env link offsets and sends the model to K3, as does a
    model with tendons or another stage only K3's build has."""
    if model.constraint_solver == "newton":
        # the rows' static constants (invweight0 and the solver defaults)
        # are load-time numpy, filled once before the first launch
        ensure_solver_params(model)
        kernel = K2
    elif with_link_delta or soa.needs_ext(model):
        kernel = K3
    else:
        kernel = K1

    def frame_step(q: torch.Tensor, qd: torch.Tensor, ctrl: torch.Tensor, *delta):
        args = (model, q.T.contiguous(), qd.T.contiguous(), ctrl.T.contiguous(), frame_skip)
        if kernel is K3 and delta:
            q2, qd2 = K3(*args, link_delta=delta[0].reshape(q.shape[0], -1).T.contiguous())
        else:
            q2, qd2 = kernel(*args)
        return q2.T, qd2.T

    return frame_step
