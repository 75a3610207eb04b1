"""Batched frame stepping: batch-first env state in, one kernel launch per step.

Twin of ``mjrl_tpu/physics/dispatch.py::make_frame_stepper``. The env keeps
its state batch-first (``(B, nq)``, ``(B, nv)``); the stepper transposes to
the kernels' batch-last layout once per control step and advances all
``frame_skip x n_substeps`` substeps in one call of physics/pkernel.py's
``K1`` (penalty solver) or ``K2`` (Newton solver), which launch the CUDA
kernel for CUDA tensors and run the plain version for CPU tensors.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from mjrl_tpu_torch.physics.csolve import ensure_solver_params
from mjrl_tpu_torch.physics.model import Model
from mjrl_tpu_torch.physics.pkernel import K1, K2

FrameStepper = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def make_frame_stepper(model: Model, frame_skip: int) -> FrameStepper:
    """``(q (B, nq), qd (B, nv), ctrl (B, nu)) -> (q, qd)`` over
    ``frame_skip`` control frames."""
    if model.constraint_solver == "newton":
        # the rows' static constants (invweight0 and the solver defaults)
        # are load-time numpy, filled once before the first launch
        ensure_solver_params(model)
        kernel = K2
    else:
        kernel = K1

    def frame_step(q: torch.Tensor, qd: torch.Tensor, ctrl: torch.Tensor):
        q2, qd2 = kernel(
            model, q.T.contiguous(), qd.T.contiguous(), ctrl.T.contiguous(), frame_skip
        )
        return q2.T, qd2.T

    return frame_step
