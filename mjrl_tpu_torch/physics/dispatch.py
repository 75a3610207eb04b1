"""Batched frame stepping: batch-first env state in, one kernel launch per step.

Twin of ``mjrl_tpu/physics/dispatch.py::make_frame_stepper``. The env keeps
its state batch-first (``(B, nq)``, ``(B, nv)``); the stepper transposes to
the kernels' batch-last layout once per control step and advances all
``frame_skip x n_substeps`` substeps in one call of physics/pkernel.py's
``K1`` (penalty solver), ``K2`` (Newton solver), ``K3`` (penalty, with
tendons, per-env link offsets or another of Adroit's stages) or ``K4``
(Newton, with those stages), which launch the CUDA kernel for CUDA tensors
and run the plain version for CPU tensors.

As in the reference, a model outside the kernels' feature set (a ball
joint, a plane on a moving link: ``soa.soa_supported``) and a stepper
asked for with ``use_soa=False`` run the per-env engine instead
(physics/engine.py: ``frame_skip`` calls of ``engine.step`` on the
batch-first tensors, no kernel). Nothing else reaches the engine: on the
card Adroit runs K3 or K4 or raises, and no process-wide switch moves a
model off its kernel.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from mjrl_tpu_torch.physics import engine, soa
from mjrl_tpu_torch.physics.csolve import ensure_solver_params
from mjrl_tpu_torch.physics.model import Model
from mjrl_tpu_torch.physics.pkernel import KERNELS
from mjrl_tpu_torch.utils import trace

FrameStepper = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def kernel_for(model: Model, with_link_delta: bool = False):
    """The kernel that steps ``model``: K1 or K3 (penalty), K2 or K4
    (Newton), the latter of each when the env carries link offsets or the
    model has a stage only their builds have."""
    return KERNELS[model.constraint_solver, with_link_delta or soa.needs_ext(model)]


def uses_engine(model: Model, use_soa: Optional[bool] = None) -> bool:
    """True if the frame stepper runs ``model`` on the per-env engine:
    ``use_soa=False``, or a model the kernels do not step (raises for a
    solver neither has)."""
    if model.constraint_solver not in ("penalty", "newton"):
        raise NotImplementedError(f"solver {model.constraint_solver!r} is not ported")
    return use_soa is False or not soa.soa_supported(model)


def check_model(model: Model, use_soa: Optional[bool] = None) -> None:
    """What an env checks of its model at construction: the kernels'
    feature set (``soa.check_supported``), unless the model runs on the
    engine, which takes every joint type and contact kind."""
    if not uses_engine(model, use_soa):
        soa.check_supported(model)


def make_frame_stepper(model: Model, frame_skip: int, with_link_delta: bool = False,
                       use_soa: Optional[bool] = None) -> FrameStepper:
    """``(q (B, nq), qd (B, nv), ctrl (B, nu)[, link_delta (B, nlink, 3)])
    -> (q, qd)`` over ``frame_skip`` control frames; ``with_link_delta``
    adds the per-env link offsets and sends the model to K3 (penalty) or
    K4 (Newton), as does a model with tendons or another stage only their
    builds have. With ``use_soa=False``, or for a model outside the
    kernels' set, the per-env engine steps it (:func:`uses_engine`). The
    stepper's ``path`` names what it runs (``"K1"`` to ``"K4"`` or
    ``"engine"``); traced, each call is the span ``physics.frame_step``
    (the transposes and the kernel's launch, or the engine's steps); its
    ``check()`` raises if its kernel flagged a fault in
    the steps so far (K2's and K4's held-row overflow; the others flag
    none, nor does the engine)."""
    on_engine = uses_engine(model, use_soa)
    if model.constraint_solver == "newton":
        # the rows' static constants (invweight0 and the solver defaults)
        # are load-time numpy, filled once before the first step
        ensure_solver_params(model)

    if on_engine:
        @trace.spanned("physics.frame_step")
        def frame_step(q: torch.Tensor, qd: torch.Tensor, ctrl: torch.Tensor, *delta):
            state = engine.PhysicsState(q=q, qd=qd)
            for _ in range(frame_skip):
                state = engine.step(model, state, ctrl, link_pos_delta=delta[0] if delta else None)
            return state.q, state.qd

        frame_step.path = "engine"
        frame_step.check = lambda: None
        return frame_step

    kernel = kernel_for(model, with_link_delta)

    @trace.spanned("physics.frame_step")
    def frame_step(q: torch.Tensor, qd: torch.Tensor, ctrl: torch.Tensor, *delta):
        args = (model, q.T.contiguous(), qd.T.contiguous(), ctrl.T.contiguous(), frame_skip)
        if delta and kernel.ext:
            q2, qd2 = kernel(*args, link_delta=delta[0].reshape(q.shape[0], -1).T.contiguous())
        else:
            q2, qd2 = kernel(*args)
        return q2.T, qd2.T

    frame_step.path = kernel.label
    frame_step.check = kernel.check
    return frame_step
