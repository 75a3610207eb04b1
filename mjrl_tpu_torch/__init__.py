"""mjrl_tpu_torch: the PyTorch + CUDA port of mjrl_tpu for one NVIDIA H100.

It mirrors the JAX package's module names (``physics``, ``envs``, ``ops``,
``models``, ``samplers``, ``algos``) and never imports JAX or mjrl_tpu.
The main path is one Ant NPG iteration: rollout through the hand-written
CUDA physics kernel (physics/pkernel.py), GAE, a CG natural gradient and the
MLP baseline fit.
"""

__version__ = "0.1.0"

import torch as _torch

# f32 everywhere, as mjrl_tpu/__init__.py pins JAX's matmul precision: the
# physics and the Fisher products lose parity at TF32's ~3 digits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from mjrl_tpu_torch.types import EnvSpec, TrajectoryBatch  # noqa: E402,F401
