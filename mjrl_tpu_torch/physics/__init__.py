"""First-party rigid-body physics in PyTorch: the numpy model, its static
tables, the plain batch-last stepper and CUDA kernel K1."""

from mjrl_tpu_torch.physics.model import Model, ModelBuilder  # noqa: F401
from mjrl_tpu_torch.physics.mjcf import load_mjcf  # noqa: F401
