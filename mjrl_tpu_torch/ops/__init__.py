"""Math core: distributions, GAE, conjugate gradient, raveling."""

from mjrl_tpu_torch.ops.distributions import DiagGaussian  # noqa: F401
from mjrl_tpu_torch.ops.gae import (  # noqa: F401
    compute_advantages,
    compute_gae,
    compute_returns,
    masked_mean_std,
)
from mjrl_tpu_torch.ops.cg import cg_solve  # noqa: F401
from mjrl_tpu_torch.ops.ravel import ravel  # noqa: F401
