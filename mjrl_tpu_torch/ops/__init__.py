"""Math core: distributions, GAE, conjugate gradient, raveling, ridge least
squares."""

from mjrl_tpu_torch.ops.distributions import DiagGaussian  # noqa: F401
from mjrl_tpu_torch.ops.gae import (  # noqa: F401
    compute_advantages,
    compute_gae,
    compute_returns,
    discount_sum,
    masked_mean_std,
)
from mjrl_tpu_torch.ops.cg import cg_solve  # noqa: F401
from mjrl_tpu_torch.ops.lstsq import ridge_solve  # noqa: F401
from mjrl_tpu_torch.ops.ravel import ravel  # noqa: F401
