"""Function approximators: the Gaussian policy and the baselines."""

from mjrl_tpu_torch.models.gaussian_mlp import GaussianMLP  # noqa: F401
from mjrl_tpu_torch.models.baselines import (  # noqa: F401
    Baseline,
    LinearBaseline,
    MLPBaseline,
    QuadraticBaseline,
    ZeroBaseline,
)
from mjrl_tpu_torch.models.mlp import MLP  # noqa: F401
