"""Function approximators: the Gaussian policies, the baselines and the
dynamics ensemble of model-based NPG."""

from mjrl_tpu_torch.models.gaussian_mlp import GaussianLinear, GaussianMLP  # noqa: F401
from mjrl_tpu_torch.models.baselines import (  # noqa: F401
    Baseline,
    LinearBaseline,
    MLPBaseline,
    QuadraticBaseline,
    ZeroBaseline,
)
from mjrl_tpu_torch.models.mlp import MLP  # noqa: F401
from mjrl_tpu_torch.models.dynamics import DynamicsEnsemble, transition_pairs  # noqa: F401
