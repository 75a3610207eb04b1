"""Function approximators: the Gaussian policy and the MLP baseline."""

from mjrl_tpu_torch.models.gaussian_mlp import GaussianMLP  # noqa: F401
from mjrl_tpu_torch.models.baselines import Baseline, MLPBaseline  # noqa: F401
from mjrl_tpu_torch.models.mlp import MLP  # noqa: F401
