"""Agents: the policy-gradient base (the ``reinforce`` agent), NPG, TRPO,
PPO, DAPG, BC and model-based NPG."""

from mjrl_tpu_torch.algos.base import BatchREINFORCE  # noqa: F401
from mjrl_tpu_torch.algos.bc import BC  # noqa: F401
from mjrl_tpu_torch.algos.dapg import DAPG  # noqa: F401
from mjrl_tpu_torch.algos.model_npg import ModelAccelNPG  # noqa: F401
from mjrl_tpu_torch.algos.npg import NPG  # noqa: F401
from mjrl_tpu_torch.algos.ppo import PPO  # noqa: F401
from mjrl_tpu_torch.algos.trpo import TRPO  # noqa: F401
