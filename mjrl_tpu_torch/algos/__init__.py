"""Agents: the policy-gradient base and NPG."""

from mjrl_tpu_torch.algos.base import BatchREINFORCE  # noqa: F401
from mjrl_tpu_torch.algos.npg import NPG  # noqa: F401
