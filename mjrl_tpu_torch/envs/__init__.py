"""Environments; ``envs.make(env_id)`` builds a registered one."""

from mjrl_tpu_torch.envs.base import Env, EnvState, make, register  # noqa: F401
import mjrl_tpu_torch.envs.locomotion  # noqa: F401
