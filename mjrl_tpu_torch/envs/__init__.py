"""Environments; ``envs.make(env_id)`` builds a registered one."""

from mjrl_tpu_torch.envs.base import Env, EnvState, make, register  # noqa: F401
import mjrl_tpu_torch.envs.locomotion  # noqa: F401
import mjrl_tpu_torch.envs.adroit  # noqa: F401
import mjrl_tpu_torch.envs.point_mass  # noqa: F401
import mjrl_tpu_torch.envs.classic  # noqa: F401
