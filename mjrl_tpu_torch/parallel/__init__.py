"""Env-axis data parallelism: D ranks of a ``torch.distributed`` group, each
with a block of the env rows (twin of ``mjrl_tpu/parallel``)."""

from mjrl_tpu_torch.parallel import dist  # noqa: F401
