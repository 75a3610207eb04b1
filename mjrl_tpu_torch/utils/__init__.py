"""The training harness: run configs, the train loop, logs and checkpoints,
and policy evaluation."""

from mjrl_tpu_torch.utils.evaluation import evaluate_policy, export_rollout  # noqa: F401
