"""The training harness: run configs, the train loop, logs and checkpoints,
policy evaluation and the program's tracer (``utils/trace.py``)."""


def __getattr__(name):
    # evaluate_policy and export_rollout on first use: the physics kernels
    # import utils.trace, and an eager import of utils.evaluation here
    # (samplers, envs, physics) would come back to them half-initialised
    if name in ("evaluate_policy", "export_rollout"):
        from mjrl_tpu_torch.utils import evaluation
        return getattr(evaluation, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
