"""Each task's plain step, one module per ``reference_env`` name of a
configuration file: ``ReferenceEnv(constraint_solver)`` with ``physics``,
``obs_reward`` and the model it loads from the committed asset."""
