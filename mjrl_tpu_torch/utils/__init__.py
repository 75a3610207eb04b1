"""The training harness: run configs, the train loop, logs and checkpoints."""
