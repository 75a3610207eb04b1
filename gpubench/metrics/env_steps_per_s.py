"""``env_steps_per_s``: valid env-steps (transitions inside an episode) of
every iteration completed in the window, over the window's time from the
start of its first iteration to the end of its last, which ends in the
metrics' read-back."""


def read(data):
    return data["valid_steps"] / data["window_s"] if data["window_s"] > 0 else None
