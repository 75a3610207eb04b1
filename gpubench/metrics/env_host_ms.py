"""``env_host_ms``: the env's own host time in one control step: the self
time of the program's ``env.step`` span (kinematics, reward, the guard,
the observation; the frame stepper's span taken out) per ``sampler.step``,
pooled over the traced iterations (``program_trace.py``)."""

from gpubench.program_trace import per_step


def read(data):
    return per_step(data, "env.step", "self_ms")
