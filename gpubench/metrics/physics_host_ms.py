"""``physics_host_ms``: host time of the frame stepper in one control step:
the program's ``physics.frame_step`` span (the transposes,
``.contiguous()`` and the kernel wrapper's launch) per ``sampler.step``,
pooled over the traced iterations (``program_trace.py``)."""

from gpubench.program_trace import per_step


def read(data):
    return per_step(data, "physics.frame_step")
