"""``step_host_ms``: host time of one control step: the program's
``sampler.step`` span (policy, env, physics and the sampler's
bookkeeping), its total over its count, pooled over the traced iterations
(``program_trace.py``)."""

from gpubench.program_trace import per_step


def read(data):
    return per_step(data, "sampler.step")
