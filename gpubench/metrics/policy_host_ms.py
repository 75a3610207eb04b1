"""``policy_host_ms``: host time of the policy in one control step: the
program's ``sampler.policy`` span (forward pass, sample, log-probability)
per ``sampler.step``, pooled over the traced iterations
(``program_trace.py``)."""

from gpubench.program_trace import per_step


def read(data):
    return per_step(data, "sampler.policy")
