"""``rollout_ms``: the host clock around the rollout phase of each iteration,
between syncs, averaged over the traced window's unprofiled iterations
(the harness's spans, ``configs/<config>.json``'s ``spans``)."""

from gpubench.harness import phase_mean


def read(data):
    return phase_mean(data, "rollout")
