"""``device_idle_pct``: 100 less the union of the device's busy intervals
in the profiled iteration, as a share of an unprofiled iteration's wall
time (the mean of the traced window's others). The profiler inflates the
host's time, so a profiled wall time would overstate the idle share."""

import statistics


def read(data):
    prof, phases = data.get("profile"), data.get("phases")
    if not prof or not phases or prof["busy_s"] <= 0:
        return None
    wall_s = statistics.fmean(p["wall"] for p in phases) * 1e-3
    return 100.0 * (1.0 - prof["busy_s"] / wall_s)
