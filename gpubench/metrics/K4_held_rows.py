"""``K4_held_rows``: contact rows K4 holds per env-substep, from the
kernel's own held-row counter (its ``held_stats``, read with the overflow
count at ``check()`` while the program's tracer is on): the rows' sum over
the env-substeps launched, pooled over the traced iterations
(``program_trace.py``)."""

from gpubench.program_trace import readings


def read(data):
    its = readings(data) or []
    substeps = sum(it["counters"].get("K4.env_substeps", 0) for it in its)
    if not substeps:
        return None
    return sum(it["counters"].get("K4.held_rows", 0) for it in its) / substeps
