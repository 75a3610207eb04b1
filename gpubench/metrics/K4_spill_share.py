"""``K4_spill_share``: the share of K4's env-substeps that hold a contact
row in device memory, from the kernel's own stats buffer (read with the
overflow count at ``check()`` while the program's tracer is on):
``K4.spill_substeps`` (env-substeps holding more rows than the build keeps
in shared memory, 14 of 96 in the Adroit class) over ``K4.env_substeps``,
pooled over the traced iterations (``program_trace.py``), in %. None where
the port counts no such substeps (the plain version on the CPU, a port
without the counter)."""

from gpubench.program_trace import readings


def read(data):
    its = [it for it in readings(data) or [] if "K4.spill_substeps" in it["counters"]]
    substeps = sum(it["counters"].get("K4.env_substeps", 0) for it in its)
    if not substeps:
        return None
    return 100.0 * sum(it["counters"]["K4.spill_substeps"] for it in its) / substeps
