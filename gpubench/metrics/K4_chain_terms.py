"""``K4_chain_terms``: the terms of K4's Hessian assembly per env-substep,
from the kernel's own stats buffer (read with the overflow count at
``check()`` while the program's tracer is on): ``K4.chain_terms`` (per
env-substep, n + n (n + 1) / 2 for each held contact row whose chain has
n dofs, 1 for each limit row) over ``K4.env_substeps``, pooled over the
traced iterations (``program_trace.py``). None where the port counts no
chain terms (the plain version on the CPU, a port without the counter)."""

from gpubench.program_trace import readings


def read(data):
    its = [it for it in readings(data) or [] if "K4.chain_terms" in it["counters"]]
    substeps = sum(it["counters"].get("K4.env_substeps", 0) for it in its)
    if not substeps:
        return None
    return sum(it["counters"]["K4.chain_terms"] for it in its) / substeps
