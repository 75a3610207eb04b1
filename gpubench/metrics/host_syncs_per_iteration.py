"""``host_syncs_per_iteration``: the program's reads of device values per
iteration: the count of its ``host_read`` calls summed over their names,
per traced iteration (``program_trace.py``); a count that repeats where CG
runs its full iterations."""

from gpubench.program_trace import reads_per_iteration


def read(data):
    return reads_per_iteration(data, "count")
