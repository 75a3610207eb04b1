"""``sync_wait_ms``: time the host was blocked reading device values back per
iteration: the program's ``host_read`` waits (CG's ``rdotr``, the kernels'
``check()``) summed over their names, per traced iteration
(``program_trace.py``)."""

from gpubench.program_trace import reads_per_iteration


def read(data):
    return reads_per_iteration(data, "wait_ms")
