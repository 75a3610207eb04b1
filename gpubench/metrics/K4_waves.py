"""``K4_waves``: the waves of blocks a K4 launch takes on the card, the
mean over the traced iterations' launches (``program_trace.py``): the
port's ``K4.waves`` over its ``K4.launches``, each launch counting
ceil(blocks / (SMs x blocks an SM holds)), the SMs' hold read from the
built kernel's occupancy at the launch's shared bytes. None where no
launch was counted (the plain version on the CPU, a port without the
counter)."""

from gpubench.program_trace import readings


def read(data):
    its = readings(data) or []
    launches = sum(it["counters"].get("K4.launches", 0) for it in its)
    if not launches:
        return None
    return sum(it["counters"].get("K4.waves", 0) for it in its) / launches
