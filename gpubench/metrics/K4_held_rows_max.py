"""``K4_held_rows_max``: the most contact rows one env-substep of K4 held
in the traced iterations, from the kernel's own held-row counter (its
largest); the build holds 96 (``pkernel.HELD_CLASSES``), and an
env-substep with more is the overflow that fails an iteration."""

from gpubench.program_trace import readings


def read(data):
    its = [it for it in readings(data) or [] if "K4.held_rows_max" in it["peaks"]]
    return max(it["peaks"]["K4.held_rows_max"] for it in its) if its else None
