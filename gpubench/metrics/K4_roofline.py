"""``K4_roofline``: K4's share of its roofline, %: the least time of one
launch (the frozen f32 operation count over the f32 peak, or its bytes
over the HBM peak, whichever is larger) over ``kernel_ms``
(``yardstick.roofline_pct``)."""

from gpubench.yardstick import roofline_pct


def read(data):
    return roofline_pct(data, "K4")
