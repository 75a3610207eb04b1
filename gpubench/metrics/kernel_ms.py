"""``kernel_ms``: device time per launch of the cell's kernel, by its
symbol, from ``torch.profiler``'s device events over the traced window's
profiled iteration."""


def read(data):
    prof = data.get("profile")
    return prof.get("kernel_ms") if prof else None
