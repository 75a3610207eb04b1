"""``host_ops_per_step``: ATen ops the sampler dispatches per control step
at the cell's batch (a dispatch counter over 4 steps less over 2, after
the window); a count that repeats exactly."""


def read(data):
    return data.get("host_ops_per_step")
