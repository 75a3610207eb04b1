"""``setup_s``: process start to the start of the window: imports, the
kernels' build or load, the agent, the weights and the first iterations
(the first of which warms every shape the window uses)."""


def read(data):
    return data["setup_s"]
