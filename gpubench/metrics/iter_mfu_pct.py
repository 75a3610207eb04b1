"""``iter_mfu_pct``: the iteration's counted f32 operations
(``yardstick.iteration_ops``: the frozen physics counts, the policy's and
baseline's passes and the CG products from their widths) over the mean
unprofiled iteration time of the traced window times the f32 peak."""

import statistics
import sys

from gpubench import yardstick


def read(data):
    phases = data.get("phases")
    if not phases:
        return None
    cell = data["cell"]
    job = cell.config["job"]
    bkw = job.get("baseline_kwargs", {})
    held = data.get("held_rows") if cell.solver == "newton" else None
    ops = yardstick.iteration_ops(
        cell.counts, cell.solver, data["num_traj"], data["horizon"], data["obs_dim"],
        data["act_dim"], job.get("hidden_sizes", (64, 64)), bkw.get("hidden_sizes", (128, 128)),
        bkw.get("epochs", 1), bkw.get("batch_size", 64),
        job.get("agent_kwargs", {}).get("FIM_invert_args", {}).get("iters", 10), held)
    wall_s = statistics.fmean(p["wall"] for p in phases) * 1e-3
    print(f"gpubench iter_mfu_pct: ops {ops!r}, iteration {wall_s!r} s", file=sys.stderr)
    return 100.0 * sum(ops.values()) / (wall_s * yardstick.PEAKS["f32_flops_per_s"])
