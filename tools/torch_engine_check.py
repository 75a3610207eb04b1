"""The per-env engine against the kernels' plain version: the spread that
sets chip_smoke.py's phase-16 tolerances, the engine's ops per control step
and its time.

    python3 tools/torch_engine_check.py [--device cpu|cuda] [--batch 256] [ROW ...]

ROWs are chip_smoke.py's ``ENGINE_ROWS`` (ant, hopper_newton, pen,
pen_newton; all by default). On each row's states (``engine_row_states``:
the states of the phase that holds that row's kernel, at ``--batch``
envs) it takes one control step of the engine (physics/engine.py through
the frame stepper with ``use_soa=False``) and of the plain version
(physics/soa.py, physics/soa_newton.py) from the same state and prints,
for q and qd, the max and the 99% quantile of the per-env max |err|, and
the tolerance chip_smoke.py derives from it: ten times the reading,
rounded up to a power of ten. It also counts the aten ops one engine
control step issues (each a launch on the card) and times it (CUDA events
on the card; the wall clock on the CPU, which is no device time). The last
lines: one JSON object with every reading, and on the card its name and
power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    ENGINE_ROWS,
    engine_control_step,
    engine_row_env,
    engine_row_states,
)
from mjrl_tpu_torch.physics import soa  # noqa: E402

QUANTILE = 0.99


def count_ops(fn) -> int:
    """The aten ops ``fn()`` dispatches (views and in-place ops included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def timed_ms(fn, device, reps=3) -> float:
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def up_to_power_of_ten(x: float) -> float:
    return 10.0 ** math.ceil(math.log10(max(x, 1e-12)))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("rows", nargs="*", default=[r[0] for r in ENGINE_ROWS])
    p.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    p.add_argument("--batch", type=int, default=256)
    args = p.parse_args()
    torch.set_num_threads(max(1, torch.get_num_threads()))
    out = {}
    for row in args.rows:
        env = engine_row_env(row, args.device)
        model, frames = env.model, env.frame_skip
        q, qd, delta, ctrl = engine_row_states(row, env, args.batch)
        eq, eqd = engine_control_step(model, frames, q, qd, ctrl, delta)
        pq, pqd = soa.multistep(model, q, qd, ctrl, frames, link_delta=delta)
        reading = {}
        for name, got, want in (("q", eq, pq), ("qd", eqd, pqd)):
            per_env = (got - want).abs().amax(dim=0)
            worst, quant = float(per_env.max()), float(torch.quantile(per_env, QUANTILE))
            reading[name] = {"max": worst, "quantile": quant,
                             "tol_max": up_to_power_of_ten(10 * worst),
                             "tol_quantile": up_to_power_of_ten(10 * quant)}
            print(f"[{row}] engine vs plain, one control step at B={args.batch} on "
                  f"{args.device}: {name} max |err| {worst:.3e}, {QUANTILE:.0%} quantile "
                  f"{quant:.3e} -> tolerance {reading[name]['tol_max']:.0e} "
                  f"(quantile {reading[name]['tol_quantile']:.0e})")
        step = lambda: engine_control_step(model, frames, q, qd, ctrl, delta)  # noqa: E731
        reading["ops_per_control_step"] = count_ops(step)
        reading["ms"] = timed_ms(step, q.device)
        print(f"[{row}] engine: {reading['ops_per_control_step']} aten ops per control step "
              f"({frames} frames x {model.n_substeps} substeps), {reading['ms']:.3f} ms "
              f"({'CUDA events' if q.device.type == 'cuda' else 'wall clock, CPU'})")
        out[row] = reading
    print(json.dumps({"engine_check": out, "device": args.device, "batch": args.batch}))
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())


if __name__ == "__main__":
    main()
