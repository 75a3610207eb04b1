"""The program's own spans, counters and device reads in a traced run.

The port's tracer (``mjrl_tpu_torch/utils/trace.py``) records spans inside
the program: ``train_step`` over its phases, each control step
(``sampler.step``) over the policy (``sampler.policy``), the env
(``env.step``) and the frame stepper (``physics.frame_step``); every read
of a device value (``host_read``) with the time the host was blocked in
it; and, from K2's and K4's held-row counter, the contact rows each
env-substep holds. The harness's traced run reads its per-layer metrics
from ``data`` after the window; the first of these readers to ask
(:func:`readings`) builds the cell's program again, at the window's batch
and horizon with the run's ``--seed``, runs one iteration to warm it and
then ``ITERATIONS`` iterations with the tracer on, each followed by the
window's single read-back, and keeps each iteration's ``trace.take()``.
The window itself runs with the tracer off, as the untraced runs do.

A checkout whose port has no tracer gives nothing: every reader returns
None there. Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import traceback
from typing import Any, Dict, List, Optional

import torch

from gpubench import harness

ITERATIONS = 5
_cache: List[Any] = [None, None]  # the run's data and its readings


def run_seed() -> int:
    """The run's ``--seed`` (``run.py``'s command line), or 0."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_known_args(sys.argv[1:])[0].seed


def readings(data: Dict[str, Any]) -> Optional[List[Dict[str, Any]]]:
    """Each traced iteration's ``trace.take()``, measured once per run;
    None where the port has no tracer or the run has no cell."""
    if _cache[0] is data:
        return _cache[1]
    out = None
    cell = data.get("cell")
    if cell is not None:
        try:
            from mjrl_tpu_torch.utils import trace
        except ImportError:
            trace = None
        if trace is not None:
            try:
                out = measure(cell, data["num_traj"], data["horizon"], run_seed(), trace)
            except Exception:  # a reading that fails leaves the run's line without it
                traceback.print_exc(file=sys.stderr)
    _cache[:] = [data, out]
    return out


def measure(cell, num_traj: int, horizon: int, seed: int, trace) -> List[Dict[str, Any]]:
    from mjrl_tpu_torch.train import load_config
    from mjrl_tpu_torch.utils.configs import build

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    t0 = time.perf_counter()
    cfg = load_config(None, cell.overrides({"num_traj": num_traj, "horizon": horizon}))
    env, policy, baseline, agent = build(cfg, device=dev)
    weights = harness.make_weights(seed, env.spec.observation_dim, env.spec.action_dim,
                                   cell.config["job"], dev)
    harness.load_into(policy, weights["policy"], True)
    harness.load_into(baseline, weights["baseline"], False)

    def iteration(i):
        metrics = agent.train_step(harness.iteration_generator(seed, i, dev))
        torch.stack([v.detach().float().reshape(()) for v in metrics.values()]).tolist()

    iteration(0)
    out = []
    trace.reset()
    trace.enable()
    try:
        for i in range(1, 1 + ITERATIONS):
            iteration(i)
            out.append(trace.take())
    finally:
        trace.disable()
        trace.reset()
    del env, policy, baseline, agent
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print("gpubench program trace: " + json.dumps(
        {"iterations": len(out), "seconds": time.perf_counter() - t0, "seed": seed,
         "last": out[-1]}), file=sys.stderr, flush=True)
    return out


def per_step(data: Dict[str, Any], name: str, key: str = "total_ms") -> Optional[float]:
    """Span ``name``'s ``key`` (``total_ms`` or ``self_ms``) per control
    step (``sampler.step``), pooled over the traced iterations."""
    its = readings(data)
    steps = sum(it["spans"].get("sampler.step", {}).get("count", 0) for it in its or [])
    if not steps:
        return None
    return sum(it["spans"].get(name, {}).get(key, 0.0) for it in its) / steps


def reads_per_iteration(data: Dict[str, Any], key: str) -> Optional[float]:
    """The device reads' ``key`` (``count`` or ``wait_ms``), summed over
    their names, per traced iteration."""
    its = readings(data)
    if not its:
        return None
    return sum(sum(r[key] for r in it["reads"].values()) for it in its) / len(its)
