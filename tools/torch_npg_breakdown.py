"""Where one NPG iteration of the PyTorch port spends its time, on a GPU.

    python3 tools/torch_npg_breakdown.py [--row penalty|newton|hopper]

Builds the agent of one row: the bench's ant rows at their width (1024
envs x 100 steps, policy (64, 64), MLPBaseline(epochs=2, batch_size=1024),
normalized_step_size=0.05), ``penalty`` (episodes mode, kernel K1) or
``newton`` (Newton solver, n_substeps=1, samples mode with the persistent
sampler carry, kernel K2); or ``hopper``, examples/hopper_npg.json as
``python -m mjrl_tpu_torch.train`` builds it (256 envs x 1000 steps,
episodes mode, kernel K1). Warms it for 2 iterations, then times one iteration
phase by phase on the host clock (each phase ends in
``torch.cuda.synchronize()``), and traces a second one with
``torch.profiler`` for the device's busy share (device time over the
profiled wall time, which the profiler inflates) and the kernel's share.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mjrl_tpu_torch.algos import NPG
    from mjrl_tpu_torch.envs import make
    from mjrl_tpu_torch.models import GaussianMLP, MLPBaseline
    from mjrl_tpu_torch.physics.pkernel import K1, K2
    from mjrl_tpu_torch.samplers import (
        draw_autoreset_noise,
        draw_episode_noise,
        rollout_statistics,
        run_autoreset,
        run_episodes,
    )
    from mjrl_tpu_torch.utils.configs import RunConfig, build

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--row", choices=("penalty", "newton", "hopper"), default="penalty")
    row = p.parse_args().row
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    newton = row == "newton"
    kernel = K2 if newton else K1
    if row == "hopper":
        cfg = RunConfig.from_json(str(ROOT / "examples" / "hopper_npg.json"))
        env, policy, baseline, agent = build(cfg, device=dev)
        num_envs, horizon = cfg.num_traj, cfg.horizon
    else:
        num_envs, horizon = 1024, 100
        if newton:
            env = make("ant", horizon=horizon, device=dev, constraint_solver="newton", n_substeps=1)
            kw = dict(num_samples=num_envs * horizon, sample_mode="samples")
        else:
            env = make("ant", horizon=horizon, device=dev)
            kw = dict(horizon=horizon)
        init = torch.Generator().manual_seed(0)
        policy = GaussianMLP(env.spec, hidden_sizes=(64, 64), generator=init).to(dev)
        baseline = MLPBaseline(env.spec, epochs=2, batch_size=1024, generator=init).to(dev)
        agent = NPG(env, policy, baseline, normalized_step_size=0.05, num_traj=num_envs, **kw)
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(2):
        agent.train_step(gen)

    phases = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        phases[name] = (time.perf_counter() - t0) * 1e3
        return out

    def rollout():
        if not newton:
            noise = timed("noise", lambda: draw_episode_noise(env, num_envs, horizon, gen))
            return timed("rollout", lambda: run_episodes(env, policy, noise))
        noise = timed("noise", lambda: draw_autoreset_noise(env, num_envs, horizon, gen))
        batch, agent.sampler_carry = timed(
            "rollout", lambda: run_autoreset(env, policy, noise, agent.sampler_carry, horizon))
        return batch

    def iteration():
        t0 = time.perf_counter()
        batch = rollout()
        batch = timed("returns_gae", lambda: agent.process_batch(batch))
        timed("npg_update", lambda: agent.update(batch))
        timed("baseline_fit", lambda: baseline.fit(batch, generator=gen))
        timed("statistics", lambda: rollout_statistics(batch).mean.item())
        return (time.perf_counter() - t0) * 1e3

    plain_wall = iteration()
    plain_phases = dict(phases)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = iteration()

    def device_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, copies, sets): CPU ops and the GPU
    # copies of user annotations (Optimizer.step) also carry the device time
    # of the kernels under them, which would count twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    busy = sum(device_us(e) for e in events) / 1e3
    kernel_ms = sum(device_us(e) for e in events if kernel.name in e.key) / 1e3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    top = sorted(events, key=device_us, reverse=True)[:8]
    print(json.dumps({
        "card": smi, "row": row, "wall_ms": plain_wall, "phases_ms": plain_phases,
        "profiled_wall_ms": wall, "profiled_phases_ms": phases, "device_busy_ms": busy,
        "device_busy_share": busy / wall, "kernel": kernel.name, "kernel_device_ms": kernel_ms,
        "kernel_launches": kernel.launches, "num_envs": num_envs, "horizon": horizon,
        "top_device_ms": {e.key[:60]: device_us(e) / 1e3 for e in top},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
