"""Where one Ant NPG iteration of the PyTorch port spends its time, on a GPU.

    python3 tools/torch_npg_breakdown.py

Builds the bench-width agent (1024 envs x 100 steps, policy (64, 64),
MLPBaseline(epochs=2, batch_size=1024), normalized_step_size=0.05), warms
it for 2 iterations, then times one iteration phase by phase on
the host clock (each phase ends in ``torch.cuda.synchronize()``), and
traces a second one with ``torch.profiler`` for the device's busy share
(device time over the profiled wall time, which the profiler inflates) and
K1's share.
Prints one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mjrl_tpu_torch.algos import NPG
    from mjrl_tpu_torch.envs import make
    from mjrl_tpu_torch.models import GaussianMLP, MLPBaseline
    from mjrl_tpu_torch.physics.pkernel import K1
    from mjrl_tpu_torch.samplers import draw_episode_noise, rollout_statistics, run_episodes

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    env = make("ant", horizon=100, device=dev)
    init = torch.Generator().manual_seed(0)
    policy = GaussianMLP(env.spec, hidden_sizes=(64, 64), generator=init).to(dev)
    baseline = MLPBaseline(env.spec, epochs=2, batch_size=1024, generator=init).to(dev)
    agent = NPG(env, policy, baseline, normalized_step_size=0.05, num_traj=1024, horizon=100)
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

    def iteration():
        t0 = time.perf_counter()
        noise = timed("noise", lambda: draw_episode_noise(env, 1024, 100, gen))
        batch = timed("rollout", lambda: run_episodes(env, policy, noise))
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
    k1 = sum(device_us(e) for e in events if "mj_multistep" in e.key) / 1e3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    top = sorted(events, key=device_us, reverse=True)[:8]
    print(json.dumps({
        "card": smi, "wall_ms": plain_wall, "phases_ms": plain_phases,
        "profiled_wall_ms": wall, "profiled_phases_ms": phases, "device_busy_ms": busy,
        "device_busy_share": busy / wall, "k1_device_ms": k1,
        "k1_launches": K1.launches,
        "top_device_ms": {e.key[:60]: device_us(e) / 1e3 for e in top},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
