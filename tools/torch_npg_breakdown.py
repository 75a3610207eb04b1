"""Where one training iteration of the PyTorch port spends its time, on a
GPU.

    python3 tools/torch_npg_breakdown.py [--row ROW] [--no-profile] [--demos DIR] [--ranks D]

Builds the agent of one row: the bench's ant rows at their width (1024
envs x 100 steps, policy (64, 64), MLPBaseline(epochs=2, batch_size=1024),
normalized_step_size=0.05), ``penalty`` (episodes mode, kernel K1) or
``newton`` (Newton solver, n_substeps=1, samples mode with the persistent
sampler carry, kernel K2); or a config of ``examples/`` as
``python -m mjrl_tpu_torch.train`` builds it (with its obs_norm, if set):
``hopper`` (hopper_npg.json, 256 envs x 1000 steps, K1), ``hopper_newton``
(hopper_npg_newton.json, 256 x 1000, K2), ``swimmer`` (swimmer_npg.json,
256 x 1000, K1), ``walker2d_trpo`` (walker2d_trpo.json, 4096 x 1000, K1),
``humanoid_trpo`` (humanoid_trpo.json, 1024 x 1000, K1),
``humanoid_ppo`` (humanoid_ppo_v4.json, 4096 x 64-step windows in samples
mode, K1), ``adroit_pen`` (adroit_pen_npg.json, 512 x 100, K3),
``adroit_pen_newton`` (adroit_pen_npg_newton.json, 512 x 100, K4),
``adroit_door`` (adroit_door_npg.json, 512 x 200, K3), ``adroit_hammer``
(adroit_hammer_npg.json at the fixed hammer run's settings: 2048 x 200,
min_log_std -2, baseline batch 4096; K3 and the nail's sensor) or
``adroit_relocate`` (adroit_relocate_scratch.json, 2048 x 200, K3); the
DAPG configs ``adroit_pen_dapg`` (64 x 100, K3), ``adroit_door_dapg`` and
``adroit_hammer_dapg`` (64 x 200, K3), ``adroit_relocate_dapg`` (2048 x
200, K3) and ``hopper_dapg`` (64 x 1000, K1), whose BC warm start on the
config's demo pickle is timed once as ``bc_warm_start`` (``--demos DIR``
reads the pickle of that name from DIR: the card's copy of the repo has
no ``demos/``); or ``point_mass`` (point_mass_npg.json, 64 x 25, no
kernel), whose 16 evaluation episodes after the step are the
``evaluation`` phase; or the model-based NPG configs ``hopper_model_npg``
(hopper_model_npg.json: 64 real episodes x 500 steps on K1, the 4-member
ensemble's 20-epoch fit, 1024 imagined episodes x 500 steps) and
``point_mass_model`` (point_mass_model_npg.json, no kernel), whose
``rollout`` is the real one, followed by the ``ensemble_fit`` and the
``imagined_rollout`` phases, with returns, GAE, the update and the
baseline fit on the imagined batch and the statistics on the real one.
The ``update`` phase is the agent's policy update:
NPG's, TRPO's with its line-search probes, PPO's minibatch Adam epochs,
or DAPG's with the demo surrogate in its gradient.
Warms it for 2 iterations, then times one iteration
phase by phase on the host clock (each phase ends in
``torch.cuda.synchronize()``), and traces a second one with
``torch.profiler`` for the device's busy share (device time over the
profiled wall time, which the profiler inflates) and the kernel's share.
``--no-profile`` skips the traced iteration (humanoid TRPO's takes ~27 min:
the profiler's post-processing of ~2.3M ops). Prints one JSON line.

``--ranks D`` runs the row as D data-parallel ranks (``mesh_devices: D``,
``mjrl_tpu_torch/parallel/dist.py``), spawned processes sharing this
host's first card over gloo, each timing its own phases; every all-reduce
is counted with its bytes and timed between two syncs (``collectives``: per
phase, count, bytes and ms, the wait for the other ranks included). Prints
one JSON line per rank, rank 0's first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CONFIG_ROWS = {"hopper": "hopper_npg.json", "hopper_newton": "hopper_npg_newton.json",
               "swimmer": "swimmer_npg.json", "walker2d_trpo": "walker2d_trpo.json",
               "humanoid_trpo": "humanoid_trpo.json", "humanoid_ppo": "humanoid_ppo_v4.json",
               "adroit_pen": "adroit_pen_npg.json", "adroit_pen_newton": "adroit_pen_npg_newton.json",
               "adroit_door": "adroit_door_npg.json", "adroit_hammer": "adroit_hammer_npg.json",
               "adroit_relocate": "adroit_relocate_scratch.json",
               **{f"{name}_dapg": f"{name}_dapg.json" for name in (
                   "adroit_pen", "adroit_door", "adroit_hammer", "adroit_relocate", "hopper")},
               "point_mass": "point_mass_npg.json", "hopper_model_npg": "hopper_model_npg.json",
               "point_mass_model": "point_mass_model_npg.json"}
# --set overrides of a row's config
ROW_OVERRIDES = {"adroit_hammer": ["num_traj=2048", "min_log_std=-2.0",
                                   'baseline_kwargs={"epochs": 2, "batch_size": 4096}']}


def _count_collectives(stats):
    """Wrap ``torch.distributed.all_reduce`` in this process to add each
    call's count, bytes and ms (between two syncs) to ``stats``."""
    import torch
    import torch.distributed as tdist

    plain = tdist.all_reduce

    def counted(tensor, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain(tensor, *args, **kwargs)
        torch.cuda.synchronize()
        stats["count"] += 1
        stats["bytes"] += tensor.numel() * tensor.element_size()
        stats["ms"] += (time.perf_counter() - t0) * 1e3
        return out

    tdist.all_reduce = counted


def _rank(device, argv, out_dir):
    """One rank of ``--ranks D``: the breakdown on this rank's rows."""
    from mjrl_tpu_torch.parallel import dist

    path = os.path.join(out_dir, f"rank{dist.rank()}.json")
    with open(path, "w") as f:
        json.dump(breakdown(argv, device), f)


def main() -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ranks", type=int, default=1)
    args, rest = p.parse_known_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if args.ranks <= 1:
        print(json.dumps(breakdown(rest, torch.device("cuda"))))
        return 0
    import tempfile

    from mjrl_tpu_torch.parallel import dist

    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = (visible or "0").split(",")[0]  # the ranks share it
    with tempfile.TemporaryDirectory() as out:
        dist.spawn(_rank, args.ranks, "cuda", (rest, out))
        for r in range(args.ranks):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                print(f.read())
    return 0


def breakdown(argv, dev):
    """The breakdown of ``argv``'s row on ``dev`` (this rank's rows in a
    group): the dict that ``main`` prints."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mjrl_tpu_torch.algos import NPG, ModelAccelNPG
    from mjrl_tpu_torch.envs import make
    from mjrl_tpu_torch.models import GaussianMLP, MLPBaseline
    from mjrl_tpu_torch.physics.dispatch import kernel_for
    from mjrl_tpu_torch.samplers import (
        draw_autoreset_noise,
        draw_episode_noise,
        rollout_statistics,
        run_autoreset,
        run_episodes,
        sample_episodes,
    )
    from mjrl_tpu_torch.train import load_config, side_generator
    from mjrl_tpu_torch.utils.configs import build, obs_norm_init, warm_start

    from mjrl_tpu_torch.parallel import dist

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--row", choices=("penalty", "newton", *CONFIG_ROWS), default="penalty")
    p.add_argument("--no-profile", action="store_true")
    p.add_argument("--demos", default=None, help="the directory of the DAPG rows' demo pickles")
    args = p.parse_args(argv)
    row = args.row
    phases, collectives = {}, {}
    stats = {"count": 0, "bytes": 0, "ms": 0.0}
    ranks = dist.world_size()
    if ranks > 1:
        _count_collectives(stats)

    def timed(name, fn):
        torch.cuda.synchronize()
        before = dict(stats)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        phases[name] = (time.perf_counter() - t0) * 1e3
        if ranks > 1:
            collectives[name] = {k: stats[k] - before[k] for k in stats}
        return out

    evaluation = 0
    if row in CONFIG_ROWS:
        overrides = [*ROW_OVERRIDES.get(row, []), f"mesh_devices={ranks if ranks > 1 else 0}"]
        cfg = load_config(ROOT / "examples" / CONFIG_ROWS[row], overrides)
        if cfg.demo_file and args.demos:
            demo_file = os.path.join(args.demos, os.path.basename(cfg.demo_file))
            cfg = load_config(ROOT / "examples" / CONFIG_ROWS[row],
                              [*overrides, f'demo_file="{demo_file}"'])
        env, policy, baseline, agent = build(cfg, device=dev)
        if cfg.bc_init:
            timed("bc_warm_start", lambda: warm_start(cfg, agent, side_generator(cfg.seed, 1, dev)))
        if cfg.obs_norm:
            obs_norm_init(agent, torch.Generator(device=dev).manual_seed(2))
        num_envs, horizon = cfg.num_traj, cfg.horizon or env.spec.horizon
        evaluation = cfg.evaluation_rollouts
    else:
        num_envs, horizon = 1024, 100
        if row == "newton":  # the samples-mode row
            env = make("ant", horizon=horizon, device=dev, constraint_solver="newton", n_substeps=1)
            kw = dict(num_samples=num_envs * horizon, sample_mode="samples")
        else:
            env = make("ant", horizon=horizon, device=dev)
            kw = dict(horizon=horizon)
        init = torch.Generator().manual_seed(0)
        policy = GaussianMLP(env.spec, hidden_sizes=(64, 64), generator=init).to(dev)
        baseline = MLPBaseline(env.spec, epochs=2, batch_size=1024, generator=init).to(dev)
        agent = NPG(env, policy, baseline, normalized_step_size=0.05, num_traj=num_envs, **kw)
    samples = agent.sample_mode == "samples"
    window = -(-agent.num_samples // num_envs) if samples else horizon  # steps per iteration
    kernel = kernel_for(env.model) if hasattr(env, "model") else None  # point_mass: none
    kernel_name = kernel.name if kernel is not None else None
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(2):
        agent.train_step(gen)
    one_off = dict(phases)

    def rollout():
        if not samples:
            noise = timed("noise", lambda: draw_episode_noise(env, num_envs, horizon, gen))
            return timed("rollout", lambda: run_episodes(env, policy, noise))
        noise = timed("noise", lambda: draw_autoreset_noise(env, num_envs, window, gen))
        batch, agent.sampler_carry = timed(
            "rollout", lambda: run_autoreset(env, policy, noise, agent.sampler_carry, horizon))
        return batch

    def iteration():
        t0 = time.perf_counter()
        batch = real = rollout()
        if isinstance(agent, ModelAccelNPG):
            timed("ensemble_fit", lambda: agent.dynamics.fit(real, gen)["dyn_error"].item())
            batch = timed("imagined_rollout", lambda: agent.imagine(real, gen))
        batch = timed("returns_gae", lambda: agent.process_batch(batch))
        timed("update", lambda: agent.update(batch, generator=gen))
        timed("baseline_fit", lambda: baseline.fit(batch, generator=gen))
        timed("statistics", lambda: rollout_statistics(real).mean.item())
        if evaluation:
            timed("evaluation", lambda: rollout_statistics(sample_episodes(
                env, policy, evaluation, horizon, gen, eval_mode=True)).mean.item())
        return (time.perf_counter() - t0) * 1e3

    phases.clear()
    plain_wall = iteration()
    plain_phases = dict(phases)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    start, stop = dist.row_block(num_envs)
    result = {"card": smi, "row": row, "rank": dist.rank(), "ranks": ranks,
              "wall_ms": plain_wall, "phases_ms": plain_phases, "one_off_ms": one_off,
              "kernel": kernel_name, "kernel_launches": kernel and kernel.launches,
              "num_envs": num_envs, "rank_envs": stop - start,
              "horizon": horizon, "steps_per_iteration": window}
    if ranks > 1:
        result["collectives"] = {k: dict(v) for k, v in collectives.items()}
    if args.no_profile:
        return result
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
    kernel_ms = sum(device_us(e) for e in events if kernel and kernel.name in e.key) / 1e3
    top = sorted(events, key=device_us, reverse=True)[:8]
    result.update({
        "profiled_wall_ms": wall, "profiled_phases_ms": phases, "device_busy_ms": busy,
        "device_busy_share": busy / wall, "kernel_device_ms": kernel_ms,
        "kernel_launches": kernel and kernel.launches,
        "top_device_ms": {e.key[:60]: device_us(e) / 1e3 for e in top},
    })
    return result


if __name__ == "__main__":
    sys.exit(main())
