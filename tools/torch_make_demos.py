"""Export expert demonstrations from a job directory of the PyTorch port.

Twin of ``tools/make_demos.py``. Rolls N deterministic (mean-action)
episodes of the job's best checkpointed policy (``best.pt``) through the
port's sampler and writes them as an mjrl-format demo pickle: a list of
path dicts ``{observations, actions, rewards, terminated}``, the format
``mjrl_tpu_torch/utils/demos.py`` reads (and the reference's hand_dapg
demo pickles have), for a config's ``demo_file`` (BC, DAPG).

Usage (on the card, or add ``--device cpu``):
    python tools/torch_make_demos.py --job <run dir> --out demos/my_task.pickle \\
        [--episodes 25] [--stochastic] [--min-return R] [--only-success] [--max-demos N]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="export demos from a trained job of the port")
    p.add_argument("--job", required=True, help="job directory (has config.json and best.pt)")
    p.add_argument("--out", required=True, help="output demo pickle path")
    p.add_argument("--episodes", type=int, default=25)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--stochastic", action="store_true", help="sample actions instead of the mean")
    p.add_argument("--min-return", type=float, default=None,
                   help="keep only episodes with undiscounted return >= this")
    p.add_argument("--only-success", action="store_true",
                   help="keep only episodes in which the env's info['success'] fired")
    p.add_argument("--max-demos", type=int, default=None,
                   help="cap the output at the N highest-return surviving episodes")
    args = p.parse_args(argv)

    from mjrl_tpu_torch.samplers import sample_episodes
    from mjrl_tpu_torch.utils.checkpoint import CheckpointManager
    from mjrl_tpu_torch.utils.configs import RunConfig, build
    from mjrl_tpu_torch.utils.demos import batch_to_paths

    cfg = RunConfig.from_json(os.path.join(args.job, "config.json"))
    # the env and the policy alone: no demos, warm start or ranks
    cfg = dataclasses.replace(cfg, algorithm="npg", agent_kwargs={}, demo_file=None,
                              bc_init=False, init_policy_from=None, mesh_devices=0)
    env, policy, _, agent = build(cfg, device=args.device)
    best = CheckpointManager(args.job, create=False).restore_best(map_location=env.device)
    policy.load_state_dict(best["policy"])
    gen = torch.Generator(device=env.device).manual_seed(args.seed)
    batch = sample_episodes(env, policy, args.episodes, agent.horizon, gen,
                            eval_mode=not args.stochastic)
    paths = batch_to_paths(batch)
    rets = [float(np.sum(path["rewards"])) for path in paths]
    if args.only_success:
        if "success" not in batch.env_info:
            raise SystemExit("--only-success: env reports no success info")
        ok = (batch.env_info["success"] & batch.valid).any(dim=1).cpu().numpy()
        n0 = len(paths)
        paths = [path for path, s in zip(paths, ok) if s]
        rets = [r for r, s in zip(rets, ok) if s]
        print(f"success filter: {len(paths)}/{n0} episodes")
    if args.min_return is not None:
        paths = [path for path, r in zip(paths, rets) if r >= args.min_return]
        rets = [r for r in rets if r >= args.min_return]
    if not paths:
        raise SystemExit("no episodes passed the return filter")
    if args.max_demos is not None and len(paths) > args.max_demos:
        order = np.argsort(rets)[::-1][: args.max_demos]
        paths = [paths[i] for i in order]
        rets = [rets[i] for i in order]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump(paths, f)
    print(f"wrote {len(paths)} demos to {args.out}: return mean {np.mean(rets):.1f} "
          f"min {np.min(rets):.1f} max {np.max(rets):.1f}")


if __name__ == "__main__":
    main()
