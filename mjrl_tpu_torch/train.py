"""CLI: ``python -m mjrl_tpu_torch.train --config <cfg.json> --output <dir>``.

Twin of ``mjrl_tpu/train.py``: builds the env, policy, baseline and agent
from a JSON config (the same ``examples/*.json``) and trains into
``--output``, resuming from its latest checkpoint. ``--set key=value``
overrides a field (JSON-parsed; dotted keys reach into dict fields, e.g.
``env_kwargs.n_substeps=1``). The run is on the card (``--device cuda``,
the default) unless ``--device cpu`` is asked for; without a card a CUDA
run fails and never falls back to the CPU.

    python -m mjrl_tpu_torch.train --config examples/hopper_npg.json --output runs/hopper
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from mjrl_tpu_torch.algos.base import BatchREINFORCE
from mjrl_tpu_torch.utils.configs import RunConfig, build
from mjrl_tpu_torch.utils.train_agent import train_agent


def run_job(cfg: RunConfig, output: str, device="cuda") -> BatchREINFORCE:
    """Train ``cfg`` into ``output`` on ``device``; returns the agent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU")
    cfg.to_json(os.path.join(output, "config.json"))
    _, _, _, agent = build(cfg, device=device)
    return train_agent(output, agent, seed=cfg.seed, niter=cfg.niter, save_freq=cfg.save_freq)


def load_config(config_path=None, overrides=()) -> RunConfig:
    raw = {}
    if config_path:
        with open(config_path) as f:
            raw = json.load(f)
    for kv in overrides:
        k, _, v = kv.partition("=")
        try:
            val = json.loads(v)
        except json.JSONDecodeError:
            val = v
        # dotted paths override inside dict-valued fields
        node, parts = raw, k.split(".")
        for i, part in enumerate(parts[:-1]):
            if node.get(part) is None:
                node[part] = {}
            node = node[part]
            if not isinstance(node, dict):
                raise SystemExit(f"cannot apply override {k!r}: {'.'.join(parts[: i + 1])!r} "
                                 f"is {type(node).__name__}, not a dict")
        node[parts[-1]] = val
    return RunConfig.from_dict(raw)


def main() -> None:
    p = argparse.ArgumentParser(description="mjrl_tpu_torch policy optimization job")
    p.add_argument("--output", required=True, help="job directory")
    p.add_argument("--config", default=None, help="JSON config path")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="config overrides, JSON-parsed values (e.g. niter=50)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args()
    run_job(load_config(args.config, args.set), args.output, device=args.device)


if __name__ == "__main__":
    main()
