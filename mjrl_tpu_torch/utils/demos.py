"""Demonstrations: mjrl path dicts <-> a masked TrajectoryBatch.

Twin of ``mjrl_tpu/utils/demos.py``. A demo file is a pickled list of path
dicts ``{observations (T, do), actions (T, da), rewards (T,),
terminated}`` (the reference's DAPG demo pickles; ``rewards`` and
``terminated`` may be missing). ``paths_to_batch`` packs such
variable-length paths into one fixed-shape batch: ``valid`` marks each
path's steps, ``done`` its last one, ``terminated`` that step if the path
says so; missing rewards are zeros.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from mjrl_tpu_torch.types import TrajectoryBatch


def paths_to_batch(paths: Sequence[Dict[str, Any]], horizon: Optional[int] = None,
                   device="cpu") -> TrajectoryBatch:
    """Pack path dicts into one masked ``(N, T)`` batch on ``device``; ``T``
    is ``horizon`` (longer paths are cut) or the longest path."""
    if not paths:
        raise ValueError("no paths given")
    T = horizon or max(len(np.asarray(p["observations"])) for p in paths)
    do = np.asarray(paths[0]["observations"]).shape[-1]
    da = np.asarray(paths[0]["actions"]).shape[-1]
    N = len(paths)
    obs = np.zeros((N, T, do), np.float32)
    act = np.zeros((N, T, da), np.float32)
    rew = np.zeros((N, T), np.float32)
    valid = np.zeros((N, T), bool)
    done = np.zeros((N, T), bool)
    term = np.zeros((N, T), bool)
    for i, p in enumerate(paths):
        o = np.asarray(p["observations"], np.float32)[:T]
        L = len(o)
        obs[i, :L] = o
        act[i, :L] = np.asarray(p["actions"], np.float32)[:T]
        if "rewards" in p:
            rew[i, :L] = np.asarray(p["rewards"], np.float32)[:T]
        valid[i, :L] = True
        done[i, L - 1] = True
        term[i, L - 1] = bool(p.get("terminated", False))
    t = lambda x: torch.as_tensor(x, device=device)
    zeros = torch.zeros((N, T), device=device)
    return TrajectoryBatch(
        observations=t(obs), actions=t(act), rewards=t(rew), valid=t(valid), done=t(done),
        terminated=t(term), mean=torch.zeros((N, T, da), device=device),
        log_std=torch.zeros((N, T, da), device=device), log_prob=zeros.clone(),
        time=torch.arange(T, dtype=torch.int32, device=device).expand(N, T).clone(),
        returns=zeros.clone(),
        baseline=zeros.clone(), advantages=zeros.clone(), env_info={})


def load_demo_pickle(path: str, horizon: Optional[int] = None, device="cpu") -> TrajectoryBatch:
    """Load an mjrl-format demo pickle (a list of path dicts)."""
    with open(path, "rb") as f:
        paths = pickle.load(f)
    return paths_to_batch(paths, horizon, device=device)


def batch_to_paths(batch: TrajectoryBatch) -> List[Dict[str, Any]]:
    """The inverse: a masked batch -> variable-length numpy path dicts."""
    valid = batch.valid.cpu().numpy()
    obs, act = batch.observations.cpu().numpy(), batch.actions.cpu().numpy()
    rew, term = batch.rewards.cpu().numpy(), batch.terminated.cpu().numpy()
    out = []
    for i in range(batch.num_envs):
        L = int(valid[i].sum())
        out.append(dict(observations=obs[i, :L], actions=act[i, :L], rewards=rew[i, :L],
                        terminated=bool(term[i, :L].any())))
    return out
