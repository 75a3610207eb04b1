"""Policy evaluation and trajectory export.

Twin of ``mjrl_tpu/utils/evaluation.py`` (the reference's
``GymEnv.evaluate_policy`` and ``visualize_policy``, mjrl/utils/gym_env.py).
``evaluate_policy`` rolls ``num_episodes`` fresh episodes, with the policy
mean by default, and returns ``mean``, ``std``, ``min`` and ``max`` of the
per-episode discounted score, plus any percentiles asked for.
``export_rollout`` stands in for interactive visualisation: it records one
episode's observations, actions, rewards and, for the physics envs, qpos,
into an ``.npz`` that ``tools/replay_rollout.py`` replays in a MuJoCo
viewer against the same asset.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mjrl_tpu_torch.envs.base import Env
from mjrl_tpu_torch.models.gaussian_mlp import GaussianMLP
from mjrl_tpu_torch.ops.gae import compute_returns
from mjrl_tpu_torch.samplers.rollout import sample_episodes


def evaluate_policy(env: Env, policy: GaussianMLP, num_episodes: int = 10,
                    horizon: Optional[int] = None, gamma: float = 1.0, mean_action: bool = True,
                    percentiles: Sequence[float] = (),
                    generator: Optional[torch.Generator] = None) -> Dict[str, float]:
    """Per-episode discounted-score statistics, the reference's contract."""
    batch = sample_episodes(env, policy, num_episodes, horizon or env.spec.horizon, generator,
                            eval_mode=mean_action)
    rets = compute_returns(batch.rewards, batch.done, batch.valid, gamma)
    scores = rets[:, 0].cpu().numpy()  # one episode per row
    out = {"mean": float(scores.mean()), "std": float(scores.std()),
           "min": float(scores.min()), "max": float(scores.max())}
    for p in percentiles:
        out[f"p{p}"] = float(np.percentile(scores, p))
    return out


@torch.no_grad()
def export_rollout(env: Env, policy: GaussianMLP, path: str, horizon: Optional[int] = None,
                   mean_action: bool = True,
                   generator: Optional[torch.Generator] = None) -> str:
    """Roll one episode (actions the policy mean, or sampled) and save its
    ``observations (T, do)``, ``actions (T, da)``, ``rewards (T,)`` and,
    where the state has one, ``qpos (T, nq)`` (each before its step) to
    ``path``; returns ``path``."""
    state, obs = env.reset(1, generator)
    obs_l, act_l, rew_l, q_l = [], [], [], []
    for _ in range(horizon or env.spec.horizon):
        mean, log_std = policy(obs)
        action = mean
        if not mean_action:
            noise = torch.randn(mean.shape, device=mean.device, generator=generator)
            action = mean + torch.exp(log_std) * noise
        if hasattr(state, "q"):
            q_l.append(state.q[0].cpu().numpy())
        obs_l.append(obs[0].cpu().numpy())
        act_l.append(action[0].cpu().numpy())
        state, obs, reward, terminated, _ = env.step(state, action)
        rew_l.append(float(reward[0]))
        if bool(terminated[0]):
            break
    data = {"observations": np.stack(obs_l), "actions": np.stack(act_l),
            "rewards": np.asarray(rew_l)}
    if q_l:
        data["qpos"] = np.stack(q_l)
    np.savez(path, **data)
    return path
