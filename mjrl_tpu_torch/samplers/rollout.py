"""On-device trajectory sampling (twin of ``mjrl_tpu/samplers/rollout.py``:
``sample_episodes``, ``init_autoreset_carry``, ``sample_autoreset``,
``_to_batch``, ``rollout_statistics``).

Two modes, as in the reference:

- episodes (``sample_episodes``): every row is one episode started fresh
  and run for a fixed horizon; a row whose episode terminates is frozen
  (state and observation) and its later steps are invalid;
- samples (``sample_autoreset``): rows run continuously and reset in place
  at termination or at the episode horizon, so every step is valid. The
  rows persist across calls in a carry (:class:`SamplerCarry`), and each
  episode's whole score is emitted at its end as ``episode_score``. (The
  reference's per-episode success accumulator is left out: no ported env
  reports success.)

The reference's ``lax.scan`` over time becomes a Python loop over control
steps, each a batched env step on the device. All randomness of a rollout
is drawn up front (:class:`EpisodeNoise`, :class:`AutoresetNoise`), so a
test can hand both this sampler and the reference the same noise. As in the
reference, the auto-reset sampler draws a reset for every env at every step
and keeps the ones of the rows that end.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from mjrl_tpu_torch.envs.base import EnvState
from mjrl_tpu_torch.envs.locomotion import LocomotionEnv
from mjrl_tpu_torch.models.gaussian_mlp import GaussianMLP
from mjrl_tpu_torch.ops.distributions import DiagGaussian
from mjrl_tpu_torch.types import TrajectoryBatch


@dataclasses.dataclass(frozen=True)
class EpisodeNoise:
    reset_q: torch.Tensor  # (N, nq), added to qpos0
    reset_qd: torch.Tensor  # (N, nv), the initial qd
    action: torch.Tensor  # (T, N, da), standard normal


def draw_episode_noise(env: LocomotionEnv, num_envs: int, horizon: int,
                       generator: Optional[torch.Generator] = None) -> EpisodeNoise:
    reset_q, reset_qd = env.reset_noise(num_envs, generator)
    action = torch.randn(horizon, num_envs, env.spec.action_dim, device=env.device,
                         generator=generator)
    return EpisodeNoise(reset_q=reset_q, reset_qd=reset_qd, action=action)


@torch.no_grad()
def run_episodes(env: LocomotionEnv, policy: GaussianMLP, noise: EpisodeNoise) -> TrajectoryBatch:
    """One fresh episode per row, with the given noise."""
    T, N = noise.action.shape[:2]
    state, obs = env.reset_from_noise(noise.reset_q, noise.reset_qd)
    finished = torch.zeros(N, dtype=torch.bool, device=obs.device)
    steps: List[Dict[str, torch.Tensor]] = []
    for t in range(T):
        mean, log_std = policy(obs)
        action = DiagGaussian.sample(mean, log_std, noise.action[t])
        log_prob = DiagGaussian.log_prob(action, mean, log_std)
        new_state, new_obs, reward, term, info = env.step(state, action)
        valid = ~finished
        is_last = term | (t == T - 1)
        steps.append(dict(
            obs=obs, action=action, reward=reward * valid.to(reward.dtype),
            done=valid & is_last, terminated=valid & term, valid=valid,
            mean=mean, log_std=log_std, log_prob=log_prob,
            time=torch.full((N,), t, dtype=torch.int32, device=obs.device), info=info,
        ))
        # freeze finished envs so post-termination dynamics can't blow up
        keep = finished[:, None]
        state = EnvState(q=torch.where(keep, state.q, new_state.q),
                         qd=torch.where(keep, state.qd, new_state.qd))
        obs = torch.where(keep, obs, new_obs)
        finished = finished | term
    return _to_batch(steps)


def sample_episodes(env: LocomotionEnv, policy: GaussianMLP, num_envs: int, horizon: int,
                    generator: Optional[torch.Generator] = None) -> TrajectoryBatch:
    return run_episodes(env, policy, draw_episode_noise(env, num_envs, horizon, generator))


@dataclasses.dataclass(frozen=True)
class AutoresetNoise:
    reset_q: torch.Tensor  # (T, N, nq), each step's reset draw, added to qpos0
    reset_qd: torch.Tensor  # (T, N, nv)
    action: torch.Tensor  # (T, N, da), standard normal


class SamplerCarry(NamedTuple):
    """The persistent rows of the auto-reset sampler."""

    state: EnvState
    obs: torch.Tensor  # (N, do)
    t_in_ep: torch.Tensor  # (N,) int32, steps since the row's episode began
    ep_return: torch.Tensor  # (N,), the episode's reward so far


def carry_from_noise(env: LocomotionEnv, q_noise: torch.Tensor,
                     qd_noise: torch.Tensor) -> SamplerCarry:
    """A fresh carry whose rows start from the given reset noise."""
    state, obs = env.reset_from_noise(q_noise, qd_noise)
    zeros = torch.zeros(obs.shape[0], dtype=obs.dtype, device=obs.device)
    return SamplerCarry(state, obs, torch.zeros_like(zeros, dtype=torch.int32), zeros)


def init_autoreset_carry(env: LocomotionEnv, num_envs: int,
                         generator: Optional[torch.Generator] = None) -> SamplerCarry:
    """A fresh carry for :func:`sample_autoreset`'s persistent mode."""
    return carry_from_noise(env, *env.reset_noise(num_envs, generator))


def draw_autoreset_noise(env: LocomotionEnv, num_envs: int, num_steps: int,
                         generator: Optional[torch.Generator] = None) -> AutoresetNoise:
    reset_q, reset_qd = env.reset_noise(num_steps * num_envs, generator)
    action = torch.randn(num_steps, num_envs, env.spec.action_dim, device=env.device,
                         generator=generator)
    return AutoresetNoise(reset_q=reset_q.reshape(num_steps, num_envs, -1),
                          reset_qd=reset_qd.reshape(num_steps, num_envs, -1), action=action)


@torch.no_grad()
def run_autoreset(env: LocomotionEnv, policy: GaussianMLP, noise: AutoresetNoise,
                  carry: SamplerCarry, episode_horizon: int
                  ) -> Tuple[TrajectoryBatch, SamplerCarry]:
    """Continuous rows from ``carry`` with in-place resets, with the given
    noise; returns the batch and the carry after the window."""
    T, N = noise.action.shape[:2]
    state, obs, t_in_ep, ep_ret = carry
    steps: List[Dict[str, torch.Tensor]] = []
    for t in range(T):
        mean, log_std = policy(obs)
        action = DiagGaussian.sample(mean, log_std, noise.action[t])
        log_prob = DiagGaussian.log_prob(action, mean, log_std)
        new_state, new_obs, reward, term, info = env.step(state, action)
        done = term | ((t_in_ep + 1) >= episode_horizon)
        reset_state, reset_obs = env.reset_from_noise(noise.reset_q[t], noise.reset_qd[t])
        d = done[:, None]
        ret_acc = ep_ret + reward
        steps.append(dict(
            obs=obs, action=action, reward=reward, done=done, terminated=term,
            valid=torch.ones_like(done), mean=mean, log_std=log_std, log_prob=log_prob,
            time=t_in_ep,
            # the whole episode's score, emitted at its end, so episodes that
            # span windows are scored whole
            info={**info, "episode_score": torch.where(done, ret_acc, torch.zeros_like(ret_acc))},
        ))
        state = EnvState(q=torch.where(d, reset_state.q, new_state.q),
                         qd=torch.where(d, reset_state.qd, new_state.qd))
        obs = torch.where(d, reset_obs, new_obs)
        t_in_ep = torch.where(done, torch.zeros_like(t_in_ep), t_in_ep + 1)
        ep_ret = torch.where(done, torch.zeros_like(ret_acc), ret_acc)
    return _to_batch(steps), SamplerCarry(state, obs, t_in_ep, ep_ret)


def sample_autoreset(env: LocomotionEnv, policy: GaussianMLP, carry: SamplerCarry,
                     num_steps: int, episode_horizon: Optional[int] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[TrajectoryBatch, SamplerCarry]:
    """Continuous rows with in-place auto-reset, continuing from ``carry``
    (a fresh one from :func:`init_autoreset_carry` starts every row from
    reset); every transition is valid. Returns ``(batch, new_carry)``."""
    noise = draw_autoreset_noise(env, carry.obs.shape[0], num_steps, generator)
    return run_autoreset(env, policy, noise, carry, episode_horizon or env.spec.horizon)


def _to_batch(steps: List[Dict[str, torch.Tensor]]) -> TrajectoryBatch:
    """Per-step ``(N, ...)`` records -> env-major batch ``(N, T, ...)``."""

    def stack(key):
        return torch.stack([s[key] for s in steps], dim=1)

    rewards = stack("reward")
    return TrajectoryBatch(
        observations=stack("obs"), actions=stack("action"), rewards=rewards,
        valid=stack("valid"), done=stack("done"), terminated=stack("terminated"),
        mean=stack("mean"), log_std=stack("log_std"), log_prob=stack("log_prob"),
        time=stack("time"), returns=torch.zeros_like(rewards),
        baseline=torch.zeros_like(rewards), advantages=torch.zeros_like(rewards),
        env_info={k: torch.stack([s["info"][k] for s in steps], dim=1) for k in steps[0]["info"]},
    )


@dataclasses.dataclass(frozen=True)
class RolloutStats:
    """Per-batch undiscounted episode-score statistics (0-d tensors)."""

    mean: torch.Tensor
    std: torch.Tensor
    max: torch.Tensor
    min: torch.Tensor
    success_rate: torch.Tensor
    num_episodes: torch.Tensor


def rollout_statistics(batch: TrajectoryBatch) -> RolloutStats:
    """Scores of the episodes that end in the batch, emitted at ``done``:
    the sampler's ``episode_score`` where it reports one (samples mode),
    else the rewards summed per episode along each row. No ported env
    reports success, so ``success_rate`` is 0."""
    validf = batch.valid.to(batch.rewards.dtype)
    rewards = batch.rewards * validf
    done = batch.done
    if "episode_score" in batch.env_info:
        scores = batch.env_info["episode_score"] * validf
    else:
        scores = torch.zeros_like(rewards)
        acc = rewards.new_zeros(rewards.shape[0])
        for t in range(rewards.shape[1]):
            acc = acc + rewards[:, t]
            scores[:, t] = torch.where(done[:, t], acc, torch.zeros_like(acc))
            acc = torch.where(done[:, t], torch.zeros_like(acc), acc)
    raw_ep = done.to(rewards.dtype).sum()
    n_ep = torch.clamp(raw_ep, min=1.0)
    has_ep = raw_ep > 0
    mean = scores.sum() / n_ep
    var = torch.where(done, torch.square(scores - mean), torch.zeros_like(scores)).sum() / n_ep
    big = torch.finfo(rewards.dtype).max
    zero = rewards.new_zeros(())
    mx = torch.where(has_ep, torch.where(done, scores, -big).max(), zero)
    mn = torch.where(has_ep, torch.where(done, scores, big).min(), zero)
    return RolloutStats(mean=mean, std=torch.sqrt(var), max=mx, min=mn,
                        success_rate=zero, num_episodes=raw_ep)
