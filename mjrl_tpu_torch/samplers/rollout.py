"""On-device trajectory sampling (twin of ``mjrl_tpu/samplers/rollout.py``:
``sample_episodes``, ``init_autoreset_carry``, ``sample_autoreset``,
``_to_batch``, ``rollout_statistics``).

Two modes, as in the reference (episodes mode also in ``eval_mode``, which
acts with the policy mean and draws no action noise):

- episodes (``sample_episodes``): every row is one episode started fresh
  and run for a fixed horizon; a row whose episode terminates is frozen
  (state and observation) and its later steps are invalid;
- samples (``sample_autoreset``): rows run continuously and reset in place
  at termination or at the episode horizon, so every step is valid. The
  rows persist across calls in a carry (:class:`SamplerCarry`), and each
  episode's whole score is emitted at its end as ``episode_score``; for an
  env that reports ``info["success"]`` (Adroit), whether the episode ever
  succeeded is emitted at its end as ``episode_success``.

The reference's ``lax.scan`` over time becomes a Python loop over control
steps, each a batched env step on the device. All randomness of a rollout
is drawn up front (:class:`EpisodeNoise`, :class:`AutoresetNoise`), so a
test can hand both this sampler and the reference the same noise. As in the
reference, the auto-reset sampler draws a reset for every env at every step
and keeps the ones of the rows that end; since those resets depend on the
noise alone, their states and observations are made for the whole window
in one batched call (one set of ops, not one per step: humanoid's
observation is ~1350 ops). An env's state is a NamedTuple of batch-first
tensors (``EnvState``, or Adroit's with its link offsets and target); its
reset noise is the pair ``reset_noise`` draws (locomotion: q and qd noise;
pen: the target angles and an empty tensor).

Under data parallelism (``parallel/dist.py``) every draw is made for all
the batch's rows, as a single-rank run makes it, and each rank keeps its
own block (:func:`local_noise`); the statistics reduce over every rank's
rows.

Traced (``utils/trace.py``), each control step is the span
``sampler.step``, over ``sampler.policy`` (the forward pass, the sample
and its log-probability) and the env's ``env.step``; its self time is the
sampler's own bookkeeping.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from mjrl_tpu_torch.envs.base import Env
from mjrl_tpu_torch.models.gaussian_mlp import GaussianMLP
from mjrl_tpu_torch.ops.distributions import DiagGaussian
from mjrl_tpu_torch.parallel import dist
from mjrl_tpu_torch.types import TrajectoryBatch
from mjrl_tpu_torch.utils import trace


def _select(mask: torch.Tensor, a: NamedTuple, b: NamedTuple) -> NamedTuple:
    """Field by field, ``a``'s rows where ``mask`` (N,) holds, else ``b``'s."""
    return type(a)(*(torch.where(mask.view(-1, *[1] * (x.dim() - 1)), x, y)
                     for x, y in zip(a, b)))


@dataclasses.dataclass(frozen=True)
class EpisodeNoise:
    reset_q: torch.Tensor  # (N, nq): added to qpos0 (pen: (N, 2), the target angles)
    reset_qd: torch.Tensor  # (N, nv): the initial qd (pen: (N, 0))
    action: torch.Tensor  # (T, N, da), standard normal; (T, N, 0) in eval mode


def draw_episode_noise(env: Env, num_envs: int, horizon: int,
                       generator: Optional[torch.Generator] = None,
                       eval_mode: bool = False) -> EpisodeNoise:
    """The reset draws and, unless ``eval_mode``, the action noise of
    ``num_envs`` rows; this rank's block of them."""
    reset_q, reset_qd = env.reset_noise(num_envs, generator)
    shape = (horizon, num_envs, 0 if eval_mode else env.spec.action_dim)
    action = (torch.empty(shape, device=env.device) if eval_mode
              else torch.randn(shape, device=env.device, generator=generator))
    return local_noise(EpisodeNoise(reset_q=reset_q, reset_qd=reset_qd, action=action))


@torch.no_grad()
def run_episodes(env: Env, policy: GaussianMLP, noise: EpisodeNoise,
                 eval_mode: bool = False) -> TrajectoryBatch:
    """One fresh episode per row, with the given noise. ``eval_mode`` acts
    with the policy mean (the reference's evaluation rollouts), its
    ``log_prob`` taken at the mean."""
    T, N = noise.action.shape[:2]
    state, obs = env.reset_from_noise(noise.reset_q, noise.reset_qd)
    finished = torch.zeros(N, dtype=torch.bool, device=obs.device)
    steps: List[Dict[str, torch.Tensor]] = []
    for t in range(T):
        with trace.span("sampler.step"):
            with trace.span("sampler.policy"):
                mean, log_std = policy(obs)
                action = mean if eval_mode else DiagGaussian.sample(mean, log_std, noise.action[t])
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
            state = _select(finished, state, new_state)
            obs = torch.where(finished[:, None], obs, new_obs)
            finished = finished | term
    env.check()
    return _to_batch(steps)


def sample_episodes(env: Env, policy: GaussianMLP, num_envs: int, horizon: int,
                    generator: Optional[torch.Generator] = None,
                    eval_mode: bool = False) -> TrajectoryBatch:
    noise = draw_episode_noise(env, num_envs, horizon, generator, eval_mode)
    return run_episodes(env, policy, noise, eval_mode)


@dataclasses.dataclass(frozen=True)
class AutoresetNoise:
    reset_q: torch.Tensor  # (T, N, nq), each step's reset draw (as EpisodeNoise's)
    reset_qd: torch.Tensor  # (T, N, nv)
    action: torch.Tensor  # (T, N, da), standard normal


class SamplerCarry(NamedTuple):
    """The persistent rows of the auto-reset sampler."""

    state: NamedTuple
    obs: torch.Tensor  # (N, do)
    t_in_ep: torch.Tensor  # (N,) int32, steps since the row's episode began
    ep_return: torch.Tensor  # (N,), the episode's reward so far
    ep_success: Optional[torch.Tensor] = None  # (N,), 1 once the episode has succeeded


def carry_from_noise(env: Env, q_noise: torch.Tensor,
                     qd_noise: torch.Tensor) -> SamplerCarry:
    """A fresh carry whose rows start from the given reset noise."""
    state, obs = env.reset_from_noise(q_noise, qd_noise)
    zeros = torch.zeros(obs.shape[0], dtype=obs.dtype, device=obs.device)
    return SamplerCarry(state, obs, torch.zeros_like(zeros, dtype=torch.int32), zeros, zeros)


def init_autoreset_carry(env: Env, num_envs: int,
                         generator: Optional[torch.Generator] = None) -> SamplerCarry:
    """A fresh carry of ``num_envs`` rows for :func:`sample_autoreset`'s
    persistent mode; this rank's block of them."""
    q_noise, qd_noise = env.reset_noise(num_envs, generator)
    return carry_from_noise(env, dist.local_rows(q_noise), dist.local_rows(qd_noise))


def draw_autoreset_noise(env: Env, num_envs: int, num_steps: int,
                         generator: Optional[torch.Generator] = None) -> AutoresetNoise:
    """Each step's resets and action noise for ``num_envs`` rows, drawn in
    ``(step, env)`` order; this rank's block of the rows."""
    reset_q, reset_qd = env.reset_noise(num_steps * num_envs, generator)
    action = torch.randn(num_steps, num_envs, env.spec.action_dim, device=env.device,
                         generator=generator)
    return local_noise(AutoresetNoise(
        reset_q=reset_q.reshape(num_steps, num_envs, *reset_q.shape[1:]),
        reset_qd=reset_qd.reshape(num_steps, num_envs, *reset_qd.shape[1:]), action=action))


def local_noise(noise):
    """This rank's block of the rows of an :class:`EpisodeNoise` or
    :class:`AutoresetNoise` drawn for all of them (itself on one rank)."""
    if isinstance(noise, EpisodeNoise):
        return EpisodeNoise(reset_q=dist.local_rows(noise.reset_q),
                            reset_qd=dist.local_rows(noise.reset_qd),
                            action=dist.local_rows(noise.action, dim=1))
    return AutoresetNoise(*(dist.local_rows(x, dim=1) for x in
                            (noise.reset_q, noise.reset_qd, noise.action)))


@torch.no_grad()
def run_autoreset(env: Env, policy: GaussianMLP, noise: AutoresetNoise,
                  carry: SamplerCarry, episode_horizon: int
                  ) -> Tuple[TrajectoryBatch, SamplerCarry]:
    """Continuous rows from ``carry`` with in-place resets, with the given
    noise; returns the batch and the carry after the window."""
    T, N = noise.action.shape[:2]
    state, obs, t_in_ep, ep_ret, ep_suc = carry
    if ep_suc is None:
        ep_suc = torch.zeros_like(ep_ret)
    resets, reset_obs = env.reset_from_noise(noise.reset_q.reshape(T * N, *noise.reset_q.shape[2:]),
                                             noise.reset_qd.reshape(T * N, *noise.reset_qd.shape[2:]))
    resets = type(resets)(*(x.reshape(T, N, *x.shape[1:]) for x in resets))
    reset_obs = reset_obs.reshape(T, N, -1)
    steps: List[Dict[str, torch.Tensor]] = []
    for t in range(T):
        with trace.span("sampler.step"):
            with trace.span("sampler.policy"):
                mean, log_std = policy(obs)
                action = DiagGaussian.sample(mean, log_std, noise.action[t])
                log_prob = DiagGaussian.log_prob(action, mean, log_std)
            new_state, new_obs, reward, term, info = env.step(state, action)
            done = term | ((t_in_ep + 1) >= episode_horizon)
            d = done[:, None]
            ret_acc = ep_ret + reward
            zero = torch.zeros_like(ret_acc)
            # the whole episode's score (and success), emitted at its end, so
            # episodes that span windows are scored whole
            if "success" in info:
                suc_acc = torch.maximum(ep_suc, info["success"].to(ep_suc.dtype))
                info = {**info, "episode_success": torch.where(done, suc_acc, zero)}
            else:
                suc_acc = ep_suc
            steps.append(dict(
                obs=obs, action=action, reward=reward, done=done, terminated=term,
                valid=torch.ones_like(done), mean=mean, log_std=log_std, log_prob=log_prob,
                time=t_in_ep, info={**info, "episode_score": torch.where(done, ret_acc, zero)},
            ))
            state = _select(done, type(resets)(*(x[t] for x in resets)), new_state)
            obs = torch.where(d, reset_obs[t], new_obs)
            t_in_ep = torch.where(done, torch.zeros_like(t_in_ep), t_in_ep + 1)
            ep_ret = torch.where(done, zero, ret_acc)
            ep_suc = torch.where(done, zero, suc_acc)
    env.check()
    return _to_batch(steps), SamplerCarry(state, obs, t_in_ep, ep_ret, ep_suc)


def sample_autoreset(env: Env, policy: GaussianMLP, carry: SamplerCarry,
                     num_steps: int, episode_horizon: Optional[int] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[TrajectoryBatch, SamplerCarry]:
    """Continuous rows with in-place auto-reset, continuing from ``carry``
    (a fresh one from :func:`init_autoreset_carry` starts every row from
    reset); every transition is valid. Returns ``(batch, new_carry)``. The
    noise is drawn for every rank's rows, ``carry`` holding this rank's."""
    num_envs = dist.block(carry.obs.shape[0], carry.obs.device)[1]
    noise = draw_autoreset_noise(env, num_envs, num_steps, generator)
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
    else the rewards summed per episode along each row. ``success_rate``
    is 100 times the share of those episodes that ever succeeded: from
    ``episode_success`` (samples mode) or from ``success`` taken along each
    row (episodes mode), and 0 for an env that reports no success. Over
    every rank's rows: the counts and sums are all-reduced, the max and min
    too."""
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
    zero = rewards.new_zeros(())
    if "episode_success" in batch.env_info:
        successes = (batch.env_info["episode_success"] * validf).sum()
    elif "success" in batch.env_info:
        succ = batch.env_info["success"].to(rewards.dtype) * validf
        acc = succ.new_zeros(succ.shape[0])
        ep_succ = torch.zeros_like(succ)
        for t in range(succ.shape[1]):
            acc = torch.maximum(acc, succ[:, t])
            ep_succ[:, t] = torch.where(done[:, t], acc, torch.zeros_like(acc))
            acc = torch.where(done[:, t], torch.zeros_like(acc), acc)
        successes = ep_succ.sum()
    else:
        successes = zero
    raw_ep, total, successes = dist.all_sum(torch.stack(
        [done.to(rewards.dtype).sum(), scores.sum(), successes]))
    n_ep = torch.clamp(raw_ep, min=1.0)
    has_ep = raw_ep > 0
    mean = total / n_ep
    var = dist.all_sum(torch.where(done, torch.square(scores - mean),
                                   torch.zeros_like(scores)).sum()) / n_ep
    big = torch.finfo(rewards.dtype).max
    mx, neg_mn = dist.all_max(torch.stack([torch.where(done, scores, -big).max(),
                                           -torch.where(done, scores, big).min()]))
    mx = torch.where(has_ep, mx, zero)
    mn = torch.where(has_ep, -neg_mn, zero)
    success_rate = 100.0 * successes / n_ep
    return RolloutStats(mean=mean, std=torch.sqrt(var), max=mx, min=mn,
                        success_rate=success_rate, num_episodes=raw_ep)
