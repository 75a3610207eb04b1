"""Model-accelerated NPG: learn dynamics, imagine rollouts, update on them.

Twin of ``mjrl_tpu/algos/model_npg.py`` (``ModelEnv``, ``ModelAccelNPG``).
One train step, in the reference's order:

1. the real rollout on the env (``num_traj`` episodes: the sample budget of
   record; hopper's runs kernel K1);
2. the dynamics ensemble's fit on that rollout (``models/dynamics.py``);
3. the imagined rollout of ``img_traj`` episodes of ``img_horizon`` steps
   through a :class:`ModelEnv`, by the same ``sample_episodes`` as the real
   one: no kernel, each step one batched product per layer of the
   ensemble and the env's obs-space reward and termination;
4. ``process_batch``, NPG's ``update`` and the baseline fit, all on the
   imagined batch;
5. statistics from the real batch. ``running_score`` seeds at iteration 0
   (not at the first completed episode, as the model-free agents do), and
   ``num_samples`` is the real batch's valid steps.

Imagined episodes start from observations of the real batch's valid steps
(terminal ones included), each drawn uniformly, and keep one ensemble
member, drawn uniformly, for the whole episode. The draws that have no
seam elsewhere can be injected (``finish_model_step``: the ensemble's
minibatch order, the imagined resets and action noise), as
``finish_train_step``'s ``fit_perms`` can.

Under data parallelism (``parallel/dist.py``) the real rollout is sharded
like any other, the ensemble fits as ``models/dynamics.py`` says, and the
start pool of the imagination is the real observations of every rank,
gathered by an all-reduce; the imagined rows are sharded like real ones,
from draws made for all of them.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from mjrl_tpu_torch.algos.npg import NPG
from mjrl_tpu_torch.envs.base import Env, StepResult
from mjrl_tpu_torch.models.dynamics import DynamicsEnsemble
from mjrl_tpu_torch.parallel import dist
from mjrl_tpu_torch.samplers.rollout import (
    EpisodeNoise,
    draw_episode_noise,
    local_noise,
    rollout_statistics,
    run_episodes,
    sample_episodes,
)
from mjrl_tpu_torch.types import EnvSpec, TrajectoryBatch
from mjrl_tpu_torch.utils import trace


class ModelState(NamedTuple):
    obs: torch.Tensor  # (B, do)
    member: torch.Tensor  # (B,) int64, the episode's ensemble member


class ModelEnv(Env):
    """The imagination env over a fitted ensemble. Its reset noise is the
    pair ``(index, member)``: an index into ``start_pool`` drawn uniformly
    over the rows where ``start_valid`` holds, and a member uniform in
    ``[0, K)``."""

    state_type = ModelState

    def __init__(self, real_env: Env, dynamics: DynamicsEnsemble, start_pool: torch.Tensor,
                 start_valid: torch.Tensor, horizon: int):
        self.spec = EnvSpec(observation_dim=real_env.spec.observation_dim,
                            action_dim=real_env.spec.action_dim, horizon=horizon)
        self.device = start_pool.device
        self.real_env = real_env
        self.dynamics = dynamics
        self.start_pool = start_pool  # (P, do)
        self.start_valid = start_valid  # (P,) bool

    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator] = None):
        index = torch.multinomial(self.start_valid.float(), num_envs, replacement=True,
                                  generator=generator)
        member = torch.randint(0, self.dynamics.K, (num_envs,), device=self.device,
                               generator=generator)
        return index, member

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None):
        return self.reset_from_noise(*self.reset_noise(num_envs, generator))

    def reset_from_noise(self, index: torch.Tensor, member: torch.Tensor):
        obs = self.start_pool[index]
        return ModelState(obs, member.long()), obs

    @trace.spanned("env.step")
    def step(self, state: ModelState, action: torch.Tensor) -> StepResult:
        nxt = self.dynamics.predict(state.obs, action, state.member)
        reward = self.real_env.reward_from_obs(state.obs, action, nxt)
        term = self.real_env.terminated_from_obs(nxt)
        return ModelState(nxt, state.member), nxt, reward, term, {}


class ModelAccelNPG(NPG):
    """NPG whose policy updates run on imagined rollouts. ``num_traj`` are
    the real episodes per iteration; ``img_traj`` x ``img_horizon`` (default
    the agent's horizon) size the imagined batch the update consumes. The
    ensemble's initial weights come from ``generator`` and it lives on the
    env's device."""

    def __init__(self, env: Env, policy, baseline, ensemble_size: int = 4,
                 dyn_hidden_sizes=(256, 256), dyn_learn_rate: float = 1e-3,
                 dyn_batch_size: int = 256, dyn_fit_epochs: int = 10, img_traj: int = 256,
                 img_horizon: Optional[int] = None, generator: Optional[torch.Generator] = None,
                 **kwargs: Any):
        super().__init__(env, policy, baseline, **kwargs)
        if not (hasattr(env, "reward_from_obs") and hasattr(env, "terminated_from_obs")):
            raise TypeError(f"{type(env).__name__} has no reward_from_obs / terminated_from_obs: "
                            "model-based NPG scores imagined transitions with them")
        self.dynamics = DynamicsEnsemble(
            env.spec, ensemble_size=ensemble_size, hidden_sizes=dyn_hidden_sizes,
            learn_rate=dyn_learn_rate, batch_size=dyn_batch_size, fit_epochs=dyn_fit_epochs,
            generator=generator, device=env.device)
        self.img_traj = int(img_traj)
        self.img_horizon = int(img_horizon or self.horizon)

    # -- the train state -----------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """NPG's state plus the ensemble's: its parameters and the four
        normalizers, and its Adam's moments and step count."""
        return {**super().state_dict(), "dynamics": self.dynamics.state_dict(),
                "dynamics_optimizer": self.dynamics.optimizer.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        self.dynamics.load_state_dict(state["dynamics"])
        self.dynamics.optimizer.load_state_dict(state["dynamics_optimizer"])

    # -- the phases ------------------------------------------------------------
    def imagine(self, real: TrajectoryBatch, generator: Optional[torch.Generator] = None,
                noise: Optional[EpisodeNoise] = None) -> TrajectoryBatch:
        """``img_traj`` imagined episodes of ``img_horizon`` steps through the
        current ensemble, from the real batch's valid observations (every
        rank's); ``noise`` (reset: start indices and members; action noise;
        for all ``img_traj`` rows) fixes the draws. Returns this rank's
        block of the imagined rows."""
        do = real.observations.shape[-1]
        env = ModelEnv(self.env, self.dynamics, dist.gather_rows(real.observations.reshape(-1, do)),
                       dist.gather_rows(real.valid.reshape(-1)), self.img_horizon)
        if noise is None:
            noise = draw_episode_noise(env, self.img_traj, self.img_horizon, generator)
        else:
            noise = local_noise(noise)
        return run_episodes(env, self.policy, noise)

    def train_step(self, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One iteration; traced, the root span ``train_step`` over the real
        rollout (``sample``), ``model.ensemble_fit``,
        ``model.imagined_rollout``, ``process_batch``, ``update``, ``fit``
        and ``statistics``."""
        with trace.span("train_step"):
            with trace.span("sample"):
                real = sample_episodes(self.env, self.policy, self.num_traj, self.horizon,
                                       generator)
            return self.finish_model_step(real, generator)

    def finish_model_step(self, real: TrajectoryBatch,
                          generator: Optional[torch.Generator] = None,
                          dyn_perms: Optional[torch.Tensor] = None,
                          img_noise: Optional[EpisodeNoise] = None) -> Dict[str, torch.Tensor]:
        """Everything after the real rollout; the ensemble's minibatch order
        ``dyn_perms`` and the imagined rollout's ``img_noise`` are the given
        ones where passed, and every draw not given comes from
        ``generator`` in the step's order (the fit, the imagined rollout,
        the update's FVP mask, the baseline's minibatches)."""
        with trace.span("model.ensemble_fit"):
            dyn_metrics = self.dynamics.fit(real, generator, perms=dyn_perms)
        with trace.span("model.imagined_rollout"):
            img = self.imagine(real, generator, img_noise)
        with trace.span("process_batch"):
            img = self.process_batch(img)
        with trace.span("update"):
            update_metrics = self.update(img, generator=generator)
        with trace.span("fit"):
            vf_metrics = self.baseline.fit(img, generator=generator)
        with trace.span("statistics"):
            stats = rollout_statistics(real)
            self.running_score = (stats.mean if self.iteration == 0
                                  else 0.9 * self.running_score + 0.1 * stats.mean)
        self.iteration += 1
        return {
            "stoc_pol_mean": stats.mean,
            "stoc_pol_std": stats.std,
            "stoc_pol_max": stats.max,
            "stoc_pol_min": stats.min,
            "success_rate": stats.success_rate,
            "running_score": self.running_score,
            "num_samples": dist.all_sum(real.num_valid),
            **update_metrics,
            **vf_metrics,
            **dyn_metrics,
        }
