"""On-device trajectory sampling."""

from mjrl_tpu_torch.samplers.rollout import (  # noqa: F401
    EpisodeNoise,
    RolloutStats,
    draw_episode_noise,
    rollout_statistics,
    run_episodes,
    sample_episodes,
)
