"""On-device trajectory sampling."""

from mjrl_tpu_torch.samplers.rollout import (  # noqa: F401
    AutoresetNoise,
    EpisodeNoise,
    RolloutStats,
    SamplerCarry,
    carry_from_noise,
    draw_autoreset_noise,
    draw_episode_noise,
    init_autoreset_carry,
    local_noise,
    rollout_statistics,
    run_autoreset,
    run_episodes,
    sample_autoreset,
    sample_episodes,
)
