from repro_torch.rl import ppo, rollout  # noqa: F401
