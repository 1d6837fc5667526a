from repro_torch.rl import a3c, ppo, rollout  # noqa: F401
