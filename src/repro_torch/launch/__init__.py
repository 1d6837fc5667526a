# Launch layer: train.py (the --workload drl CLI), profile.py (device-time
# breakdown of one PPO iteration).
