# Launch layer: train.py (the --workload drl CLI), async_a3c.py (async A3C
# over the MCC ring), profile.py (device-time breakdown of one PPO
# iteration).
