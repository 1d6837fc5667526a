# Launch layer: train.py (the --workload drl CLI: multi-GMI sync PPO),
# multi_gmi_training.py (Algorithm 2, then the layout, then training),
# steps.py (DRL step factories and the multi-GMI loop), async_a3c.py (async
# A3C over the MCC ring), serve.py (the paged serving engine), profile.py
# (device-time breakdown of one PPO iteration, of k GMIs' iteration, or of
# serving steps).
