# Launch layer: train.py (the --workload drl CLI: multi-GMI sync PPO),
# multi_gmi_training.py (Algorithm 2, then the layout, then training),
# steps.py (DRL step factories, the multi-GMI loop, and the async factories
# make_async_runner and make_fleet_supervisor), async_a3c.py (async A3C
# over the MCC ring, optionally over an async placement with the online
# controller), serve.py (the paged serving engine; --disagg: the
# disaggregated prefill/decode front over GMIs), submesh_serving.py and
# llm_policy_serving.py (runnable counterparts of the reference's serving
# examples), multi_agent_rollout.py (counterpart of its multi-agent
# example), profile.py
# (device-time breakdown of one PPO iteration, of k GMIs' iteration, or of
# serving steps).
