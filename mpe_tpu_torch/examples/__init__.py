"""The example scripts (counterpart of the repo's ``examples/``), each run as

    python -m mpe_tpu_torch.examples.<name> [--device cpu] ...

``rollout`` (the generic engine, or ``--fused``: kernel K2),
``evaluate_policy`` (K4), ``es_train`` (ES, one K4 launch per member),
``train`` (REINFORCE, PPO, MAPPO and MADDPG on the generic engine; MADDPG
``--fused-collect`` on K8 and K9; ``fused_ppo`` on K5 and K6, ``fused_mappo``
on K5 and K7), ``maddpg_run`` (the fused MADDPG loop, K8 and K9),
``render_policy`` (a trained MADDPG checkpoint rendered to frames) and
``crypto_demo`` (the covert-communication checkpoint's codebook). Each has
``main(argv=None)``, which prints its figures and returns them as a dict. They
run on the CUDA card unless ``--device`` names another device, and raise
without one.
"""
