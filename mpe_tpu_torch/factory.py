"""Env factory — ``make_env`` drop-in for reference make_env.py:15-44
(counterpart of ``mpe_tpu/factory.py``).

    env = make_env('simple_spread')
    obs_n = env.reset()
    obs_n, reward_n, done_n, info_n = env.step(action_n)

``benchmark=True`` wires the scenario's ``benchmark_data`` into the info
channel (make_env.py:40-41). Extra keyword args configure what the
reference lacks: ``max_steps`` horizon, ``action_mode``, ``seed``,
``dtype``, and ``device`` (``None``: the CUDA card).
"""

from __future__ import annotations

from mpe_tpu_torch import scenarios
from mpe_tpu_torch.envs.wrappers import MultiAgentEnv


def make_env(scenario_name: str, benchmark: bool = False, **kwargs) -> MultiAgentEnv:
    scenario = scenarios.load(scenario_name)
    return MultiAgentEnv(scenario, benchmark=benchmark, **kwargs)
