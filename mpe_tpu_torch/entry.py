"""Entry point of the port: the counterpart of ``__graft_entry__.entry``.

``entry()`` returns one batched simple_spread step (decode -> physics ->
obs -> reward -> auto-reset over 64 envs) and its inputs.
"""

from __future__ import annotations

import torch

from mpe_tpu_torch import scenarios
from mpe_tpu_torch._device import make_generator
from mpe_tpu_torch.envs.functional import MpeEnv


def entry(device=None):
    """-> (forward, (states, actions, generator)); ``forward`` returns
    (states, obs, reward, done). ``device=None`` means the card."""
    env = MpeEnv(scenarios.load("simple_spread"), max_steps=100, auto_reset=True, device=device)
    n_envs = 64

    def forward(states, actions, generator):
        states, obs, rew, done, _ = env.step(states, actions, generator)
        return states, obs, rew, done

    states, _ = env.reset(n_envs, make_generator(0, env.device))
    actions = torch.zeros((n_envs, env.n_agents, env.action_width), device=env.device)
    return forward, (states, actions, make_generator(1, env.device))
