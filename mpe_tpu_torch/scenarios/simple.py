"""Scenario ``simple``: 1 agent, 1 landmark, no collisions, no comm, batched.

Counterpart of ``mpe_tpu/scenarios/simple.py`` (reference
multiagent/scenarios/simple.py):
  - world: 1 non-colliding silent agent, 1 fixed landmark (simple.py:6-22);
  - reset: agent and landmark uniform in [-1, 1]^2, zero velocity
    (simple.py:33-39);
  - reward: -||agent - landmark||^2 (simple.py:41-43);
  - observation: [vel(2), landmark_rel(2)] = 4 (simple.py:45-50).
"""

from __future__ import annotations

import torch

from mpe_tpu_torch.core.state import make_spec
from mpe_tpu_torch.scenarios import _base as B


class SimpleScenario(B.Scenario):
    name = "simple"

    def __init__(self):
        self.spec = make_spec(
            "simple", n_agents=1, n_landmarks=1,
            agent_collide=False, agent_silent=True,
            dim_c=0,
        )
        self.obs_dims = (4,)

    def reset(self, n_envs, generator, dtype=torch.float32, device=None):
        return B.uniform_reset(self.spec, n_envs, generator, dtype, device)

    def reward(self, state):
        d2 = (state.pos[..., 0, :] - state.pos[..., 1, :]).square().sum(-1)
        return -d2[..., None]

    def observation(self, state):
        lead = state.pos.shape[:-2]
        rel = B.landmark_rel(self.spec, state).reshape(lead + (1, -1))
        return torch.cat([state.vel[..., :1, :], rel], dim=-1)

    def entity_colors(self, state):
        return B.const([[0.25, 0.25, 0.25], [0.75, 0.25, 0.25]], state).expand(
            state.t.shape + (2, 3))
