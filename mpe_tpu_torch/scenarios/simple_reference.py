"""Scenario ``simple_reference``: 2 speaking agents, 3 landmarks; each agent
guides the *other* to its private goal landmark over a 10-d comm channel.

Counterpart of ``mpe_tpu/scenarios/simple_reference.py`` (reference
multiagent/scenarios/simple_reference.py):
  - world: 2 non-colliding, non-silent agents, 3 landmarks, dim_c=10,
    collaborative (simple_reference.py:6-24);
  - reset: goal[..., i] is agent i's goal landmark, uniform over the 3
    (simple_reference.py:26-35);
  - reward: agent i gets -||other agent - its goal landmark||^2, shared by
    the collaborative sum (simple_reference.py:55-59);
  - observation: [vel(2), 3 landmark_rel(6), goal color(3), other's
    comm(10)] = 21 (simple_reference.py:61-80).
"""

from __future__ import annotations

import numpy as np
import torch

from mpe_tpu_torch.core.state import make_spec
from mpe_tpu_torch.scenarios import _base as B

LANDMARK_COLORS = np.array(
    [[0.75, 0.25, 0.25], [0.25, 0.75, 0.25], [0.25, 0.25, 0.75]]
)  # simple_reference.py:40-42


class SimpleReferenceScenario(B.Scenario):
    name = "simple_reference"

    def __init__(self):
        self.spec = make_spec(
            "simple_reference", n_agents=2, n_landmarks=3,
            agent_collide=False, agent_silent=False,
            dim_c=10, collaborative=True, n_goals=2,
        )
        self.obs_dims = (21, 21)

    def reset(self, n_envs, generator, dtype=torch.float32, device=None):
        return B.uniform_reset(self.spec, n_envs, generator, dtype, device, n_goal_choices=(3, 3))

    def reward(self, state):
        other = state.pos[..., [1, 0], :]                                  # [..., 2, P]
        lpos = B.landmark_pos(self.spec, state)[..., None, :, :]           # [..., 1, L, P]
        goal_pos = B.take_row(lpos, state.goal)                            # [..., 2, P]
        return -(other - goal_pos).square().sum(-1)

    def observation(self, state):
        spec = self.spec
        a = spec.n_agents
        lead = state.pos.shape[:-2]
        lrel = B.landmark_rel(spec, state).reshape(lead + (a, -1))
        goal_color = B.take_row(B.const(LANDMARK_COLORS, state), state.goal)   # [..., 2, 3]
        ocom = B.other_comm(spec, state).reshape(lead + (a, -1))
        return torch.cat([state.vel[..., :a, :], lrel, goal_color, ocom], dim=-1)

    def entity_colors(self, state):
        lmk = B.const(LANDMARK_COLORS, state)
        # agent 1 takes agent 0's goal color and vice versa (simple_reference.py:44-45)
        agents = B.take_row(lmk, state.goal)[..., [1, 0], :]
        return torch.cat([agents, lmk.expand(state.t.shape + (3, 3))], dim=-2)
