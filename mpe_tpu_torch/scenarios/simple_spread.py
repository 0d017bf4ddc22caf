"""Scenario ``simple_spread`` (cooperative navigation), batched.

Counterpart of ``mpe_tpu/scenarios/simple_spread.py`` (reference
multiagent/scenarios/simple_spread.py):
  - world: 3 colliding silent agents (size 0.15), 3 landmarks, dim_c=2,
    collaborative (simple_spread.py:7-29);
  - reward: -sum_l min_a dist(a, l), minus 1 per collision counted over
    all agents *including itself* (simple_spread.py:72-82, 66-70), so each
    agent carries a -1 self-collision offset -- the reference quirk, kept;
  - observation: [vel(2), pos(2), 3 landmark_rel(6), 2 other_rel(4),
    2 other_comm(4)] = 18 (simple_spread.py:84-100);
  - benchmark_data: rew, collisions, min_dists, occupied_landmarks.
"""

from __future__ import annotations

import torch

from mpe_tpu_torch.core.state import make_spec
from mpe_tpu_torch.scenarios import _base as B


class SimpleSpreadScenario(B.Scenario):
    name = "simple_spread"

    def __init__(self):
        self.spec = make_spec(
            "simple_spread", n_agents=3, n_landmarks=3,
            agent_collide=True, agent_silent=True, agent_size=0.15,
            dim_c=2, collaborative=True,
        )
        self.obs_dims = (18, 18, 18)

    def reset(self, n_envs, generator, dtype=torch.float32, device=None):
        return B.uniform_reset(self.spec, n_envs, generator, dtype, device)

    def _min_dist_term(self, state):
        return B.agent_landmark_dist(self.spec, state).amin(-2)        # [..., L]

    def reward(self, state):
        common = -self._min_dist_term(state).sum(-1)                     # [...]
        ncol = B.collisions(self.spec, state).sum(-2).to(state.dtype)   # [..., A]
        return common[..., None] - ncol

    def observation(self, state):
        spec = self.spec
        a = spec.n_agents
        lead = state.pos.shape[:-2]
        lrel = B.landmark_rel(spec, state).reshape(lead + (a, -1))
        orel = B.other_rel(spec, state).reshape(lead + (a, -1))
        ocom = B.other_comm(spec, state).reshape(lead + (a, -1))
        return torch.cat([state.vel[..., :a, :], state.pos[..., :a, :], lrel, orel, ocom], dim=-1)

    def benchmark_data(self, state):
        mins = self._min_dist_term(state)
        return {
            "rew": self.reward(state),
            "collisions": B.collisions(self.spec, state).sum(-2),
            "min_dists": mins.sum(-1),
            "occupied_landmarks": (mins < 0.1).sum(-1),
        }
