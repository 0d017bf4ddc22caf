"""Scenario ``simple_push`` (keep-away): an adversary is rewarded for pushing
the good agent away from its goal landmark.

Counterpart of ``mpe_tpu/scenarios/simple_push.py`` (reference
multiagent/scenarios/simple_push.py):
  - world: 2 colliding silent agents (agent 0 the adversary), 2 landmarks,
    dim_c=2, a random goal landmark (simple_push.py:6-56);
  - reward: good = -dist(good, goal) (:62-64); adversary =
    min_good dist(good, goal) - dist(adversary, goal) (:66-74);
  - observation: good = [vel(2), goal_rel(2), own color(3), 2
    landmark_rel(4), 2 landmark colors(6), other_rel(2)] = 19; adversary =
    [vel(2), 2 landmark_rel(4), other_rel(2)] = 8, zero-padded (:76-96).
    The landmark colors are 0.1 grey with channel i+1 at 0.9 (:35-37); the
    good agent's own color is 0.25 grey with channel goal+1 raised by 0.5
    (:43-48), so both depend on the goal and are computed from it.
"""

from __future__ import annotations

import numpy as np
import torch

from mpe_tpu_torch.core.state import make_spec
from mpe_tpu_torch.scenarios import _base as B

LANDMARK_COLORS = np.array([[0.1, 0.9, 0.1], [0.1, 0.1, 0.9]])


class SimplePushScenario(B.Scenario):
    name = "simple_push"

    def __init__(self):
        self.spec = make_spec(
            "simple_push", n_agents=2, n_landmarks=2,
            agent_collide=True, agent_silent=True,
            adversary=[True, False],
            dim_c=2, n_goals=1,
        )
        self.obs_dims = (8, 19)

    def reset(self, n_envs, generator, dtype=torch.float32, device=None):
        return B.uniform_reset(self.spec, n_envs, generator, dtype, device, n_goal_choices=(2,))

    def _goal_pos(self, state):
        return B.take_row(B.landmark_pos(self.spec, state), state.goal[..., 0])    # [..., P]

    def _own_color(self, state):
        """[0.25] * 3 with channel goal+1 raised by 0.5."""
        channel = torch.arange(3, device=state.device) == state.goal[..., :1].long() + 1
        return B.const([0.25, 0.25, 0.25], state) + 0.5 * channel.to(state.dtype)

    def reward(self, state):
        d = (state.pos[..., :2, :] - self._goal_pos(state)[..., None, :]).square().sum(-1).sqrt()
        return torch.stack([d[..., 1] - d[..., 0], -d[..., 1]], dim=-1)

    def observation(self, state):
        spec = self.spec
        lead = state.pos.shape[:-2]
        lrel = B.landmark_rel(spec, state).reshape(lead + (2, -1))
        orel = B.other_rel(spec, state).reshape(lead + (2, -1))
        lcolors = B.const(LANDMARK_COLORS.ravel(), state).expand(lead + (6,))
        adv = torch.cat([state.vel[..., 0, :], lrel[..., 0, :], orel[..., 0, :]], dim=-1)
        good = torch.cat([state.vel[..., 1, :], self._goal_pos(state) - state.pos[..., 1, :],
                          self._own_color(state), lrel[..., 1, :], lcolors, orel[..., 1, :]],
                         dim=-1)
        return B.pad_stack([adv, good], self.obs_width)

    def entity_colors(self, state):
        lead = state.t.shape
        adv = B.const([[0.75, 0.25, 0.25]], state).expand(lead + (1, 3))
        return torch.cat([adv, self._own_color(state)[..., None, :],
                          B.const(LANDMARK_COLORS, state).expand(lead + (2, 3))], dim=-2)
