"""Scenario ``simple_adversary`` (physical deception): two good agents must
cover the goal landmark while an adversary that does not know which landmark
is the goal tries to reach it too.

Counterpart of ``mpe_tpu/scenarios/simple_adversary.py`` (reference
multiagent/scenarios/simple_adversary.py):
  - world: 3 agents (agent 0 the adversary), 2 landmarks; no collisions,
    all silent; agent size 0.15, landmark size 0.08; dim_c=2
    (simple_adversary.py:8-33);
  - reward, the shaped branch the reference hardcodes (:82-107): good =
    -min_good dist(good, goal) + dist(adversary, goal); adversary =
    -||adversary - goal||^2 (:109-118);
  - observation: good = [goal_rel(2), 2 landmark_rel(4), 2 other_rel(4)] =
    10; adversary = 8 without the goal, zero-padded to 10 (:121-139);
  - benchmark_data: ``dists`` = the squared distances to each landmark and
    to the goal per agent, ``adversary_goal_sqdist`` (:57-66).
"""

from __future__ import annotations

import torch

from mpe_tpu_torch.core.state import make_spec
from mpe_tpu_torch.scenarios import _base as B


class SimpleAdversaryScenario(B.Scenario):
    per_agent_info = frozenset({"dists"})
    name = "simple_adversary"

    def __init__(self):
        self.spec = make_spec(
            "simple_adversary", n_agents=3, n_landmarks=2,
            agent_collide=False, agent_silent=True, agent_size=0.15,
            adversary=[True, False, False], landmark_size=0.08,
            dim_c=2, n_goals=1,
        )
        self.obs_dims = (8, 10, 10)

    def reset(self, n_envs, generator, dtype=torch.float32, device=None):
        return B.uniform_reset(self.spec, n_envs, generator, dtype, device, n_goal_choices=(2,))

    def _goal_pos(self, state):
        return B.take_row(B.landmark_pos(self.spec, state), state.goal[..., 0])    # [..., P]

    def _goal_dists(self, state):
        return (state.pos[..., :3, :] - self._goal_pos(state)[..., None, :]).square().sum(-1).sqrt()

    def reward(self, state):
        d = self._goal_dists(state)                                            # [..., A]
        adv = -d[..., 0].square()
        good = -torch.minimum(d[..., 1], d[..., 2]) + d[..., 0]
        return torch.stack([adv, good, good], dim=-1)

    def observation(self, state):
        spec = self.spec
        a = spec.n_agents
        lead = state.pos.shape[:-2]
        goal_rel = self._goal_pos(state)[..., None, :] - state.pos[..., :a, :]  # [..., A, P]
        lrel = B.landmark_rel(spec, state).reshape(lead + (a, -1))
        orel = B.other_rel(spec, state).reshape(lead + (a, -1))
        rows = [torch.cat([lrel[..., 0, :], orel[..., 0, :]], dim=-1)]         # no goal
        rows += [torch.cat([goal_rel[..., i, :], lrel[..., i, :], orel[..., i, :]], dim=-1)
                 for i in (1, 2)]
        return B.pad_stack(rows, self.obs_width)

    def benchmark_data(self, state):
        d2 = B.agent_landmark_dist(self.spec, state).square()                 # [..., A, L]
        goal_d2 = self._goal_dists(state).square()                             # [..., A]
        return {"dists": torch.cat([d2, goal_d2[..., None]], dim=-1),
                "adversary_goal_sqdist": goal_d2[..., 0]}

    def entity_colors(self, state):
        lead = state.t.shape
        is_goal = torch.arange(2, device=state.device) == state.goal[..., :1].long()   # [..., L]
        lmk = torch.where(is_goal[..., None], B.const([0.15, 0.65, 0.15], state),
                          B.const([0.15, 0.15, 0.15], state))
        agents = B.const([[0.85, 0.35, 0.35], [0.35, 0.35, 0.85], [0.35, 0.35, 0.85]], state)
        return torch.cat([agents.expand(lead + (3, 3)), lmk], dim=-2)
