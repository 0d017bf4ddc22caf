"""Scenario ``simple_tag`` (predator-prey): 3 slower adversaries chase 1
faster good agent around 2 large obstacle landmarks.

Counterpart of ``mpe_tpu/scenarios/simple_tag.py`` (reference
multiagent/scenarios/simple_tag.py):
  - world: adversaries size 0.075, accel 3.0, max_speed 1.0; the prey size
    0.05, accel 4.0, max_speed 1.3; 2 colliding immovable landmarks of size
    0.2 placed uniform(-0.9, 0.9); dim_c=2 (simple_tag.py:7-54);
  - reward, the shape=False branches the reference hardcodes (:92-93,
    :118): prey = -10 per adversary collision minus the screen-exit penalty
    ``bound_penalty(|x|)`` per axis (:89-113); each predator = +10 per
    collision of the prey with any predator (:115-129);
  - observation: [vel(2), pos(2), 2 landmark_rel(4), 3 other_pos(6), the
    prey's velocity (predators only)]: predator 16, prey 14 zero-padded
    to 16 (:131-147);
  - benchmark_data: each predator's collisions with the prey, 0 for the
    prey (:57-66).
"""

from __future__ import annotations

import torch

from mpe_tpu_torch.core.state import make_spec
from mpe_tpu_torch.scenarios import _base as B


class SimpleTagScenario(B.Scenario):
    per_agent_info = frozenset({"collisions"})
    name = "simple_tag"

    n_adversaries = 3

    def __init__(self):
        self.spec = make_spec(
            "simple_tag", n_agents=4, n_landmarks=2,
            agent_collide=True, agent_silent=True,
            agent_size=[0.075] * 3 + [0.05],
            agent_accel=[3.0] * 3 + [4.0],
            agent_max_speed=[1.0] * 3 + [1.3],
            adversary=[True] * 3 + [False],
            landmark_collide=True, landmark_size=0.2,
            dim_c=2,
        )
        self.obs_dims = (16, 16, 16, 14)

    def reset(self, n_envs, generator, dtype=torch.float32, device=None):
        return B.uniform_reset(self.spec, n_envs, generator, dtype, device, landmark_range=0.9)

    def _prey_collisions(self, state):
        """[..., 3] bool: is each adversary colliding with the prey."""
        return B.collisions(self.spec, state)[..., :3, 3]

    def reward(self, state):
        hits = self._prey_collisions(state).sum(-1).to(state.dtype)
        adv = 10.0 * hits
        prey = -10.0 * hits - B.bound_penalty(state.pos[..., 3, :].abs()).sum(-1)
        return torch.cat([adv[..., None].expand(adv.shape + (3,)), prey[..., None]], dim=-1)

    def observation(self, state):
        spec = self.spec
        a = spec.n_agents
        lead = state.pos.shape[:-2]
        lrel = B.landmark_rel(spec, state).reshape(lead + (a, -1))
        opos = B.other_rel(spec, state).reshape(lead + (a, -1))
        base = torch.cat([state.vel[..., :a, :], state.pos[..., :a, :], lrel, opos], dim=-1)
        prey_vel = state.vel[..., 3, :]
        rows = [torch.cat([base[..., i, :], prey_vel], dim=-1) for i in range(3)]
        rows.append(base[..., 3, :])
        return B.pad_stack(rows, self.obs_width)

    def benchmark_data(self, state):
        hits = self._prey_collisions(state).to(torch.int32)
        return {"collisions": torch.cat([hits, torch.zeros_like(hits[..., :1])], dim=-1)}

    def entity_colors(self, state):
        colors = [[0.85, 0.35, 0.35]] * 3 + [[0.35, 0.85, 0.35]] + [[0.25, 0.25, 0.25]] * 2
        return B.const(colors, state).expand(state.t.shape + (6, 3))
