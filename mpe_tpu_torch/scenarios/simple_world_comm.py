"""Scenario ``simple_world_comm``: the full feature union. A speaking
adversary leader coordinates 3 silent predators chasing 2 prey that can hide
in forests and eat food, around an obstacle.

Counterpart of ``mpe_tpu/scenarios/simple_world_comm.py`` (reference
multiagent/scenarios/simple_world_comm.py):
  - world: 6 agents: index 0 the leader adversary (not silent), 1-3 silent
    adversaries (size 0.075, accel 3, max_speed 1), 4-5 good (size 0.045,
    accel 4, max_speed 1.3); landmarks [obstacle (0.2, collides), food0,
    food1 (0.03), forest0, forest1 (0.3)] (:7-53); dim_c=4; landmarks
    uniform(-0.9, 0.9);
  - good reward (shape=False, :155-183): -5 per adversary collision, twice
    the boundary penalty, +2 per food touched, and the reference's
    **positive** 0.05 * min food distance (:181), kept;
  - adversary reward (shape=True here, :185-198): -0.1 * min distance to a
    good agent + 5 per colliding (good, adversary) pair;
  - observation (:224-287): in-forest flags (+1/-1) per forest; another
    agent's position and velocity are zeroed unless both are in the same
    forest, both are outside every forest, or the observer is the leader;
    the comm is the leader's utterance, broadcast (:279). Rows: adversary
    (the leader too) [vel2, pos2, landmarks10, other_pos10, other_vel4,
    in_forest2, leader_comm4] = 34; good [vel2, pos2, landmarks10,
    other_pos10, in_forest2, other_vel2] = 28, zero-padded to 34;
  - benchmark_data: each adversary's collisions with good agents
    (:115-123).
  - The reference's dead code (set_boundaries :59-85, observation2
    :201-222, prey_forest/prey_forest_lead :263-277) is not reproduced.
"""

from __future__ import annotations

import numpy as np
import torch

from mpe_tpu_torch._device import device_table
from mpe_tpu_torch.core.state import make_spec
from mpe_tpu_torch.scenarios import _base as B

N_ADV = 4
N_GOOD = 2
# landmark layout: [obstacle, food0, food1, forest0, forest1]
FOOD = np.array([1, 2])
FORESTS = np.array([3, 4])


class SimpleWorldCommScenario(B.Scenario):
    per_agent_info = frozenset({"collisions"})
    name = "simple_world_comm"

    def __init__(self):
        self.spec = make_spec(
            "simple_world_comm", n_agents=6, n_landmarks=5,
            agent_collide=True,
            agent_silent=[False] + [True] * 5,
            agent_size=[0.075] * 4 + [0.045] * 2,
            agent_accel=[3.0] * 4 + [4.0] * 2,
            agent_max_speed=[1.0] * 4 + [1.3] * 2,
            adversary=[True] * 4 + [False] * 2,
            leader=[True] + [False] * 5,
            landmark_collide=[True, False, False, False, False],
            landmark_size=[0.2, 0.03, 0.03, 0.3, 0.3],
            dim_c=4,
        )
        self.obs_dims = (34, 34, 34, 34, 28, 28)

    def reset(self, n_envs, generator, dtype=torch.float32, device=None):
        return B.uniform_reset(self.spec, n_envs, generator, dtype, device, landmark_range=0.9)

    def _entity_collisions(self, state, lmk):
        """[..., A, K] bool: agent vs the landmarks ``lmk`` (``is_collision``)."""
        spec = self.spec
        a = spec.n_agents
        d = B.pairwise_dist(state.pos[..., :a, :], state.pos[..., a + lmk, :])
        smin = spec.size[:a, None] + spec.size[a + lmk][None, :]
        return d < device_table(smin, state.dtype, state.device)

    def reward(self, state):
        spec = self.spec
        dtype = state.dtype
        col = B.collisions(spec, state)                                   # [..., A, A]
        good_adv_hits = col[..., N_ADV:, :N_ADV]                          # [..., good, adv]
        # each colliding (good, adversary) pair is worth +5 to every adversary
        pair_hits = good_adv_hits.sum((-2, -1)).to(dtype)
        apos = state.pos[..., :spec.n_agents, :]
        d_good_adv = B.pairwise_dist(apos[..., N_ADV:, :], apos[..., :N_ADV, :])
        adv = -0.1 * d_good_adv.amin(-2) + 5.0 * pair_hits[..., None]     # [..., adv]

        hits_per_good = good_adv_hits.sum(-1).to(dtype)                   # [..., good]
        bound = B.bound_penalty(apos[..., N_ADV:, :].abs()).sum(-1)
        food_col = self._entity_collisions(state, FOOD)[..., N_ADV:, :]   # [..., good, 2]
        food_d = B.pairwise_dist(apos[..., N_ADV:, :], state.pos[..., spec.n_agents + FOOD, :])
        good = (-5.0 * hits_per_good - 2.0 * bound + 2.0 * food_col.sum(-1).to(dtype)
                + 0.05 * food_d.amin(-1))
        return torch.cat([adv, good], dim=-1)

    def observation(self, state):
        spec = self.spec
        a = spec.n_agents
        lead = state.pos.shape[:-2]
        lrel = B.landmark_rel(spec, state).reshape(lead + (a, -1))        # [..., A, 10]
        in_forest = self._entity_collisions(state, FORESTS)               # [..., A, 2]
        in_forest_pm = torch.where(in_forest, 1.0, -1.0).to(state.dtype)

        # pairwise visibility (observation :252-261): the same forest, both
        # outside every forest, or the observer is the leader
        same_forest = (in_forest[..., :, None, :] & in_forest[..., None, :, :]).any(-1)
        outside = ~in_forest.any(-1)                                      # [..., A]
        both_out = outside[..., :, None] & outside[..., None, :]
        vis = same_forest | both_out | device_table(spec.leader[:, None], device=state.device)

        oi = spec.others_idx                                              # [A, A-1]
        apos, avel = state.pos[..., :a, :], state.vel[..., :a, :]
        idx = device_table(oi, torch.int64, state.device)
        rel = apos[..., idx, :] - apos[..., :, None, :]                   # [..., A, A-1, P]
        vis_o = vis[..., device_table(np.arange(a)[:, None], torch.int64, state.device), idx]
        zero = torch.zeros((), dtype=state.dtype, device=state.device)
        other_pos = torch.where(vis_o[..., None], rel, zero).reshape(lead + (a, -1))
        other_vel = torch.where(vis_o[..., None], avel[..., idx, :], zero)  # [..., A, A-1, P]
        leader_c = state.comm[..., 0, :]

        rows = []
        for i in range(a):
            # velocities of the good others, in world order (:256-261)
            goods = [k for k, j in enumerate(oi[i]) if not spec.adversary[j]]
            ovel = other_vel[..., i, goods, :].reshape(lead + (-1,))
            head = [avel[..., i, :], apos[..., i, :], lrel[..., i, :], other_pos[..., i, :]]
            tail = ([ovel, in_forest_pm[..., i, :], leader_c] if spec.adversary[i]
                    else [in_forest_pm[..., i, :], ovel])
            rows.append(torch.cat(head + tail, dim=-1))
        return B.pad_stack(rows, self.obs_width)

    def benchmark_data(self, state):
        col = B.collisions(self.spec, state)
        hits = col[..., :N_ADV, N_ADV:].sum(-1).to(torch.int32)           # [..., adv]
        zeros = torch.zeros(hits.shape[:-1] + (N_GOOD,), dtype=torch.int32, device=hits.device)
        return {"collisions": torch.cat([hits, zeros], dim=-1)}

    def entity_colors(self, state):
        colors = ([[0.65, 0.15, 0.15]]            # the leader adversary
                  + [[0.95, 0.45, 0.45]] * 3      # adversaries
                  + [[0.45, 0.95, 0.45]] * 2      # good agents
                  + [[0.25, 0.25, 0.25]]          # the obstacle
                  + [[0.15, 0.15, 0.65]] * 2      # food
                  + [[0.6, 0.9, 0.6]] * 2)        # forests
        return B.const(colors, state).expand(state.t.shape + (11, 3))
