"""Scenario ``simple_speaker_listener`` (cooperative communication): an
immobile speaker tells a mute listener which landmark to reach.

Counterpart of ``mpe_tpu/scenarios/simple_speaker_listener.py`` (reference
multiagent/scenarios/simple_speaker_listener.py):
  - world: agent 0 the speaker (movable=False), agent 1 the listener
    (silent), both size 0.075, 3 landmarks of size 0.04, dim_c=3,
    collaborative (simple_speaker_listener.py:6-31);
  - reward: -||listener - goal landmark||^2 for both agents
    (simple_speaker_listener.py:63-67);
  - observation: speaker = the goal landmark's color (3, zero-padded to
    11); listener = [vel(2), 3 landmark_rel(6), speaker's comm(3)] = 11
    (simple_speaker_listener.py:69-91);
  - the reference's ``benchmark_data`` crashes (it passes the bound method
    instead of the world, :59-61); this one returns the reward it intended.
"""

from __future__ import annotations

import numpy as np
import torch

from mpe_tpu_torch.core.state import make_spec
from mpe_tpu_torch.scenarios import _base as B

LANDMARK_COLORS = np.array(
    [[0.65, 0.15, 0.15], [0.15, 0.65, 0.15], [0.15, 0.15, 0.65]]
)  # simple_speaker_listener.py:45-47


class SimpleSpeakerListenerScenario(B.Scenario):
    per_agent_info = frozenset({"rew"})
    name = "simple_speaker_listener"

    def __init__(self):
        self.spec = make_spec(
            "simple_speaker_listener", n_agents=2, n_landmarks=3,
            agent_collide=False, agent_size=0.075,
            agent_movable=[False, True], agent_silent=[False, True],
            landmark_size=0.04,
            dim_c=3, collaborative=True, n_goals=1,
        )
        self.obs_dims = (3, 11)

    def reset(self, n_envs, generator, dtype=torch.float32, device=None):
        return B.uniform_reset(self.spec, n_envs, generator, dtype, device, n_goal_choices=(3,))

    def reward(self, state):
        goal_pos = B.take_row(B.landmark_pos(self.spec, state), state.goal[..., 0])
        d2 = (state.pos[..., 1, :] - goal_pos).square().sum(-1)
        return (-d2)[..., None].expand(d2.shape + (2,))

    def observation(self, state):
        lead = state.pos.shape[:-2]
        goal_color = B.take_row(B.const(LANDMARK_COLORS, state), state.goal[..., 0])
        lrel = B.landmark_rel(self.spec, state)[..., 1, :, :].reshape(lead + (-1,))
        listener = torch.cat([state.vel[..., 1, :], lrel, state.comm[..., 0, :]], dim=-1)
        return B.pad_stack([goal_color, listener], self.obs_width)

    def benchmark_data(self, state):
        return {"rew": self.reward(state)}

    def entity_colors(self, state):
        lmk = B.const(LANDMARK_COLORS, state)
        # the listener (the speaker's goal_a) takes the goal color + 0.45
        # grey (simple_speaker_listener.py:49)
        listener = B.take_row(lmk, state.goal[..., 0]) + 0.45
        speaker = B.const([[0.25, 0.25, 0.25]], state).expand(state.t.shape + (1, 3))
        return torch.cat([speaker, listener[..., None, :], lmk.expand(state.t.shape + (3, 3))],
                         dim=-2)
