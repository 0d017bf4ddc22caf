"""Scenario ``simple_crypto`` (covert communication): Alice must encrypt a
goal color with a shared key so that Bob can read it and the eavesdropper
Eve cannot. Every agent is immobile; the game is comm only.

Counterpart of ``mpe_tpu/scenarios/simple_crypto.py`` (reference
multiagent/scenarios/simple_crypto.py):
  - world: 3 immobile, non-colliding speaking agents: eve (index 0, the
    adversary), bob (1), alice (2, the speaker, holds the key); 2
    landmarks; dim_c=4 (simple_crypto.py:14-44);
  - a landmark's "color" is a one-hot of width dim_c (:55-59); the goal
    color and alice's key are each a random landmark's color (:61-63),
    stored as goal = [goal landmark, key landmark];
  - reward: alice and bob = -||bob.c - goal||^2 + ||eve.c - goal||^2, eve =
    -||eve.c - goal||^2, each term 0 for an all-zero utterance (:97-121);
  - observation: alice = [goal color(4), key(4)]; bob = [key(4),
    alice.c(4)]; eve = [alice.c(4)], zero-padded to 8 (only the speaker's
    comm is observed, :124-169);
  - benchmark_data: the utterances and the goal color (:78-80).
"""

from __future__ import annotations

import torch

from mpe_tpu_torch.core.state import make_spec
from mpe_tpu_torch.scenarios import _base as B


class SimpleCryptoScenario(B.Scenario):
    per_agent_info = frozenset({"comm"})
    name = "simple_crypto"

    def __init__(self):
        self.spec = make_spec(
            "simple_crypto", n_agents=3, n_landmarks=2,
            agent_movable=False, agent_collide=False, agent_silent=False,
            adversary=[True, False, False],
            dim_c=4, n_goals=2,
        )
        self.speaker = (False, False, True)  # simple_crypto.py:34
        self.obs_dims = (4, 8, 8)

    def reset(self, n_envs, generator, dtype=torch.float32, device=None):
        return B.uniform_reset(self.spec, n_envs, generator, dtype, device, n_goal_choices=(2, 2))

    def _landmark_color(self, idx, dtype):
        """The dim_c-wide one-hot color of landmark ``idx`` [...] -> [..., dim_c]."""
        width = torch.arange(self.spec.dim_c, device=idx.device)
        return (width == idx[..., None].long()).to(dtype)

    def reward(self, state):
        goal_color = self._landmark_color(state.goal[..., 0], state.dtype)

        def guarded_sqerr(c):
            err = (c - goal_color).square().sum(-1)
            return torch.where((c != 0).any(-1), err, torch.zeros((), dtype=err.dtype,
                                                                  device=err.device))

        eve = guarded_sqerr(state.comm[..., 0, :])
        good = -guarded_sqerr(state.comm[..., 1, :]) + eve
        return torch.stack([-eve, good, good], dim=-1)

    def observation(self, state):
        goal_color = self._landmark_color(state.goal[..., 0], state.dtype)
        key_color = self._landmark_color(state.goal[..., 1], state.dtype)
        alice_c = state.comm[..., 2, :]
        rows = [alice_c,                                              # eve
                torch.cat([key_color, alice_c], dim=-1),              # bob
                torch.cat([goal_color, key_color], dim=-1)]           # alice
        return B.pad_stack(rows, self.obs_width)

    def benchmark_data(self, state):
        return {"comm": state.comm,
                "goal_color": self._landmark_color(state.goal[..., 0], state.dtype)}

    def entity_colors(self, state):
        lead = state.t.shape
        eve = B.const([[0.75, 0.25, 0.25]], state).expand(lead + (1, 3))
        alice = B.const([[0.25, 0.25, 0.25]], state).expand(lead + (1, 3))
        # bob is painted the goal color (:62), cut from dim_c to RGB
        bob = self._landmark_color(state.goal[..., 0], state.dtype)[..., None, :3]
        lmk = B.const([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], state).expand(lead + (2, 3))
        return torch.cat([eve, bob, alice, lmk], dim=-2)
