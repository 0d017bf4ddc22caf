"""Batched functional multi-agent environment (PyTorch counterpart of
``mpe_tpu/envs/functional.py``; reference multiagent/environment.py:80-104).

Step order as in the reference: decode all actions -> one world step ->
obs / reward / done / info -> collaborative shared-reward broadcast
(``np.sum(reward_n)`` to every agent, environment.py:99-102). Termination
at ``max_steps`` and the all-agents-done auto-reset select are the JAX
package's additions, kept. The batch axis leads every tensor, as
``jax.vmap(env.step)`` gives it.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from mpe_tpu_torch._device import resolve_device
from mpe_tpu_torch.core.actions import ActionMode, action_width, decode_actions
from mpe_tpu_torch.core.physics import step_world
from mpe_tpu_torch.core.state import WorldState
from mpe_tpu_torch.envs import spaces
from mpe_tpu_torch.scenarios._base import Scenario


class MpeEnv:
    """Functional env for one scenario over a batch of envs.

    Actions are canonical rows per agent with a leading env axis:
    ``[B, A, 5+C]`` one-hots for DISCRETE, ``[B, A, P+C]`` for CONTINUOUS,
    ``[B, A, 2]`` ints for DISCRETE_INDEX. ``device=None`` means the CUDA
    card, and raises when none is visible.
    """

    def __init__(
        self,
        scenario: Scenario,
        action_mode: ActionMode = ActionMode.DISCRETE,
        max_steps: int | None = None,
        auto_reset: bool = False,
        dtype=torch.float32,
        device=None,
    ):
        self.scenario = scenario
        self.spec = scenario.spec
        self.action_mode = action_mode
        self.max_steps = max_steps
        self.auto_reset = auto_reset and max_steps is not None
        self.dtype = dtype
        self.device = resolve_device(device)
        self.n_agents = self.spec.n_agents
        self.action_width = action_width(self.spec, action_mode)

    def reset(self, n_envs: int, generator: torch.Generator) -> tuple[WorldState, torch.Tensor]:
        state = self.scenario.reset(n_envs, generator, self.dtype, self.device)
        return state, self.scenario.observation(state)

    def step(
        self,
        state: WorldState,
        actions: torch.Tensor,
        generator: torch.Generator | None = None,
        normals: tuple[torch.Tensor | None, torch.Tensor | None] | None = None,
    ) -> tuple[WorldState, torch.Tensor, torch.Tensor, torch.Tensor, dict[str, Any]]:
        """-> (state, obs [B, A, W], reward [B, A], done [B, A] bool, info).

        ``generator`` draws the noise and the auto-reset states; a config
        that needs either raises without one. ``normals`` injects the noise
        draws (see ``step_world``).
        """
        spec, scn = self.spec, self.scenario
        if actions.shape[-2:] != (self.n_agents, self.action_width):
            raise ValueError(
                f"actions must be [B, {self.n_agents}, {self.action_width}] "
                f"(canonical {self.action_mode.value} layout), got {tuple(actions.shape)}")
        noisy = bool(spec.u_noise.any() or spec.c_noise.any())
        if self.auto_reset and generator is None:
            raise ValueError("auto_reset draws fresh states every step; pass a generator")
        if noisy and generator is None and normals is None:
            raise ValueError("this spec sets u_noise/c_noise; pass a generator or normals")

        u, c = decode_actions(spec, actions, self.action_mode, self.dtype)
        scripted = scn.scripted_action(state)
        if scripted is not None:
            mask, u_s, c_s = scripted
            m = torch.as_tensor(mask, device=u.device)[:, None]
            u = torch.where(m, u_s.to(u.dtype), u)
            if spec.dim_c:
                c = torch.where(m, c_s.to(c.dtype), c)
        state = step_world(spec, state, u, c, generator, normals)

        obs = scn.observation(state)
        reward = scn.reward(state)
        if spec.collaborative:
            reward = reward.sum(-1, keepdim=True).expand(reward.shape)
        done = scn.done(state)
        if self.max_steps is not None:
            done = done | (state.t >= self.max_steps)[..., None]
        info = scn.benchmark_data(state) or {}

        if self.auto_reset:
            n_envs = state.t.shape[0]
            fresh, fresh_obs = self.reset(n_envs, generator)
            ep_done = done.all(-1)                                   # [B]

            def select(new, old):
                return torch.where(ep_done.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)

            state = fresh.map(select, state)
            obs = select(fresh_obs, obs)
        return state, obs, reward, done, info

    # space descriptors, assembled exactly like environment.py:38-70
    def action_spaces(self) -> list[spaces.Space]:
        out: list[spaces.Space] = []
        spec = self.spec
        discrete = self.action_mode is not ActionMode.CONTINUOUS
        for i in range(spec.n_agents):
            total: list[spaces.Space] = []
            if spec.movable[i]:
                total.append(
                    spaces.Discrete(spec.dim_p * 2 + 1)
                    if discrete
                    else spaces.Box(-float(spec.u_range[i]), float(spec.u_range[i]),
                                    (spec.dim_p,))
                )
            if not spec.silent[i]:
                total.append(
                    spaces.Discrete(spec.dim_c)
                    if discrete
                    else spaces.Box(0.0, 1.0, (spec.dim_c,))
                )
            if len(total) > 1:
                if all(isinstance(s, spaces.Discrete) for s in total):
                    out.append(spaces.MultiDiscrete.of([(0, s.n - 1) for s in total]))
                else:
                    out.append(spaces.Tuple(tuple(total)))
            else:
                out.append(total[0])
        return out

    def observation_spaces(self) -> list[spaces.Box]:
        return [spaces.Box(-math.inf, math.inf, (d,)) for d in self.scenario.obs_dims]
