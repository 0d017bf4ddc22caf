"""Stateful gym-style wrappers over the batched functional env
(counterpart of ``mpe_tpu/envs/wrappers.py``).

``MultiAgentEnv`` is the drop-in equivalent of the reference's class of the
same name (reference multiagent/environment.py:9-263):
``step(action_n) -> (obs_n, reward_n, done_n, info_n)`` with per-agent
Python lists and ragged reference-format actions, ``reset() -> obs_n``,
``.n``/``.action_space``/``.observation_space``. It steps a batch of one
env, so its ``.state`` has a leading env axis of size 1.

``VecMultiAgentEnv`` replaces ``BatchMultiAgentEnv`` (environment.py:
288-335): instead of a Python loop over sub-envs it is one batched step of
``MpeEnv`` over an env axis.

Every wrapper takes ``device=None`` (the CUDA card; it raises when none is
visible) and draws with a ``torch.Generator`` on that device.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from mpe_tpu_torch._device import make_generator, to_host
from mpe_tpu_torch.core.actions import ActionMode
from mpe_tpu_torch.envs.functional import MpeEnv


def pack_actions(env: MpeEnv, action_n: Sequence[Any]) -> torch.Tensor:
    """Reference-format per-agent actions -> canonical padded ``[A, W]`` on
    ``env.device`` (``env.dtype``, int32 for DISCRETE_INDEX).

    The reference hands each agent only the segments its action space has
    (movement iff movable, comm iff non-silent; environment.py:44-66) and
    splits MultiDiscrete actions by sub-space size (environment.py:148-155).
    A wrong count or length raises ``AssertionError``, as the reference's
    ``assert len(action) == 0`` (environment.py:192) does.
    """
    spec, mode = env.spec, env.action_mode
    a = spec.n_agents
    if len(action_n) != a:
        raise AssertionError(f"expected {a} actions, got {len(action_n)}")
    if mode is ActionMode.DISCRETE_INDEX:
        rows = np.zeros((a, 2), np.int32)
        for i, act in enumerate(action_n):
            segs = np.atleast_1d(to_host(act).astype(np.int32))
            j = 0
            if spec.movable[i]:
                rows[i, 0] = segs[j]
                j += 1
            if not spec.silent[i]:
                rows[i, 1] = segs[j]
                j += 1
            if j != len(segs):
                raise AssertionError(f"agent {i}: unconsumed action elements")
        return torch.as_tensor(rows, device=env.device)

    move_w = 2 * spec.dim_p + 1 if mode is ActionMode.DISCRETE else spec.dim_p
    rows = np.zeros((a, env.action_width), np.float64)
    for i, act in enumerate(action_n):
        act = to_host(act).astype(np.float64).ravel()
        expected = (move_w if spec.movable[i] else 0) + (0 if spec.silent[i] else spec.dim_c)
        if len(act) != expected:
            raise AssertionError(f"agent {i}: action length {len(act)} != expected {expected}")
        j = 0
        if spec.movable[i]:
            rows[i, :move_w] = act[:move_w]
            j = move_w
        if not spec.silent[i]:
            rows[i, move_w:] = act[j : j + spec.dim_c]
    return torch.as_tensor(rows, dtype=env.dtype, device=env.device)


class MultiAgentEnv:
    """Stateful convenience wrapper; one env, host-friendly API."""

    metadata = {"render.modes": ["human", "rgb_array"]}

    def __init__(
        self,
        scenario_or_env,
        *,
        action_mode: ActionMode = ActionMode.DISCRETE,
        max_steps: int | None = None,
        seed: int = 0,
        benchmark: bool = False,
        shared_viewer: bool = True,
        dtype=torch.float32,
        device=None,
    ):
        if isinstance(scenario_or_env, MpeEnv):
            self.env = scenario_or_env
        else:
            self.env = MpeEnv(scenario_or_env, action_mode=action_mode, max_steps=max_steps,
                              dtype=dtype, device=device)
        self.scenario = self.env.scenario
        self.world_spec = self.env.spec
        self.n = self.env.n_agents
        self.benchmark = benchmark
        self.discrete_action_input = self.env.action_mode is ActionMode.DISCRETE_INDEX
        self.action_space = self.env.action_spaces()
        self.observation_space = self.env.observation_spaces()
        self.shared_viewer = shared_viewer
        self.seed(seed)
        self.state = None
        self.time = 0
        self._viewers = [None] * (1 if shared_viewer else self.n)
        self._render_geoms = None
        self._render_xforms = None

    def seed(self, seed: int):
        self._generator = make_generator(seed, self.env.device)

    def reset(self) -> list[np.ndarray]:
        self.state, obs = self.env.reset(1, self._generator)
        self.time = 0
        # drop cached render geoms (reference _reset_render, env.py:195-197)
        self._render_geoms = None
        self._render_xforms = None
        return self._split_obs(obs)

    def step(self, action_n: Sequence[Any]):
        if self.state is None:
            self.reset()
        actions = pack_actions(self.env, action_n)[None]
        self.state, obs, reward, done, info = self.env.step(self.state, actions, self._generator)
        self.time += 1
        obs_n = self._split_obs(obs)
        reward_n = [float(r) for r in to_host(reward[0])]
        done_n = [bool(d) for d in to_host(done[0])]
        info_n = {"n": self._split_info(info)}
        return obs_n, reward_n, done_n, info_n

    def _split_obs(self, obs) -> list[np.ndarray]:
        obs = to_host(obs[0])
        return [obs[i, :d] for i, d in enumerate(self.scenario.obs_dims)]

    def _split_info(self, info: dict) -> list[dict]:
        """Per-agent info dicts: leaves the scenario DECLARES per-agent
        (``Scenario.per_agent_info``) are split on their agent axis, the one
        after the env axis; everything else is global and handed to every
        agent whole — no shape heuristics (a global leaf with n_agents rows
        would be silently misattributed by one)."""
        if not self.benchmark or not info:
            return [{} for _ in range(self.n)]
        per_agent = self.scenario.per_agent_info
        host = {k: to_host(v[0]) for k, v in info.items()}
        for k in per_agent & host.keys():
            assert host[k].ndim > 0 and host[k].shape[0] == self.n, (
                f"info leaf {k!r} declared per-agent but has shape "
                f"{host[k].shape} (need leading axis {self.n})")
        return [
            {k: (v[i] if k in per_agent else v) for k, v in host.items()}
            for i in range(self.n)
        ]

    def render(self, mode: str = "human"):
        """One frame per viewer (``render.render_env``): ``(700, 700, 3)``
        uint8 arrays for ``mode='rgb_array'``, else whether each viewer is
        open."""
        from mpe_tpu_torch.render import render_env

        if self.state is None:
            self.reset()
        return render_env(self, mode)

    def close(self):
        for v in self._viewers:
            if v is not None:
                v.close()
        self._viewers = [None] * len(self._viewers)


class VecMultiAgentEnv:
    """``BatchMultiAgentEnv`` equivalent: N lockstep envs in one batched
    step (vs the reference's sequential Python loop over sub-envs,
    environment.py:309-322). Works directly on canonical batched tensors:
    actions [N, A, W] -> obs [N, A, O], rewards [N, A], dones [N, A], on
    ``env.device``."""

    def __init__(self, env: MpeEnv, n_envs: int, seed: int = 0):
        self.env = env
        self.n_envs = n_envs
        self.n = n_envs * env.n_agents  # reference .n semantics (env.py:297-299)
        self._generator = make_generator(seed, env.device)
        self.states = None

    @property
    def action_space(self):
        return self.env.action_spaces()

    @property
    def observation_space(self):
        return self.env.observation_spaces()

    def reset(self):
        self.states, obs = self.env.reset(self.n_envs, self._generator)
        return obs

    def step(self, actions):
        if self.states is None:
            self.reset()
        actions = torch.as_tensor(actions, device=self.env.device)
        self.states, obs, rew, done, info = self.env.step(self.states, actions, self._generator)
        return obs, rew, done, info
