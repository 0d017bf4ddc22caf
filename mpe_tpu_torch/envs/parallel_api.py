"""PettingZoo-style Parallel API adapter (counterpart of
``mpe_tpu/envs/parallel_api.py``).

Modern users consume MPE through PettingZoo's ``parallel_env`` interface
(agent-name-keyed dicts, terminations/truncations split, ``max_cycles``).
This adapter gives that surface over the port's engine:

    env = parallel_env("simple_spread", max_cycles=25)
    obs, infos = env.reset(seed=42)
    gen = torch.Generator(device="cuda").manual_seed(0)
    while env.agents:
        actions = {a: env.action_space(a).sample(gen) for a in env.agents}
        obs, rewards, terminations, truncations, infos = env.step(actions)

Actions are accepted in PettingZoo's native formats — a plain int for
``Discrete`` spaces, an int vector for ``MultiDiscrete``, arrays for
``Box`` — as well as the reference's one-hot format, as numpy arrays,
Python values or tensors on any device. Semantics follow the original
OpenAI repo, not PettingZoo's fork (rewards keep the reference's
shared-sum broadcast and self-collision quirk). Terminations come from the
scenario's ``done`` hook (always False for the built-in scenarios,
environment.py:132-135); truncations fire at ``max_cycles`` like
PettingZoo's time limit. An agent that reports termination or truncation
leaves ``agents`` after that step (COMPONENTS.md §2.4).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from mpe_tpu_torch._device import to_host
from mpe_tpu_torch.core.actions import ActionMode
from mpe_tpu_torch.envs import spaces
from mpe_tpu_torch.envs.wrappers import MultiAgentEnv


def default_agent_names(spec) -> list[str]:
    """PettingZoo-style names derived from the entity table: leaders ->
    'leadadversary_i', adversaries -> 'adversary_i', others 'agent_i'."""
    names, counts = [], {"leadadversary": 0, "adversary": 0, "agent": 0}
    for i in range(spec.n_agents):
        if spec.leader[i]:
            kind = "leadadversary"
        elif spec.adversary[i]:
            kind = "adversary"
        else:
            kind = "agent"
        names.append(f"{kind}_{counts[kind]}")
        counts[kind] += 1
    return names


# scenarios where PettingZoo uses role names instead of the generic ones
_SPECIAL_NAMES = {
    "simple_speaker_listener": ["speaker_0", "listener_0"],
    "simple_crypto": ["eve_0", "bob_0", "alice_0"],
}


def _onehot(idx: int, n: int) -> np.ndarray:
    out = np.zeros(n)
    out[int(idx)] = 1.0
    return out


class ParallelEnv:
    """Agent-name-keyed parallel environment (PettingZoo Parallel API).

    A thin dict<->list translation over the stateful ``MultiAgentEnv``
    wrapper (which owns the generator and the obs/info splitting)."""

    def __init__(
        self,
        scenario,
        max_cycles: int = 25,
        action_mode: ActionMode = ActionMode.DISCRETE,
        seed: int = 0,
        benchmark: bool = False,
        device=None,
    ):
        if isinstance(scenario, str):
            from mpe_tpu_torch import scenarios as registry

            scenario = registry.load(scenario)
        self._env = MultiAgentEnv(scenario, action_mode=action_mode, seed=seed,
                                  benchmark=benchmark, device=device)
        self.max_cycles = max_cycles
        spec = self._env.world_spec
        self.possible_agents = _SPECIAL_NAMES.get(spec.name, default_agent_names(spec))
        self.agents: list[str] = []
        self._action_spaces = dict(zip(self.possible_agents, self._env.action_space))
        self._obs_spaces = dict(zip(self.possible_agents, self._env.observation_space))
        self._t = 0

    # -- spaces ----------------------------------------------------------
    def action_space(self, agent: str):
        return self._action_spaces[agent]

    def observation_space(self, agent: str):
        return self._obs_spaces[agent]

    @property
    def num_agents(self) -> int:
        return len(self.agents)

    # -- action-format translation ---------------------------------------
    def _to_reference_format(self, agent: str, action: Any):
        """PettingZoo-native action -> the reference per-agent format that
        ``pack_actions`` consumes (one-hot segments), as numpy."""
        space = self._action_spaces[agent]
        if isinstance(space, spaces.Discrete):
            a = to_host(action)
            if a.ndim == 0:                       # plain int (PettingZoo)
                return _onehot(int(a), space.n)
            return a                              # already one-hot
        if isinstance(space, spaces.MultiDiscrete):
            a = to_host(action).ravel()
            widths = [hi - lo + 1 for lo, hi in zip(space.low, space.high)]
            if len(a) == len(widths):             # int per sub-space
                return np.concatenate([_onehot(int(v), w) for v, w in zip(a, widths)])
            return a                              # concatenated one-hots
        if isinstance(space, spaces.Tuple):
            return np.concatenate([to_host(x).ravel() for x in action])
        return to_host(action)                    # Box

    # -- episode ----------------------------------------------------------
    def reset(self, seed: int | None = None):
        if seed is not None:
            self._env.seed(seed)
        obs_n = self._env.reset()
        self._t = 0
        self.agents = list(self.possible_agents)
        infos: dict[str, dict[str, Any]] = {a: {} for a in self.agents}
        return dict(zip(self.possible_agents, obs_n)), infos

    def _zero_action(self, agent: str) -> np.ndarray:
        """No-op action in the reference per-agent format, supplied for
        agents that already left ``self.agents`` (their entity stays in
        the world — the reference has no removal — but stops acting)."""
        space = self._action_spaces[agent]
        if isinstance(space, spaces.Discrete):
            return np.zeros(space.n)
        if isinstance(space, spaces.MultiDiscrete):
            return np.zeros(int(sum(space.sizes)))
        if isinstance(space, spaces.Tuple):
            return np.concatenate([np.zeros(np.prod(s.shape)) for s in space.spaces])
        return np.zeros(space.shape)               # Box

    def step(self, actions: dict[str, Any]):
        if not self.agents:
            raise AssertionError("step() called on a finished episode; reset()")
        live = list(self.agents)
        missing = set(live) - set(actions)
        if missing:
            raise AssertionError(f"missing actions for {sorted(missing)}")
        action_n = [self._to_reference_format(a, actions[a])
                    if a in actions and a in live else self._zero_action(a)
                    for a in self.possible_agents]
        obs_n, reward_n, done_n, info_n = self._env.step(action_n)
        self._t += 1
        idx = {a: i for i, a in enumerate(self.possible_agents)}
        # scenario done hook -> terminations; max_cycles -> truncations;
        # outputs are keyed by the agents live at THIS step, and agents
        # reporting termination/truncation leave self.agents afterwards
        # (the PettingZoo contract for partial termination)
        terminations = {a: bool(done_n[idx[a]]) for a in live}
        trunc = self._t >= self.max_cycles
        truncations = {a: trunc for a in live}
        self.agents = [a for a in live if not (terminations[a] or truncations[a])]
        return ({a: obs_n[idx[a]] for a in live},
                {a: reward_n[idx[a]] for a in live},
                terminations, truncations,
                {a: info_n["n"][idx[a]] for a in live})

    def close(self):
        self._env.close()


def parallel_env(scenario, **kwargs) -> ParallelEnv:
    """PettingZoo-style factory: ``parallel_env('simple_tag',
    max_cycles=25)``."""
    return ParallelEnv(scenario, **kwargs)
