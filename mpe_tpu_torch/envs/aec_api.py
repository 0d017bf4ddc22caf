"""PettingZoo-style AEC (Agent Environment Cycle) API adapter
(counterpart of ``mpe_tpu/envs/aec_api.py``).

The sequential counterpart of ``parallel_api``: agents act one at a time
through ``agent_iter()``/``last()``/``step(action)``, the interface most
PettingZoo tutorials use. Under MPE semantics all agents act
simultaneously — like PettingZoo's own MPE port, the adapter buffers each
agent's action and advances the underlying parallel environment once per
full cycle.

    env = aec_env("simple_spread", max_cycles=25)
    env.reset(seed=42)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for agent in env.agent_iter():
        obs, reward, termination, truncation, info = env.last()
        action = None if termination or truncation else \\
            env.action_space(agent).sample(gen)
        env.step(action)
"""

from __future__ import annotations

from typing import Any, Iterator

from mpe_tpu_torch.envs.parallel_api import ParallelEnv


class AECEnv:
    """Sequential agent-cycle wrapper over ``ParallelEnv``."""

    def __init__(self, scenario, **kwargs):
        self._par = ParallelEnv(scenario, **kwargs)
        self.possible_agents = self._par.possible_agents
        self.agents: list[str] = []
        self.agent_selection: str | None = None
        self._buffer: dict[str, Any] = {}
        self._obs: dict[str, Any] = {}
        self.rewards: dict[str, float] = {}
        self.terminations: dict[str, bool] = {}
        self.truncations: dict[str, bool] = {}
        self.infos: dict[str, dict] = {}

    # -- spaces ----------------------------------------------------------
    def action_space(self, agent: str):
        return self._par.action_space(agent)

    def observation_space(self, agent: str):
        return self._par.observation_space(agent)

    # -- episode ----------------------------------------------------------
    def reset(self, seed: int | None = None):
        self._obs, self.infos = self._par.reset(seed)
        self.agents = list(self.possible_agents)
        self.agent_selection = self.agents[0]
        self._buffer = {}
        self.rewards = {a: 0.0 for a in self.agents}
        self.terminations = {a: False for a in self.agents}
        self.truncations = {a: False for a in self.agents}

    def observe(self, agent: str):
        return self._obs[agent]

    def last(self):
        """(obs, reward, termination, truncation, info) for the agent
        whose turn it is."""
        a = self.agent_selection
        return (self._obs[a], self.rewards[a], self.terminations[a],
                self.truncations[a], self.infos.get(a, {}))

    def step(self, action):
        a = self.agent_selection
        if a is None:
            raise AssertionError("step() before reset()")
        if self.terminations[a] or self.truncations[a]:
            # PettingZoo convention: dead agents step None and are removed
            if action is not None:
                raise AssertionError(f"{a} is done; pass action=None")
            idx = self.agents.index(a)
            self.agents.remove(a)
            if not self.agents:
                self.agent_selection = None
                return
            if idx < len(self.agents):
                # continue the cycle with the agent that slid into the
                # removed slot (NOT agents[0] — restarting the cycle
                # would ask earlier agents to act twice)
                self.agent_selection = self.agents[idx]
                return
            # the removed agent held the last slot: the live agents have
            # all buffered this cycle, so advance the world
            self._advance()
            return
        self._buffer[a] = action
        idx = self.agents.index(a)
        if idx + 1 < len(self.agents):
            self.agent_selection = self.agents[idx + 1]
            return
        # full cycle buffered -> advance the world once
        self._advance()

    def _advance(self):
        (self._obs, self.rewards, self.terminations, self.truncations,
         self.infos) = self._par.step(self._buffer)
        self._buffer = {}
        self.agent_selection = self.agents[0] if self.agents else None

    def agent_iter(self, max_iter: int = 2 ** 31) -> Iterator[str]:
        n = 0
        while self.agents and n < max_iter:
            yield self.agent_selection
            n += 1

    def close(self):
        self._par.close()


def aec_env(scenario, **kwargs) -> AECEnv:
    """PettingZoo-style factory: ``aec_env('simple_tag', max_cycles=25)``."""
    return AECEnv(scenario, **kwargs)
