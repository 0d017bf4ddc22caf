"""Named env registry (counterpart of ``mpe_tpu/registry.py``) — a
working replacement for the reference's gym registration (reference
multiagent/__init__.py:9-21 registers ``MultiagentSimple-v0`` /
``MultiagentSimpleSpeakerListener-v0`` pointing at a ``multiagent.envs``
module that does not exist; here the same ids construct envs, with the
registration's ``max_episode_steps=100`` applied as the env horizon).

    env = mpe_tpu_torch.registry.make("MultiagentSimpleSpeakerListener-v0")
    env = mpe_tpu_torch.registry.make("simple_tag-v0", seed=7, device="cpu")
"""

from __future__ import annotations

from mpe_tpu_torch import scenarios as _scenarios
from mpe_tpu_torch.envs.wrappers import MultiAgentEnv

_REGISTRY: dict[str, dict] = {}


def register(env_id: str, scenario: str, max_episode_steps: int | None = 100,
             **defaults) -> None:
    if env_id in _REGISTRY:
        raise ValueError(f"{env_id!r} already registered")
    _REGISTRY[env_id] = dict(scenario=scenario, max_steps=max_episode_steps, **defaults)


def make(env_id: str, **overrides) -> MultiAgentEnv:
    """The registered env; ``overrides`` (``seed``, ``device``, ...) go to
    ``MultiAgentEnv``."""
    if env_id not in _REGISTRY:
        raise KeyError(f"unknown env id {env_id!r}; registered: {sorted(_REGISTRY)}")
    cfg = dict(_REGISTRY[env_id])
    scenario = cfg.pop("scenario")
    cfg.update(overrides)
    return MultiAgentEnv(_scenarios.load(scenario), **cfg)


def ids() -> list[str]:
    return sorted(_REGISTRY)


# the reference's two ids (multiagent/__init__.py:9-21), now functional
register("MultiagentSimple-v0", "simple")
register("MultiagentSimpleSpeakerListener-v0", "simple_speaker_listener")
# one id per scenario
for _name in _scenarios.names():
    register(f"{_name}-v0", _name)
