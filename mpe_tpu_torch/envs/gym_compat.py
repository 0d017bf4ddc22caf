"""Optional gymnasium interop (counterpart of ``mpe_tpu/envs/gym_compat.py``;
import-guarded: gymnasium is NOT a dependency).

The reference ``MultiAgentEnv`` subclasses ``gym.Env``
(reference multiagent/environment.py:9) and registers two env ids
(multiagent/__init__.py:9-21, both broken upstream: they point at a
module that does not exist). The port is gym-free (``envs/spaces.py``);
this shim gives code that wants the modern gym API a ``gymnasium.Env``
adapter over the stateful wrapper, and ``register_gymnasium()`` makes
every scenario available through ``gymnasium.make``.

gymnasium's 5-tuple step contract vs the reference's 4-tuple: the
reference has no termination at all (environment.py:132-135), so
``terminated`` is the env's own done flags (all False without a
``done_callback``) and ``truncated`` reflects the ``max_episode_steps``
horizon, handled by gymnasium's TimeLimit wrapper at registration —
matching the reference's (broken) ``max_episode_steps=100``
registrations.

    import gymnasium, mpe_tpu_torch.envs.gym_compat as gc
    gc.register_gymnasium()
    env = gymnasium.make("mpe_tpu_torch/simple_spread-v0")  # device="cpu" to pick the CPU
    obs_n, info = env.reset(seed=0)
    obs_n, rew_n, term, trunc, info = env.step(env.action_space.sample())

The one deliberate difference from the JAX package: ids are registered
under the prefix ``"mpe_tpu_torch/"``, not ``"mpe_tpu/"``. Both packages
may register in one process, and ``register_gymnasium`` keeps an id that
is already registered, so a shared prefix would hand one package's env to
the other's caller.
"""

from __future__ import annotations

import numpy as np

try:
    import gymnasium
    from gymnasium import spaces as gspaces
except ImportError:  # pragma: no cover - exercised on gym-free installs
    gymnasium = None


def _to_gymnasium_space(s):
    """mpe_tpu_torch.envs.spaces -> gymnasium.spaces (the reference's
    vendored MultiDiscrete [(lo, hi)] ranges become nvec = hi - lo + 1)."""
    from mpe_tpu_torch.envs import spaces

    if isinstance(s, spaces.Discrete):
        return gspaces.Discrete(s.n)
    if isinstance(s, spaces.MultiDiscrete):
        return gspaces.MultiDiscrete(np.asarray(s.sizes, np.int64))
    if isinstance(s, spaces.Box):
        return gspaces.Box(np.full(s.shape, s.low, np.float32),
                           np.full(s.shape, s.high, np.float32), dtype=np.float32)
    if isinstance(s, spaces.Tuple):
        return gspaces.Tuple([_to_gymnasium_space(x) for x in s.spaces])
    raise TypeError(f"unsupported space {s!r}")


class GymnasiumMultiAgentEnv(*((gymnasium.Env,) if gymnasium else (object,))):
    """gymnasium.Env over the reference-style ``MultiAgentEnv`` wrapper:
    per-agent spaces exposed as ``Tuple`` spaces, actions/observations
    as per-agent tuples (the reference's list-of-agents convention).
    ``make_kwargs`` go to ``make_env`` (``device``, ``seed``, ...)."""

    metadata = {"render_modes": ["human", "rgb_array"]}

    def __init__(self, scenario: str, benchmark: bool = False,
                 render_mode: str | None = None, **make_kwargs):
        assert gymnasium is not None, (
            "gymnasium is not installed; pip install gymnasium to use "
            "mpe_tpu_torch.envs.gym_compat")
        from mpe_tpu_torch.factory import make_env

        self._env = make_env(scenario, benchmark=benchmark, **make_kwargs)
        self.render_mode = render_mode
        self.action_space = gspaces.Tuple(
            [_to_gymnasium_space(s) for s in self._env.action_space])
        self.observation_space = gspaces.Tuple(
            [_to_gymnasium_space(s) for s in self._env.observation_space])

    @property
    def n_agents(self) -> int:
        return self._env.n

    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)
        if seed is not None:
            self._env.seed(seed)
        obs_n = self._env.reset()
        return tuple(np.asarray(o) for o in obs_n), {}

    def _convert_action(self, i, act):
        """gymnasium-native samples -> the reference's action format:
        Discrete scalars become one-hots, MultiDiscrete index vectors
        become concatenated one-hot segments, Tuple(Box) samples are
        concatenated; already-reference-format vectors pass through."""
        from mpe_tpu_torch._device import to_host
        from mpe_tpu_torch.envs import spaces

        s = self._env.action_space[i]
        if isinstance(act, tuple):
            return np.concatenate([to_host(x).ravel() for x in act])
        act = to_host(act)
        if isinstance(s, spaces.Discrete) and act.ndim == 0:
            return np.eye(s.n, dtype=np.float32)[int(act)]
        if (isinstance(s, spaces.MultiDiscrete)
                and act.ndim == 1 and len(act) == len(s.low)
                and np.issubdtype(act.dtype, np.integer)):
            # gymnasium-native MultiDiscrete samples are 0-based per
            # segment (0..hi-lo), regardless of the reference-style
            # low offset — index the one-hot directly
            return np.concatenate([np.eye(w, dtype=np.float32)[int(v)]
                                   for v, w in zip(act, s.sizes)])
        return act

    def step(self, action_n):
        action_n = [self._convert_action(i, a) for i, a in enumerate(action_n)]
        obs_n, rew_n, done_n, info_n = self._env.step(list(action_n))
        terminated = bool(np.all(done_n))   # reference: always False
        return (tuple(np.asarray(o) for o in obs_n),
                tuple(float(r) for r in rew_n), terminated, False,
                {"per_agent": info_n})

    def render(self):
        if self.render_mode == "rgb_array":
            return self._env.render("rgb_array")[0]
        return self._env.render("human")

    def close(self):
        self._env.close()


def register_gymnasium(prefix: str = "mpe_tpu_torch/",
                       max_episode_steps: int = 100) -> list[str]:
    """Register every scenario (plus the reference's two legacy ids)
    with gymnasium; returns the registered id list. Horizon default
    matches the reference's registrations (multiagent/__init__.py:14).

    Registered with ``disable_env_checker=True``: gymnasium's passive
    checker expects a scalar reward, but this is a MULTI-agent env —
    ``step`` deliberately returns the reference's per-agent reward
    tuple (environment.py:80-104), which the single-agent checker
    would warn about on every ``make``."""
    assert gymnasium is not None, "gymnasium is not installed"
    from mpe_tpu_torch import scenarios

    ids = []
    legacy = {"MultiagentSimple-v0": "simple",
              "MultiagentSimpleSpeakerListener-v0": "simple_speaker_listener"}
    for env_id, scenario in ([(f"{n}-v0", n) for n in scenarios.names()]
                             + list(legacy.items())):
        full = f"{prefix}{env_id}"
        if full in gymnasium.registry:
            ids.append(full)
            continue
        gymnasium.register(
            id=full,
            entry_point="mpe_tpu_torch.envs.gym_compat:GymnasiumMultiAgentEnv",
            max_episode_steps=max_episode_steps,
            disable_env_checker=True,   # per-agent reward tuple (see doc)
            kwargs={"scenario": scenario})
        ids.append(full)
    return ids
