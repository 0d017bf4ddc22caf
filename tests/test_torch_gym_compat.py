"""The port's gymnasium shim (``mpe_tpu_torch/envs/gym_compat.py``)
against ``tests/test_gym_compat.py``'s contract for the JAX package's, on
the CPU: the ``gymnasium.Env`` round trip, ``register_gymnasium`` with the
time limit under the port's own prefix ``mpe_tpu_torch/``, the
MultiDiscrete conversion, and both packages' registrations side by side
in one process (each id makes its own package's env). Every env is made
with ``device="cpu"``.
"""

import numpy as np
import pytest
import torch
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

gymnasium = pytest.importorskip("gymnasium")

from mpe_tpu.envs import gym_compat as j_gym  # noqa: E402
from mpe_tpu.envs.wrappers import MultiAgentEnv as JMultiAgentEnv  # noqa: E402
from mpe_tpu_torch.envs.gym_compat import (GymnasiumMultiAgentEnv,  # noqa: E402
                                           register_gymnasium)
from mpe_tpu_torch.envs.wrappers import MultiAgentEnv  # noqa: E402


def test_env_api_roundtrip():
    env = GymnasiumMultiAgentEnv("simple_spread", device="cpu")
    assert isinstance(env, gymnasium.Env) and env.n_agents == 3
    obs_n, info = env.reset(seed=0)
    assert len(obs_n) == 3 and obs_n[0].shape == (18,)
    assert env.observation_space.contains(obs_n)
    act = tuple(np.eye(5, dtype=np.float32)[1] for _ in range(3))
    obs_n, rew_n, term, trunc, info = env.step(act)
    assert len(rew_n) == 3 and not term and not trunc
    assert rew_n[0] == rew_n[1] == rew_n[2]          # shared reward
    # determinism through the gymnasium seeding path
    env2 = GymnasiumMultiAgentEnv("simple_spread", device="cpu")
    env2.reset(seed=0)
    for a, b in zip(obs_n, env2.step(act)[0]):
        np.testing.assert_allclose(a, b, rtol=0, atol=0)
    frame = GymnasiumMultiAgentEnv("simple", render_mode="rgb_array", device="cpu").render()
    assert frame.shape == (700, 700, 3) and frame.dtype == np.uint8


def test_register_and_make_with_time_limit():
    ids = register_gymnasium()
    assert "mpe_tpu_torch/simple_tag-v0" in ids
    assert "mpe_tpu_torch/MultiagentSimple-v0" in ids     # legacy reference id
    assert len(ids) == 11 and all(i.startswith("mpe_tpu_torch/") for i in ids)
    env = gymnasium.make("mpe_tpu_torch/simple-v0", device="cpu")
    env.reset(seed=1)
    trunc, term, steps = False, False, 0
    while not trunc:
        *_, term, trunc, _ = env.step(env.action_space.sample())
        steps += 1
    assert trunc and not term and steps == 100         # horizon 100
    assert register_gymnasium() == ids                 # idempotent re-registration


def test_space_conversion_multidiscrete():
    register_gymnasium()
    env = gymnasium.make("mpe_tpu_torch/simple_reference-v0", device="cpu")
    sp = env.action_space.spaces[0]
    # both agents move AND speak -> reference MultiDiscrete [[0,4],[0,9]]
    assert isinstance(sp, gymnasium.spaces.MultiDiscrete)
    assert list(sp.nvec) == [5, 10]
    env.reset(seed=0)
    env.step(env.action_space.sample())                # native index samples convert
    # the same gymnasium spaces as the JAX package's shim
    j_env = j_gym.GymnasiumMultiAgentEnv("simple_reference")
    assert env.action_space == j_env.action_space
    assert env.observation_space == j_env.observation_space


def test_both_packages_register_side_by_side():
    port_ids, jax_ids = register_gymnasium(), j_gym.register_gymnasium()
    assert set(port_ids).isdisjoint(jax_ids)
    assert [i.removeprefix("mpe_tpu_torch/") for i in port_ids] == [
        i.removeprefix("mpe_tpu/") for i in jax_ids]
    port = gymnasium.make("mpe_tpu_torch/simple_spread-v0", device="cpu").unwrapped
    ref = gymnasium.make("mpe_tpu/simple_spread-v0").unwrapped
    assert isinstance(port, GymnasiumMultiAgentEnv) and isinstance(port._env, MultiAgentEnv)
    assert isinstance(ref, j_gym.GymnasiumMultiAgentEnv)
    assert isinstance(ref._env, JMultiAgentEnv)
    assert port._env.env.device == torch.device("cpu")
