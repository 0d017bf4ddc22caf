"""The port's simple_spread scenario, MpeEnv, build_rollout and entry
against the JAX package, on the CPU in float64 (atol 1e-12).

States are drawn by JAX and carried across with ``mpe_tpu_torch.convert``;
actions are made with numpy. The two packages' random streams differ, so
auto-reset is checked by its semantics, not value for value.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe_tpu import scenarios as j_scenarios
from mpe_tpu.envs.functional import MpeEnv as JMpeEnv
from mpe_tpu_torch import entry, make_generator
from mpe_tpu_torch import scenarios as t_scenarios
from mpe_tpu_torch.convert import state_from_numpy, state_to_numpy
from mpe_tpu_torch.core.actions import ActionMode
from mpe_tpu_torch.envs.functional import MpeEnv as TMpeEnv
from mpe_tpu_torch.parallel.mesh import build_rollout

N = 16
ATOL = 1e-12


def _close(t, j, msg=""):
    np.testing.assert_allclose(np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t) else t),
                               np.asarray(j), rtol=0, atol=ATOL, err_msg=msg)


def _jax_states(seed=0, crowd=True):
    env = JMpeEnv(j_scenarios.load("simple_spread"), max_steps=100, auto_reset=True,
                  dtype=jnp.float64)
    states, _ = jax.vmap(env.reset)(jax.random.split(jax.random.PRNGKey(seed), N))
    if crowd:   # pull half the envs' agents together so collisions happen
        scale = jnp.where(jnp.arange(N) < N // 2, 0.1, 1.0)[:, None, None]
        states = states.replace(pos=states.pos * scale)
    return env, states


def _to_port(states):
    return state_from_numpy(*(np.asarray(x) for x in
                              (states.pos, states.vel, states.comm, states.goal, states.t)),
                            device="cpu")


def test_spread_reward_obs_info_match_jax():
    _, states = _jax_states()
    j_scn, t_scn = j_scenarios.load("simple_spread"), t_scenarios.load("simple_spread")
    t_state = _to_port(states)
    _close(t_scn.reward(t_state), jax.vmap(j_scn.reward)(states), "reward")
    _close(t_scn.observation(t_state), jax.vmap(j_scn.observation)(states), "obs")
    j_info = jax.vmap(j_scn.benchmark_data)(states)
    t_info = t_scn.benchmark_data(t_state)
    assert j_info.keys() == t_info.keys()
    for k in j_info:
        _close(t_info[k], j_info[k], k)
    # the self-collision quirk: every agent collides with itself
    assert (t_info["collisions"] >= 1).all()
    assert t_info["collisions"][: N // 2].max() > 1


def test_mpe_env_step_matches_vmapped_jax_before_horizon():
    j_env, j_states = _jax_states(seed=1)
    t_env = TMpeEnv(t_scenarios.load("simple_spread"), max_steps=100, auto_reset=True,
                    dtype=torch.float64, device="cpu")
    t_states = _to_port(j_states)
    gen = make_generator(0, "cpu")
    rng = np.random.default_rng(0)
    j_step = jax.vmap(j_env.step)
    for step in range(3):
        acts = rng.uniform(size=(N, 3, 7))
        keys = jax.random.split(jax.random.PRNGKey(10 + step), N)
        j_states, j_obs, j_rew, j_done, j_info = j_step(j_states, jnp.asarray(acts), keys)
        t_states, t_obs, t_rew, t_done, t_info = t_env.step(t_states, torch.as_tensor(acts), gen)
        for name, t, j in zip(("pos", "vel", "comm", "goal", "t"), state_to_numpy(t_states),
                              (j_states.pos, j_states.vel, j_states.comm, j_states.goal,
                               j_states.t)):
            _close(t, j, f"step {step} {name}")
        _close(t_obs, j_obs, "obs")
        _close(t_rew, j_rew, "reward")
        assert np.array_equal(t_done.numpy(), np.asarray(j_done))
        for k in j_info:
            _close(t_info[k], j_info[k], k)
    # collaborative: every agent gets the sum of the per-agent rewards
    assert (t_rew == t_rew[:, :1]).all()


def test_mpe_env_auto_reset_at_horizon():
    j_env, j_states = _jax_states(seed=2)
    t_env = TMpeEnv(t_scenarios.load("simple_spread"), max_steps=100, auto_reset=True,
                    dtype=torch.float64, device="cpu")
    t0 = np.where(np.arange(N) < N // 2, 99, 10).astype(np.int32)   # half reach the horizon
    j_states = j_states.replace(t=jnp.asarray(t0))
    acts = np.random.default_rng(1).uniform(size=(N, 3, 7))
    keys = jax.random.split(jax.random.PRNGKey(3), N)
    js, jo, jr, jd, _ = jax.vmap(j_env.step)(j_states, jnp.asarray(acts), keys)
    ts, to, tr, td, _ = t_env.step(_to_port(j_states), torch.as_tensor(acts),
                                   make_generator(5, "cpu"))
    half = N // 2
    # reward and done are of the stepped state, before the reset
    _close(tr, jr, "reward")
    assert td[:half].all() and not td[half:].any()
    assert np.array_equal(td.numpy(), np.asarray(jd))
    # reset envs: fresh state, obs of that fresh state
    assert (ts.t[:half] == 0).all() and (ts.vel[:half] == 0).all()
    assert (ts.pos[:half].abs() <= 1).all()
    _close(to[:half], t_env.scenario.observation(ts)[:half], "fresh obs")
    # the other envs stepped on, as in JAX
    _close(ts.pos[half:], js.pos[half:], "pos")
    _close(ts.t[half:], js.t[half:], "t")
    _close(to[half:], jo[half:], "obs")


@pytest.mark.parametrize("mode", list(ActionMode))
def test_build_rollout_layouts_and_trajectory(mode):
    env = TMpeEnv(t_scenarios.load("simple_spread"), action_mode=mode, max_steps=4,
                  auto_reset=True, device="cpu")
    n_envs, n_steps = 8, 6
    s0, total = build_rollout(env, n_envs, n_steps)(make_generator(0, "cpu"))
    s1, traj = build_rollout(env, n_envs, n_steps, env_axis=-1,
                             return_trajectory=True)(make_generator(0, "cpu"))
    w = env.action_width
    assert traj["obs"].shape == (n_steps, 3, 18, n_envs)
    assert traj["actions"].shape == (n_steps, 3, w, n_envs)
    assert traj["reward"].shape == traj["done"].shape == (n_steps, 3, n_envs)
    assert s1.pos.shape == (6, 2, n_envs) and s1.t.shape == (n_envs,)
    # same generator seed, same draws: the layouts hold the same values
    torch.testing.assert_close(s1.pos, s0.pos.movedim(0, -1))
    torch.testing.assert_close(traj["reward"].sum(), total)
    assert traj["done"][3].all() and not traj["done"][2].any()      # horizon 4


def test_entry_forward_cpu():
    forward, (states, actions, gen) = entry(device="cpu")
    states, obs, rew, done = forward(states, actions, gen)
    assert obs.shape == (64, 3, 18) and rew.shape == (64, 3) and done.shape == (64, 3)
    assert (states.t == 1).all() and torch.isfinite(obs).all()


def test_convert_round_trip_env_minor():
    env = JMpeEnv(j_scenarios.load("simple_spread"), dtype=jnp.float64)
    states, _ = jax.vmap(env.reset, out_axes=-1)(jax.random.split(jax.random.PRNGKey(4), N))
    leaves = tuple(np.asarray(x) for x in
                   (states.pos, states.vel, states.comm, states.goal, states.t))
    t_state = state_from_numpy(*leaves, env_axis=-1, device="cpu")
    assert t_state.pos.shape == (N, 6, 2) and t_state.t.shape == (N,)
    for a, b in zip(state_to_numpy(t_state, env_axis=-1), leaves):
        np.testing.assert_array_equal(a, b)


def test_scenario_registry():
    names = ["simple", "simple_reference", "simple_speaker_listener", "simple_spread"]
    assert t_scenarios.names() == names
    assert t_scenarios.load("simple_spread.py").spec.name == "simple_spread"
    with pytest.raises(KeyError, match="available: " + re.escape(str(names))):
        t_scenarios.load("simple_tag")


def test_bound_penalty_matches_jax():
    from mpe_tpu.scenarios import _base as j_base
    from mpe_tpu_torch.scenarios import _base as t_base

    x = np.linspace(0.0, 1.6, 161)
    _close(t_base.bound_penalty(torch.as_tensor(x)), j_base.bound_penalty(jnp.asarray(x)))
