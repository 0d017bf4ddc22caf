"""The port's scenarios other than simple_spread against the JAX package on
the CPU in float64 (atol 1e-12): the scenario callbacks, ``MpeEnv`` steps
with comm-width actions, ``build_rollout``, the kernel blocks of
``ops/kernel_scenarios.py`` and the pair physics of ``ops/mxu_physics.py``.

States are drawn by JAX and carried across with ``mpe_tpu_torch.convert``;
velocities, comm and actions are made with numpy. The two packages' random
streams differ, so auto-reset is checked by its semantics.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe_tpu import scenarios as j_scenarios
from mpe_tpu.envs.functional import MpeEnv as JMpeEnv
from mpe_tpu_torch import make_generator
from mpe_tpu_torch import scenarios as t_scenarios
from mpe_tpu_torch.convert import state_from_numpy, state_to_numpy
from mpe_tpu_torch.envs.functional import MpeEnv as TMpeEnv
from mpe_tpu_torch.parallel.mesh import build_rollout
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

j_kscn = importlib.import_module("mpe_tpu.ops.kernel_scenarios")
t_kscn = importlib.import_module("mpe_tpu_torch.ops.kernel_scenarios")

NAMES = ["simple", "simple_reference", "simple_speaker_listener", "simple_adversary",
         "simple_push", "simple_crypto", "simple_tag", "simple_world_comm"]
N = 16
ATOL = 1e-12
LEAVES = ("pos", "vel", "comm", "goal", "t")


def _close(t, j, msg=""):
    np.testing.assert_allclose(np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t) else t),
                               np.asarray(j), rtol=0, atol=ATOL, err_msg=msg)


def _jax_states(name, seed=0):
    """JAX-reset states with random velocities (movable agents only) and
    random utterances (non-silent agents only)."""
    env = JMpeEnv(j_scenarios.load(name), max_steps=100, auto_reset=True, dtype=jnp.float64)
    states, _ = jax.jit(jax.vmap(env.reset))(jax.random.split(jax.random.PRNGKey(seed), N))
    spec = env.spec
    rng = np.random.default_rng(seed)
    vel = rng.uniform(-1, 1, states.vel.shape) * spec.movable[:, None]
    comm = rng.uniform(size=states.comm.shape) * ~spec.silent[:, None]
    return env, states.replace(vel=jnp.asarray(vel), comm=jnp.asarray(comm))


def _goal_choices(name):
    """The number of values a goal index takes (0 without goals)."""
    return max(t_kscn.kernel_scenario(name).goal_choices, default=0)


def _to_port(states):
    return state_from_numpy(*(np.asarray(getattr(states, k)) for k in LEAVES), device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_scenario_callbacks_match_jax(name):
    _, states = _jax_states(name)
    j_scn, t_scn = j_scenarios.load(name), t_scenarios.load(name)
    t_state = _to_port(states)
    assert t_scn.obs_dims == j_scn.obs_dims and t_scn.per_agent_info == j_scn.per_agent_info
    assert len(set(np.asarray(states.goal).ravel().tolist())) == _goal_choices(name)
    _close(t_scn.reward(t_state), jax.jit(jax.vmap(j_scn.reward))(states), "reward")
    _close(t_scn.observation(t_state), jax.jit(jax.vmap(j_scn.observation))(states), "obs")
    _close(t_scn.entity_colors(t_state), jax.jit(jax.vmap(j_scn.entity_colors))(states), "colors")
    j_info = j_scn.benchmark_data(jax.tree.map(lambda x: x[0], states))
    t_info = t_scn.benchmark_data(t_state)
    assert (j_info is None) == (t_info is None)
    if j_info is not None:
        j_info = jax.jit(jax.vmap(j_scn.benchmark_data))(states)
        assert j_info.keys() == t_info.keys()
        for k in j_info:
            _close(t_info[k], j_info[k], k)


@functools.cache
def _jax_step(j_env):
    return jax.jit(jax.vmap(j_env.step))


def _step_both(name, j_env, j_states, t_env, t_states, acts, key_seed):
    keys = jax.random.split(jax.random.PRNGKey(key_seed), N)
    j_out = _jax_step(j_env)(j_states, jnp.asarray(acts), keys)
    t_out = t_env.step(t_states, torch.as_tensor(acts), make_generator(key_seed, "cpu"))
    return j_out, t_out


@pytest.mark.parametrize("name", NAMES)
def test_mpe_env_step_matches_jax_before_horizon(name):
    j_env, j_states = _jax_states(name, seed=1)
    t_env = TMpeEnv(t_scenarios.load(name), max_steps=100, auto_reset=True,
                    dtype=torch.float64, device="cpu")
    t_states = t_states0 = _to_port(j_states)
    rng = np.random.default_rng(0)
    for step in range(3):
        acts = rng.uniform(size=(N, t_env.n_agents, t_env.action_width))   # [move | comm]
        (j_states, j_obs, j_rew, j_done, j_info), (t_states, t_obs, t_rew, t_done, t_info) = \
            _step_both(name, j_env, j_states, t_env, t_states, acts, 10 + step)
        for leaf, t, j in zip(LEAVES, state_to_numpy(t_states),
                              (getattr(j_states, k) for k in LEAVES)):
            _close(t, j, f"step {step} {leaf}")
        _close(t_obs, j_obs, "obs")
        _close(t_rew, j_rew, "reward")
        assert np.array_equal(t_done.numpy(), np.asarray(j_done))
        assert j_info.keys() == t_info.keys()
        for k in j_info:
            _close(t_info[k], j_info[k], k)
    silent = torch.from_numpy(t_env.spec.silent.copy())
    fixed = ~torch.from_numpy(t_env.spec.movable.copy())                # landmarks, the speaker
    assert (t_states.comm[:, silent] == 0).all()
    assert torch.equal(t_states.pos[:, fixed], t_states0.pos[:, fixed])


@pytest.mark.parametrize("name", NAMES)
def test_mpe_env_auto_reset_at_horizon(name):
    j_env, j_states = _jax_states(name, seed=2)
    t_env = TMpeEnv(t_scenarios.load(name), max_steps=100, auto_reset=True,
                    dtype=torch.float64, device="cpu")
    half = N // 2
    j_states = j_states.replace(t=jnp.asarray(np.where(np.arange(N) < half, 99, 10), jnp.int32))
    acts = np.random.default_rng(1).uniform(size=(N, t_env.n_agents, t_env.action_width))
    (js, jo, jr, jd, _), (ts, to, tr, td, _) = _step_both(name, j_env, j_states, t_env,
                                                          _to_port(j_states), acts, 3)
    # reward and done are of the stepped state, before the reset
    _close(tr, jr, "reward")
    assert td[:half].all() and not td[half:].any()
    assert np.array_equal(td.numpy(), np.asarray(jd))
    # reset envs: fresh state with zero velocity and comm, obs of that state
    assert (ts.t[:half] == 0).all() and (ts.vel[:half] == 0).all() and (ts.comm[:half] == 0).all()
    assert (ts.pos[:half].abs() <= 1).all()
    assert ((ts.goal[:half] >= 0) & (ts.goal[:half] < _goal_choices(name))).all()
    _close(to[:half], t_env.scenario.observation(ts)[:half], "fresh obs")
    # the other envs stepped on, as in JAX
    for leaf in LEAVES:
        _close(getattr(ts, leaf)[half:], np.asarray(getattr(js, leaf))[half:], leaf)
    _close(to[half:], jo[half:], "obs")


@pytest.mark.parametrize("name", NAMES)
def test_build_rollout_layouts(name):
    env = TMpeEnv(t_scenarios.load(name), max_steps=4, auto_reset=True, device="cpu")
    n_envs, n_steps = 8, 6
    spec, ow = env.spec, max(env.scenario.obs_dims)
    s0, total = build_rollout(env, n_envs, n_steps)(make_generator(0, "cpu"))
    s1, traj = build_rollout(env, n_envs, n_steps, env_axis=-1,
                             return_trajectory=True)(make_generator(0, "cpu"))
    a, w = spec.n_agents, 5 + spec.dim_c
    assert env.action_width == w
    assert traj["obs"].shape == (n_steps, a, ow, n_envs)
    assert traj["actions"].shape == (n_steps, a, w, n_envs)
    assert traj["reward"].shape == traj["done"].shape == (n_steps, a, n_envs)
    assert s1.pos.shape == (spec.n_entities, 2, n_envs) and s1.goal.shape == (spec.n_goals, n_envs)
    # same generator seed, same draws: the layouts hold the same values
    for leaf in LEAVES:
        torch.testing.assert_close(getattr(s1, leaf), getattr(s0, leaf).movedim(0, -1))
    torch.testing.assert_close(traj["reward"].sum(), total)
    assert traj["done"][3].all() and not traj["done"][2].any()      # horizon 4
    if spec.collaborative:
        assert (traj["reward"] == traj["reward"][:, :1]).all()      # one shared reward


@pytest.mark.parametrize("name", NAMES)
def test_kernel_blocks_match_jax(name):
    """The env-minor ``reward_obs`` blocks on random states, goals and comm."""
    j_k, t_k = j_kscn.kernel_scenario(name), t_kscn.kernel_scenario(name)
    spec = t_k.spec
    assert (t_k.obs_w, t_k.reward_rows, t_k.goal_choices, t_k.uses_comm) == \
        (j_k.obs_w, j_k.reward_rows, tuple(j_k.goal_choices), j_k.uses_comm)
    rng = np.random.default_rng(4)
    e, a, n = spec.n_entities, spec.n_agents, 64
    pos = rng.uniform(-1, 1, (e, 2, n))
    vel = rng.uniform(-1, 1, (e, 2, n)) * spec.movable[:, None, None]
    comm = rng.uniform(size=(a, spec.dim_c, n)) if t_k.uses_comm else None
    goal = (np.stack([rng.integers(0, k, n) for k in t_k.goal_choices]).astype(np.int32)
            if t_k.goal_choices else None)

    def jx(x):
        return None if x is None else jnp.asarray(x)

    def tx(x):
        return None if x is None else torch.as_tensor(x)

    j_rew, j_obs = jax.jit(j_k.reward_obs)(jx(pos), jx(vel), jx(comm), jx(goal))
    t_rew, t_obs = t_k.reward_obs(tx(pos), tx(vel), tx(comm), tx(goal))
    _close(t_rew, j_rew, "reward")
    _close(t_obs, j_obs, "obs")
    move = rng.uniform(size=(a, 5, n))
    t_pos, t_vel = t_k.physics(tx(pos), tx(vel), tx(move))
    j_pos, j_vel = jax.jit(j_k.physics)(jx(pos), jx(vel), jx(move))
    _close(t_pos, j_pos, "physics pos")
    _close(t_vel, j_vel, "physics vel")
    assert (t_pos[a:] == tx(pos)[a:]).all()                             # landmarks stay


def _crowded_states(spec, n, rng):
    """pos, vel [E, 2, N] and move [A, 5, N] where the pair physics meets
    every case: lanes 0-63 have the agents and the obstacles within 0.05 of
    one point (deep overlaps), lanes 64-127 an exact overlap of agents 0 and
    1 (a zero force), lanes 128-191 speeds of 3.5 x max_speed (after damping
    above twice the limit, where ``factor - 1`` is not exact) and the rest
    random states with speeds up to 2 x max_speed."""
    e, a = spec.n_entities, spec.n_agents
    pos = rng.uniform(-1, 1, (e, 2, n))
    pos[:, :, :64] = rng.uniform(-0.5, 0.5, (1, 2, 64)) + rng.uniform(-0.05, 0.05, (e, 2, 64))
    pos[1, :, 64:128] = pos[0, :, 64:128]
    angle = rng.uniform(0, 2 * np.pi, (e, 1, n))
    speed = rng.uniform(0, 2, (e, 1, n))
    speed[:, :, 128:192] = 3.5
    ms = np.where(np.isfinite(spec.max_speed), spec.max_speed, 1.0)[:, None, None]
    vel = np.concatenate([np.cos(angle), np.sin(angle)], axis=1) * speed * ms
    vel *= spec.movable[:, None, None]
    return pos, vel, rng.uniform(size=(a, 5, n))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["simple_tag", "simple_world_comm"])
def test_mxu_physics_matches_jax(name, dtype):
    """The pair physics against the JAX block called on CPU arrays: float64
    within 1e-12, float32 within 4 ulps of 1 (the JAX block sums an entity's
    pair forces in a matmul, whose order XLA picks)."""
    from mpe_tpu.ops import mxu_physics as j_mxu
    from mpe_tpu_torch.ops import mxu_physics as t_mxu

    t_spec, j_spec = t_scenarios.load(name).spec, j_scenarios.load(name).spec
    assert t_mxu.collide_pairs(t_spec) == j_mxu.collide_pairs(j_spec)
    assert len(t_mxu.collide_pairs(t_spec)) == {"simple_tag": 14, "simple_world_comm": 21}[name]
    pos, vel, move = _crowded_states(t_spec, 256, np.random.default_rng(8))
    j_out = jax.jit(lambda *x: j_mxu.mxu_physics_block(j_spec, *x))(
        *(jnp.asarray(x, dtype) for x in (pos, vel, move)))
    t_out = t_mxu.mxu_physics_block(t_spec, *(torch.as_tensor(x).to(getattr(torch, dtype))
                                               for x in (pos, vel, move)))
    atol = ATOL if dtype == "float64" else 4 * np.finfo(np.float32).eps
    for label, t, j in zip(("pos", "vel"), t_out, j_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol, err_msg=label)
    a = t_spec.n_agents
    speed = t_out[1][:a].double().square().sum(1).sqrt()                 # [A, N]
    limit = torch.tensor(t_spec.max_speed[:a])[:, None]
    assert (speed <= limit * (1 + 1e-6)).all()
    # from above twice the limit most agents land on it (a contact can slow one)
    assert ((speed[:, 128:192] - limit).abs() < 1e-5).double().mean() > 0.9
    assert (t_out[0][a:] == torch.as_tensor(pos[a:]).to(t_out[0].dtype)).all()   # obstacles stay


def test_goal_helpers_match_jax():
    goal = np.random.default_rng(5).integers(0, 4, (1, 32)).astype(np.int32)
    rows = [np.full((2, 32), float(j)) for j in range(4)]
    colors = ((0.1, 0.2, 0.3), (0.4, 0.5, 0.6), (0.7, 0.8, 0.9), (1.0, 0.0, 0.5))
    tg = torch.as_tensor(goal)
    _close(t_kscn.select_by_goal(tg, [torch.as_tensor(r) for r in rows]),
           j_kscn.select_by_goal(jnp.asarray(goal), [jnp.asarray(r) for r in rows]))
    _close(t_kscn.color_rows_by_goal(tg, colors, 32, torch.float64),
           j_kscn.color_rows_by_goal(jnp.asarray(goal), colors, 32, jnp.float64))
    _close(t_kscn.onehot_rows(tg, 4, torch.float64),
           j_kscn.onehot_rows(jnp.asarray(goal), 4, jnp.float64))
    _close(t_kscn.const_rows(colors[2], 32, torch.float64),
           j_kscn.const_rows(colors[2], 32, jnp.float64))


def test_base_helpers_match_jax():
    from mpe_tpu.scenarios import _base as j_base
    from mpe_tpu_torch.scenarios import _base as t_base

    rng = np.random.default_rng(6)
    table = rng.uniform(size=(N, 3, 2))
    idx = rng.integers(0, 3, N).astype(np.int32)
    _close(t_base.take_row(torch.as_tensor(table), torch.as_tensor(idx)),
           jax.vmap(j_base.take_row)(jnp.asarray(table), jnp.asarray(idx)))
    rows = [rng.uniform(size=(N, 3)), rng.uniform(size=(N, 11))]
    _close(t_base.pad_stack([torch.as_tensor(r) for r in rows], 11),
           jax.vmap(lambda x, y: j_base.pad_stack([x, y], 11))(*map(jnp.asarray, rows)))
    _close(t_base.const(LANDMARK_TABLE, torch.zeros((), dtype=torch.float64)),
           j_base.const(LANDMARK_TABLE, jnp.float64))


LANDMARK_TABLE = [[0.75, 0.25, 0.25], [0.25, 0.75, 0.25], [0.25, 0.25, 0.75]]


def test_constant_tables_are_made_once_per_dtype_and_device():
    """The generic engine reads its constant tables in every step: each is
    made once and then shared, so no step copies from the host."""
    from mpe_tpu_torch._device import device_table
    from mpe_tpu_torch.scenarios import _base as t_base

    like32, like64 = torch.zeros(()), torch.zeros((), dtype=torch.float64)
    table = t_base.const(LANDMARK_TABLE, like32)
    assert t_base.const(np.asarray(LANDMARK_TABLE), like32) is table
    assert t_base.const(LANDMARK_TABLE, like64) is not table
    torch.testing.assert_close(table, torch.tensor(LANDMARK_TABLE), rtol=0, atol=0)
    spec = t_scenarios.load("simple_reference").spec
    idx = device_table(spec.others_idx, torch.int64, "cpu")
    assert device_table(spec.others_idx, torch.int64, torch.device("cpu")) is idx
    assert idx.tolist() == spec.others_idx.tolist()
