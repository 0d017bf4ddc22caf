"""The port's env API (spaces, ``MpeEnv``'s space descriptors,
``pack_actions``, ``MultiAgentEnv``, ``VecMultiAgentEnv``, ``make_env``,
the registry and the PettingZoo adapters) against the JAX package, on the
CPU in float64.

Spaces, agent names and registry ids are held equal exactly, packed
actions bit for bit, and every value a step returns at atol 1e-12: JAX's
``.state`` is carried into the port (``convert.state_from_numpy``; the
port's stateful wrapper steps a batch of one env) and both step with the
same reference-format actions, made with numpy. The two packages' random
streams differ, so resets and samples are checked by their semantics.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe_tpu import make_env as j_make_env
from mpe_tpu import registry as j_registry
from mpe_tpu import scenarios as j_scenarios
from mpe_tpu.core.actions import ActionMode as JMode
from mpe_tpu.envs import aec_api as j_aec
from mpe_tpu.envs import parallel_api as j_par
from mpe_tpu.envs.functional import MpeEnv as JMpeEnv
from mpe_tpu.envs.wrappers import MultiAgentEnv as JMultiAgentEnv
from mpe_tpu.envs.wrappers import pack_actions as j_pack_actions
from mpe_tpu_torch import make_env, registry
from mpe_tpu_torch import scenarios as t_scenarios
from mpe_tpu_torch.convert import state_from_numpy, state_to_numpy
from mpe_tpu_torch.core.actions import ActionMode
from mpe_tpu_torch.envs import (MpeEnv, MultiAgentEnv, VecMultiAgentEnv, aec_api, pack_actions,
                                parallel_api, spaces)
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

NAMES = ["simple", "simple_adversary", "simple_crypto", "simple_push", "simple_reference",
         "simple_speaker_listener", "simple_spread", "simple_tag", "simple_world_comm"]
MODES = ["discrete", "continuous", "discrete_index"]
ATOL = 1e-12


def _space_tree(s):
    """A space (either package's) as nested plain values, field by field."""
    if isinstance(s, tuple):
        return tuple(_space_tree(x) for x in s)
    if dataclasses.is_dataclass(s):
        return (type(s).__name__, repr(s),
                tuple((f.name, _space_tree(getattr(s, f.name))) for f in dataclasses.fields(s)))
    return s


def _carry(j_state):
    """A JAX single-env WorldState -> the port's batch of one env."""
    return state_from_numpy(*(np.asarray(x)[None] for x in (
        j_state.pos, j_state.vel, j_state.comm, j_state.goal, j_state.t)), device="cpu")


def _reference_actions(spec, mode: str, rng, n_agents=None):
    """Reference-format per-agent actions: only the segments each agent's
    space has (ints for discrete_index)."""
    out = []
    for i in range(spec.n_agents if n_agents is None else n_agents):
        if mode == "discrete_index":
            act = ([int(rng.integers(5))] if spec.movable[i] else []) + (
                [] if spec.silent[i] else [int(rng.integers(spec.dim_c))])
            out.append(np.asarray(act))
            continue
        move_w = 2 * spec.dim_p + 1 if mode == "discrete" else spec.dim_p
        width = (move_w if spec.movable[i] else 0) + (0 if spec.silent[i] else spec.dim_c)
        out.append(rng.uniform(-1, 1, width))
    return out


def _assert_close(t, j, msg=""):
    np.testing.assert_allclose(np.asarray(t, np.float64), np.asarray(j, np.float64), rtol=0,
                               atol=ATOL, err_msg=msg)


def _assert_info_equal(t_info, j_info):
    assert len(t_info) == len(j_info)
    for t_agent, j_agent in zip(t_info, j_info):
        assert t_agent.keys() == j_agent.keys()
        for k in j_agent:
            assert np.shape(t_agent[k]) == np.shape(j_agent[k]), k
            _assert_close(t_agent[k], j_agent[k], k)


# ---- spaces ------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_space_descriptors_equal_jax(name, mode):
    j_env = JMpeEnv(j_scenarios.load(name), action_mode=JMode(mode))
    t_env = MpeEnv(t_scenarios.load(name), action_mode=ActionMode(mode), device="cpu")
    assert _space_tree(tuple(t_env.action_spaces())) == _space_tree(tuple(j_env.action_spaces()))
    assert (_space_tree(tuple(t_env.observation_spaces()))
            == _space_tree(tuple(j_env.observation_spaces())))


def test_spaces_sample_and_contains():
    gen = torch.Generator().manual_seed(0)
    d = spaces.Discrete(5)
    s = d.sample(gen)
    assert s.dtype == torch.int32 and s.shape == () and s.device == gen.device
    assert d.contains(s) and not d.contains(7) and d.contains(np.int64(4))

    b = spaces.Box(-1.0, 1.0, (3,))
    x = b.sample(gen)
    assert x.dtype == torch.float32 and x.shape == (3,)
    assert b.contains(x) and b.contains(x.numpy()) and not b.contains(np.full(3, 2.0))
    assert not b.contains(np.zeros(4))

    md = spaces.MultiDiscrete.of([(0, 4), (0, 9)])
    draws = torch.stack([md.sample(gen) for _ in range(200)])
    assert draws.dtype == torch.int32 and draws.shape == (200, 2)
    assert md.contains(draws[0]) and not md.contains(np.array([5, 0]))
    assert draws[:, 0].max() == 4 and draws[:, 1].max() == 9 and draws.min() == 0
    assert md.sizes == (5, 10) and md.num_discrete_space == 2
    assert repr(md) == "MultiDiscrete2"

    t = spaces.Tuple((d, b))
    sv = t.sample(gen)
    assert isinstance(sv, tuple) and t.contains(sv)
    assert not t.contains((7, x))

    # a sample is drawn from the generator alone: the same seed, the same values
    again = spaces.Box(-1.0, 1.0, (3,)).sample(torch.Generator().manual_seed(0))
    first = spaces.Box(-1.0, 1.0, (3,)).sample(torch.Generator().manual_seed(0))
    assert torch.equal(again, first)


# ---- pack_actions ------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["simple_reference", "simple_speaker_listener",
                                  "simple_crypto", "simple_world_comm"])
def test_pack_actions_equal_jax(name, mode):
    j_env = JMpeEnv(j_scenarios.load(name), action_mode=JMode(mode), dtype=jnp.float64)
    t_env = MpeEnv(t_scenarios.load(name), action_mode=ActionMode(mode), dtype=torch.float64,
                   device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(3):
        acts = _reference_actions(t_env.spec, mode, rng)
        got, want = pack_actions(t_env, acts), np.asarray(j_pack_actions(j_env, acts))
        assert got.dtype == (torch.int32 if mode == "discrete_index" else torch.float64)
        np.testing.assert_array_equal(got.numpy(), want)
        # tensors are taken as the reference's arrays are
        np.testing.assert_array_equal(
            pack_actions(t_env, [torch.as_tensor(a) for a in acts]).numpy(), want)


def test_pack_actions_length_checks_raise_as_jax():
    j_env = JMpeEnv(j_scenarios.load("simple_spread"))
    t_env = MpeEnv(t_scenarios.load("simple_spread"), device="cpu")
    for acts, msg in (([np.zeros(5)] * 2, "expected 3 actions, got 2"),
                      ([np.zeros(4)] + [np.zeros(5)] * 2,
                       "agent 0: action length 4 != expected 5")):
        with pytest.raises(AssertionError, match=msg):
            j_pack_actions(j_env, acts)
        with pytest.raises(AssertionError, match=msg):
            pack_actions(t_env, acts)


# ---- MultiAgentEnv -----------------------------------------------------------

STEP_CASES = [("simple_spread", "discrete"), ("simple_crypto", "discrete"),
              ("simple_speaker_listener", "discrete"), ("simple_adversary", "discrete"),
              ("simple_world_comm", "discrete"), ("simple_reference", "continuous"),
              ("simple_tag", "continuous"), ("simple", "discrete_index"),
              ("simple_reference", "discrete_index")]


@pytest.mark.parametrize("name,mode", STEP_CASES)
def test_multi_agent_env_step_matches_jax(name, mode):
    j_env = j_make_env(name, benchmark=True, seed=1, action_mode=JMode(mode),
                       dtype=jnp.float64)
    t_env = make_env(name, benchmark=True, seed=1, action_mode=ActionMode(mode),
                     dtype=torch.float64, device="cpu")
    assert t_env.n == j_env.n and t_env.discrete_action_input == j_env.discrete_action_input
    assert _space_tree(tuple(t_env.action_space)) == _space_tree(tuple(j_env.action_space))
    j_env.reset()
    obs_n = t_env.reset()
    assert [o.shape for o in obs_n] == [(d,) for d in t_env.scenario.obs_dims]
    assert t_env.state.pos.shape[0] == 1 and t_env.time == 0
    t_env.state = _carry(j_env.state)
    rng = np.random.default_rng(7)
    for step in range(3):
        acts = _reference_actions(t_env.world_spec, mode, rng)
        j_obs, j_rew, j_done, j_info = j_env.step(acts)
        t_obs, t_rew, t_done, t_info = t_env.step(acts)
        assert len(t_obs) == len(j_obs)
        for i, (a, b) in enumerate(zip(t_obs, j_obs)):
            assert a.shape == b.shape
            _assert_close(a, b, f"step {step} obs {i}")
        assert all(type(r) is float for r in t_rew) and all(type(d) is bool for d in t_done)
        _assert_close(t_rew, j_rew, f"step {step} reward")
        assert t_done == j_done
        assert t_info.keys() == j_info.keys() == {"n"}
        _assert_info_equal(t_info["n"], j_info["n"])
    assert t_env.time == j_env.time == 3
    for leaf, want in zip(state_to_numpy(t_env.state), (j_env.state.pos, j_env.state.vel,
                                                        j_env.state.comm, j_env.state.goal,
                                                        j_env.state.t)):
        _assert_close(leaf[0], want)


def test_crypto_comm_is_split_on_the_agent_axis():
    """simple_crypto's ``comm`` info leaf is [B, A, C]: the agent axis
    follows the env axis, so each agent gets its own utterance row."""
    env = make_env("simple_crypto", benchmark=True, seed=0, device="cpu")
    env.reset()
    _, _, _, info = env.step(_reference_actions(env.world_spec, "discrete",
                                                np.random.default_rng(0)))
    comm = env.state.comm[0].numpy()
    for i in range(env.n):
        np.testing.assert_array_equal(info["n"][i]["comm"], comm[i])


def test_make_env_step_contract_and_wrapper_surface():
    env = make_env("simple_spread", seed=3, device="cpu")
    obs_n = env.reset()
    assert len(obs_n) == env.n == 3 and all(o.shape == (18,) for o in obs_n)
    obs_n, rew_n, done_n, info_n = env.step([np.eye(5)[1] for _ in range(3)])
    assert len(rew_n) == len(done_n) == len(info_n["n"]) == 3
    assert rew_n[0] == rew_n[1] == rew_n[2] and not any(done_n)
    assert info_n["n"] == [{}, {}, {}]            # benchmark off: no info
    frames = env.render("rgb_array")
    assert len(frames) == 1 and frames[0].shape == (700, 700, 3) and frames[0].dtype == np.uint8
    env.close()
    # step() before reset() initializes; seed() then reset() is deterministic
    fresh = make_env("simple", seed=5, device="cpu")
    fresh.step([np.zeros(5)])
    assert fresh.time == 1
    fresh.seed(11)
    a = fresh.reset()
    fresh.seed(11)
    np.testing.assert_array_equal(fresh.reset()[0], a[0])
    # an MpeEnv is taken as it is
    inner = MpeEnv(t_scenarios.load("simple"), dtype=torch.float64, device="cpu")
    assert MultiAgentEnv(inner).env is inner


def test_info_attribution_is_declared_not_heuristic():
    """A GLOBAL leaf whose agent-sized axis happens to equal n_agents
    reaches every agent whole; declared leaves split to one per agent."""
    base_cls = type(t_scenarios.load("simple_spread"))

    class SpreadWithGlobalLeaf(base_cls):
        def benchmark_data(self, state):
            info = super().benchmark_data(state)
            info["landmark_x"] = state.pos[..., self.spec.n_agents:, 0]     # [B, 3]
            return info

    env = MultiAgentEnv(SpreadWithGlobalLeaf(), benchmark=True, seed=0, device="cpu")
    env.reset()
    _, _, _, info_n = env.step([np.zeros(5)] * 3)
    for i in range(3):
        assert np.shape(info_n["n"][i]["rew"]) == ()
        assert np.shape(info_n["n"][i]["collisions"]) == ()
        assert info_n["n"][i]["landmark_x"].shape == (3,)
        np.testing.assert_array_equal(info_n["n"][i]["landmark_x"], info_n["n"][0]["landmark_x"])


# ---- VecMultiAgentEnv, horizon and auto-reset --------------------------------

def test_vec_env_lockstep_matches_single_env():
    env = MpeEnv(t_scenarios.load("simple_spread"), dtype=torch.float64, device="cpu")
    vec = VecMultiAgentEnv(env, n_envs=4, seed=9)
    assert vec.n == 12 and len(vec.action_space) == 3
    obs = vec.reset()
    assert obs.shape == (4, 3, 18)
    states0 = vec.states
    acts = np.random.default_rng(1).uniform(size=(4, 3, 7))
    obs_b, rew_b, done_b, _ = vec.step(acts)
    # env 2 against a single-env step of the port and of JAX from its state
    s2 = states0.map(lambda x: x[2:3])
    _, obs_s, rew_s, done_s, _ = env.step(s2, torch.as_tensor(acts[2:3]))
    torch.testing.assert_close(obs_b[2:3], obs_s, rtol=0, atol=ATOL)
    torch.testing.assert_close(rew_b[2:3], rew_s, rtol=0, atol=ATOL)
    assert torch.equal(done_b[2:3], done_s)
    j_env = JMpeEnv(j_scenarios.load("simple_spread"), dtype=jnp.float64)
    pos, vel, comm, goal, t = (x[2] for x in state_to_numpy(states0))
    j_state = j_scenarios.load("simple_spread").reset(jax.random.PRNGKey(0), jnp.float64)
    j_state = j_state.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                              comm=jnp.asarray(comm), goal=jnp.asarray(goal), t=jnp.asarray(t))
    _, j_obs, j_rew, j_done, _ = j_env.step(j_state, jnp.asarray(acts[2]))
    _assert_close(obs_b[2].numpy(), j_obs)
    _assert_close(rew_b[2].numpy(), j_rew)
    np.testing.assert_array_equal(done_b[2].numpy(), np.asarray(j_done))


def test_horizon_and_autoreset():
    env = MpeEnv(t_scenarios.load("simple"), max_steps=5, auto_reset=True, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, _ = env.reset(1, gen)
    act = torch.zeros((1, 1, 5))
    for i in range(4):
        state, _, _, done, _ = env.step(state, act, gen)
        assert not bool(done[0, 0]) and int(state.t[0]) == i + 1
    state, _, _, done, _ = env.step(state, act, gen)
    assert bool(done[0, 0])               # horizon reached
    assert int(state.t[0]) == 0           # auto-reset back to a fresh state
    assert float(state.vel.abs().sum()) == 0.0


def test_never_done_without_horizon():
    env = MpeEnv(t_scenarios.load("simple"), device="cpu")
    state, _ = env.reset(1, torch.Generator().manual_seed(0))
    for _ in range(3):
        state, _, _, done, _ = env.step(state, torch.zeros((1, 1, 5)))
        assert not bool(done.any())


# ---- registry ----------------------------------------------------------------

def test_registry_ids_equal_jax_and_horizon():
    assert registry.ids() == j_registry.ids()
    for env_id in registry.ids():
        env = registry.make(env_id, seed=2, device="cpu")
        assert env.env.max_steps == 100
        env.reset()
        env.step(_reference_actions(env.world_spec, "discrete", np.random.default_rng(0)))
    env = registry.make("MultiagentSimpleSpeakerListener-v0", device="cpu")
    env.reset()
    for t in range(1, 101):
        _, _, done_n, _ = env.step(_reference_actions(env.world_spec, "discrete",
                                                      np.random.default_rng(t)))
        assert all(done_n) == (t == 100)
    with pytest.raises(KeyError, match="unknown env id"):
        registry.make("nope-v0", device="cpu")
    with pytest.raises(ValueError, match="already registered"):
        registry.register("simple-v0", "simple")


# ---- PettingZoo adapters -----------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_possible_agents_equal_jax(name):
    t_env = parallel_api.parallel_env(name, device="cpu")
    j_env = j_par.parallel_env(name)
    assert t_env.possible_agents == j_env.possible_agents
    for a in t_env.possible_agents:
        assert _space_tree(t_env.action_space(a)) == _space_tree(j_env.action_space(a))


@pytest.mark.parametrize("name,mode", [("simple_spread", "discrete"),
                                       ("simple_reference", "discrete"),
                                       ("simple_reference", "continuous"),
                                       ("simple_tag", "continuous")])
def test_to_reference_format_equal_jax(name, mode):
    t_env = parallel_api.ParallelEnv(name, action_mode=ActionMode(mode), device="cpu")
    j_env = j_par.ParallelEnv(name, action_mode=JMode(mode))
    rng = np.random.default_rng(4)
    gen = torch.Generator().manual_seed(4)
    for agent in t_env.possible_agents:
        space = t_env.action_space(agent)
        sample = space.sample(gen)
        if isinstance(space, spaces.Discrete):
            inputs = [int(sample), np.eye(space.n)[int(sample)]]
        elif isinstance(space, spaces.MultiDiscrete):
            inputs = [sample.numpy(), np.concatenate([np.eye(w)[int(v)] for v, w in
                                                      zip(sample.numpy(), space.sizes)])]
        elif isinstance(space, spaces.Tuple):
            inputs = [tuple(x.numpy() for x in sample)]
        else:
            inputs = [rng.uniform(space.low, space.high, space.shape)]
        for x in inputs:
            want = j_env._to_reference_format(agent, x)
            np.testing.assert_array_equal(t_env._to_reference_format(agent, x), want)
            as_tensor = (tuple(map(torch.as_tensor, x)) if isinstance(x, tuple)
                         else torch.as_tensor(x))
            np.testing.assert_array_equal(t_env._to_reference_format(agent, as_tensor), want)
            np.testing.assert_array_equal(t_env._zero_action(agent), j_env._zero_action(agent))


def _float64_parallel(t_par, j_par_env, name, **kw):
    """Swap both adapters' stateful envs for float64 ones."""
    t_par._env = MultiAgentEnv(t_scenarios.load(name), dtype=torch.float64, device="cpu", **kw)
    j_par_env._env = JMultiAgentEnv(j_scenarios.load(name), dtype=jnp.float64, **kw)


def _native_action(space, rng):
    """A PettingZoo-native action: an int, an int per sub-space, or an array."""
    if isinstance(space, spaces.Discrete):
        return int(rng.integers(space.n))
    if isinstance(space, spaces.MultiDiscrete):
        return np.array([rng.integers(w) for w in space.sizes])
    return rng.uniform(0, 1, space.shape)


def test_parallel_episode_matches_jax():
    t_env = parallel_api.parallel_env("simple_tag", max_cycles=4, benchmark=True, device="cpu")
    j_env = j_par.parallel_env("simple_tag", max_cycles=4, benchmark=True)
    _float64_parallel(t_env, j_env, "simple_tag", benchmark=True)
    j_env.reset(seed=3)
    t_obs, t_infos = t_env.reset(seed=3)
    assert t_obs.keys() == t_infos.keys() == set(t_env.possible_agents)
    t_env._env.state = _carry(j_env._env.state)
    rng = np.random.default_rng(5)
    steps = 0
    while t_env.agents:
        assert t_env.agents == j_env.agents
        acts = {a: _native_action(t_env.action_space(a), rng) for a in t_env.agents}
        got, want = t_env.step(acts), j_env.step(acts)
        steps += 1
        for label, t_d, j_d in zip(("obs", "rew", "term", "trunc"), got[:4], want[:4]):
            assert t_d.keys() == j_d.keys(), label
            for a in j_d:
                if label in ("term", "trunc"):
                    assert t_d[a] is j_d[a]
                else:
                    _assert_close(t_d[a], j_d[a], f"{label} {a}")
        _assert_info_equal([got[4][a] for a in sorted(got[4])],
                           [want[4][a] for a in sorted(want[4])])
    assert steps == 4 and j_env.agents == []
    assert all(got[3].values()) and not any(got[2].values())


def test_aec_episode_matches_jax():
    t_env = aec_api.aec_env("simple_world_comm", max_cycles=3, device="cpu")
    j_env = j_aec.aec_env("simple_world_comm", max_cycles=3)
    _float64_parallel(t_env._par, j_env._par, "simple_world_comm")
    j_env.reset(seed=1)
    t_env.reset(seed=1)
    t_env._par._env.state = _carry(j_env._par._env.state)
    rng = np.random.default_rng(2)
    order = []
    for agent, j_agent in zip(t_env.agent_iter(max_iter=100), j_env.agent_iter(max_iter=100)):
        assert agent == j_agent
        t_last, j_last = t_env.last(), j_env.last()
        if t_env._par._t:   # after the first world step: reset obs are drawn apart
            _assert_close(t_last[0], j_last[0], f"obs {agent}")
        _assert_close(t_last[1], j_last[1], f"reward {agent}")
        assert t_last[2:4] == j_last[2:4]
        if t_last[2] or t_last[3]:
            t_env.step(None)
            j_env.step(None)
            continue
        act = _native_action(t_env.action_space(agent), rng)
        order.append(agent)
        t_env.step(act)
        j_env.step(act)
    assert t_env.agents == j_env.agents == []
    assert order == t_env.possible_agents * 3


def _first_dies_scenario():
    """simple_spread variant whose agent 0 terminates after 2 steps: the
    PettingZoo partial-termination contract."""
    scn = t_scenarios.load("simple_spread")

    class FirstDies(type(scn)):
        def done(self, state):
            base = torch.zeros(state.t.shape + (self.spec.n_agents,), dtype=torch.bool)
            base[..., 0] = state.t >= 2
            return base

    return FirstDies()


def test_parallel_api_partial_termination():
    env = parallel_api.ParallelEnv(_first_dies_scenario(), max_cycles=10, seed=0, device="cpu")
    env.reset(seed=1)
    a0 = env.possible_agents[0]
    for t in range(1, 5):
        acts = {a: np.zeros(env.action_space(a).n) for a in env.agents}
        obs, _, term, _, _ = env.step(acts)
        if t < 2:
            assert a0 in env.agents and term[a0] is False
        elif t == 2:
            assert term[a0] is True and a0 in obs        # reported once
            assert a0 not in env.agents
        else:
            assert a0 not in obs and a0 not in term      # gone afterwards
            assert set(obs) == set(env.possible_agents[1:])
    assert len(env.agents) == 2
    with pytest.raises(AssertionError, match="missing actions"):
        env.step({})


def test_aec_api_partial_termination():
    env = aec_api.aec_env(_first_dies_scenario(), max_cycles=6, seed=0, device="cpu")
    env.reset(seed=1)
    acted = []
    for agent in env.agent_iter(max_iter=40):
        _, _, term, trunc, _ = env.last()
        if term or trunc:
            env.step(None)
            continue
        acted.append(agent)
        env.step(np.zeros(env.action_space(agent).n))
    assert not env.agents                       # episode fully drained
    a0 = env.possible_agents[0]
    others = env.possible_agents[1:]
    assert acted.count(a0) == 2                  # died after step 2
    assert acted.count(others[0]) == acted.count(others[1]) == 6
