"""The port's checkpoints and profiling hooks (``mpe_tpu_torch/utils``) on the
CPU:

- the format both ways: a JAX ``save_checkpoint`` of batched simple_spread
  and simple_world_comm states (with a key) and of a params tree loads into
  the port exactly; the port's files load with JAX's ``load_checkpoint`` and
  a JAX template exactly; the printed structure is JAX's ``PyTreeDef``;
- a renamed field raises though the leaf count agrees; ``.npz`` is appended
  both ways; ``convert.read_checkpoint_params`` reads the port's files;
- kill and resume, bit for bit, mirroring ``tests/test_utils.py``: the
  per-step MADDPG learner (its generator in the snapshot), PPO on the generic
  engine, and the fused MADDPG collection plus update chunk (plain K8, K9);
- ``step_phase`` names in the profiler's events; ``trace`` writes a file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe_tpu import scenarios as j_scenarios
from mpe_tpu.envs.functional import MpeEnv as JEnv
from mpe_tpu.learner.ppo import init_ac as j_init_ac
from mpe_tpu.utils import checkpoint as jc
from mpe_tpu_torch import scenarios
from mpe_tpu_torch.convert import (params_from_numpy, params_to_numpy, read_checkpoint_params,
                                   state_from_numpy, state_to_numpy)
from mpe_tpu_torch.envs.functional import MpeEnv
from mpe_tpu_torch.learner import (build_fused_collect, build_fused_update_chunk, build_maddpg,
                                   build_ppo_step, init_ac, init_buffer, init_maddpg)
from mpe_tpu_torch.learner.optim import tree_map
from mpe_tpu_torch.utils import (load_checkpoint, load_train_state, save_checkpoint,
                                 save_train_state, step_phase, trace)
from mpe_tpu_torch.utils.checkpoint import treedef
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _jax_states(name: str, n: int = 4):
    env = JEnv(j_scenarios.load(name))
    states, _ = jax.jit(jax.vmap(env.reset))(jax.random.split(jax.random.PRNGKey(1), n))
    return states


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
        return
    x = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    y = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    assert x.dtype == y.dtype
    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["simple_spread", "simple_world_comm"])
def test_jax_state_checkpoint_loads_into_the_port_and_back(tmp_path, name):
    states = _jax_states(name)
    key = jax.random.PRNGKey(3)
    jc.save_checkpoint(str(tmp_path / "jax.npz"), states, key=key, step=7,
                       extra={"scenario": name})
    like = state_from_numpy(*(np.zeros_like(np.asarray(x)) for x in
                              (states.pos, states.vel, states.comm, states.goal, states.t)),
                            device="cpu")
    assert treedef({"key": torch.zeros(2), "state": like}) == str(
        jax.tree.structure({"key": key, "state": states}))
    payload, step, extra = load_checkpoint(str(tmp_path / "jax"), {"key": torch.zeros(2),
                                                                   "state": like})
    assert step == 7 and extra == {"scenario": name}
    np.testing.assert_array_equal(payload["key"].numpy(), np.asarray(key))
    for got, want in zip(state_to_numpy(payload["state"]),
                         (states.pos, states.vel, states.comm, states.goal, states.t)):
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, np.asarray(want))

    save_checkpoint(str(tmp_path / "port"), payload["state"], key=payload["key"], step=8)
    back, step, extra = jc.load_checkpoint(str(tmp_path / "port.npz"),
                                           {"key": key, "state": states})
    assert step == 8 and extra == {}
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves({"key": key, "state": states})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_params_trees_cross_both_ways(tmp_path):
    params = jax.tree.map(np.asarray, j_init_ac(jax.random.PRNGKey(0), 18, 5, hidden=8))
    jc.save_checkpoint(str(tmp_path / "jax"), params, step=1)
    like = params_from_numpy(jax.tree.map(np.zeros_like, params), device="cpu")
    got, step, _ = load_checkpoint(str(tmp_path / "jax.npz"), {"state": like})
    assert step == 1
    _assert_trees_equal(params_to_numpy(got["state"]), params)
    _assert_trees_equal(read_checkpoint_params(str(tmp_path / "jax.npz")), params)

    mine = init_ac(torch.Generator().manual_seed(4), 18, 5, hidden=8)
    save_checkpoint(str(tmp_path / "port.npz"), mine, step=2)
    back, step, _ = jc.load_checkpoint(str(tmp_path / "port.npz"),
                                       {"state": jax.tree.map(jnp.asarray, params)})
    assert step == 2
    _assert_trees_equal(jax.tree.map(np.asarray, back["state"]), params_to_numpy(mine))
    _assert_trees_equal(read_checkpoint_params(str(tmp_path / "port.npz")), params_to_numpy(mine))


def test_a_renamed_field_raises_though_the_count_agrees(tmp_path):
    params = init_ac(torch.Generator().manual_seed(0), 4, 5, hidden=8)
    save_checkpoint(str(tmp_path / "p"), params)
    renamed = {("torso" if k == "l1" else k): v for k, v in params.items()}
    with pytest.raises(ValueError, match="structure mismatch"):
        load_checkpoint(str(tmp_path / "p"), {"state": renamed})
    with pytest.raises(ValueError, match="structure mismatch"):     # a tuple, not a dict
        load_checkpoint(str(tmp_path / "p"), {"state": tuple(params.values())})
    with pytest.raises(TypeError, match="cannot hold"):
        save_checkpoint(str(tmp_path / "q"), {"fn": print})


def test_npz_suffix_is_normalized_both_ways(tmp_path):
    x = {"a": torch.arange(3)}
    save_checkpoint(str(tmp_path / "one"), x)
    save_checkpoint(str(tmp_path / "two.npz"), x)
    assert (tmp_path / "one.npz").exists() and (tmp_path / "two.npz").exists()
    for path in ("one.npz", "two"):
        got, _, _ = load_checkpoint(str(tmp_path / path), {"state": {"a": torch.zeros(3)}})
        assert torch.equal(got["state"]["a"], x["a"])


def test_maddpg_kill_and_resume_bit_identical(tmp_path):
    """``tests/test_utils.py:74`` on the port: the whole ``build_maddpg``
    train state (params, targets, both Adam states, the replay ring, env
    states, obs and the collection's generator) saved mid-run; the run
    resumed from disk into a template continues bit for bit."""
    env = MpeEnv(scenarios.load("simple"), max_steps=5, auto_reset=True, device="cpu")
    ow = env.scenario.obs_width
    reset_fn, collect_fn, update_fn, init_opt = build_maddpg(env, n_envs=4, capacity=64, batch=8)

    def fresh(seed):
        params = init_maddpg(torch.Generator().manual_seed(seed), ow, 5, env.n_agents, hidden=16)
        return {"params": params, "targets": tree_map3(lambda x: x.clone(), params),
                "opt_states": init_opt(params), "buffer": init_buffer(64, env.n_agents, ow, 5,
                                                                      device="cpu")}

    def iterate(s, it):
        env_states, obs, buffer, _ = collect_fn(s["params"], s["env_states"], s["obs"],
                                                s["buffer"], s["gen"])
        params, targets, opt, m = update_fn(s["params"], s["targets"], s["opt_states"], buffer,
                                            1000 + it)
        return dict(s, params=params, targets=targets, opt_states=opt, buffer=buffer,
                    env_states=env_states, obs=obs), m

    state = fresh(0)
    state["gen"] = torch.Generator().manual_seed(7)
    state["env_states"], state["obs"] = reset_fn(state["gen"])
    for it in range(4):
        state, _ = iterate(state, it)
    save_train_state(str(tmp_path / "maddpg"), state, step=4)
    run_a, metrics_a = state, []
    for it in range(4, 7):
        run_a, m = iterate(run_a, it)
        metrics_a.append({k: float(v) for k, v in m.items()})

    template = dict(fresh(99), gen=torch.Generator(), env_states=state["env_states"],
                    obs=state["obs"])
    run_b, step, _ = load_train_state(str(tmp_path / "maddpg"), template)
    assert step == 4 and run_b["buffer"].ptr == state["buffer"].ptr
    metrics_b = []
    for it in range(4, 7):
        run_b, m = iterate(run_b, it)
        metrics_b.append({k: float(v) for k, v in m.items()})
    assert metrics_a == metrics_b
    _assert_trees_equal(params_to_numpy3(run_a["params"]), params_to_numpy3(run_b["params"]))
    assert torch.equal(run_a["buffer"].data, run_b["buffer"].data)
    assert torch.equal(run_a["gen"].get_state(), run_b["gen"].get_state())


def tree_map3(fn, tree):
    return {net: tree_map(fn, t) for net, t in tree.items()}


def params_to_numpy3(tree):
    return {net: params_to_numpy(t) for net, t in tree.items()}


def test_ppo_train_state_resume(tmp_path):
    """``tests/test_utils.py:145`` on the port: PPO on the generic engine,
    ``(params, opt_state)`` saved after one iteration and resumed."""
    env = MpeEnv(scenarios.load("simple"), device="cpu")
    step = build_ppo_step(env, n_envs=8, n_steps=4, ppo_epochs=1)
    ow = env.scenario.obs_width
    state = step.init_state(init_ac(torch.Generator().manual_seed(0), ow, 5, hidden=16))
    state, _ = step(state, torch.Generator().manual_seed(30))
    save_train_state(str(tmp_path / "ppo"), state, step=1)
    state_a, ma = step(state, torch.Generator().manual_seed(31))
    template = step.init_state(init_ac(torch.Generator().manual_seed(42), ow, 5, hidden=16))
    restored, n_iter, _ = load_train_state(str(tmp_path / "ppo"), template)
    assert n_iter == 1 and restored[1].count == state[1].count == 1
    state_b, mb = step(restored, torch.Generator().manual_seed(31))
    assert float(ma["loss"]) == float(mb["loss"])
    _assert_trees_equal(params_to_numpy(state_a[0]), params_to_numpy(state_b[0]))


def test_fused_maddpg_train_state_resume(tmp_path):
    """``tests/test_utils.py:173`` on the port: the fused loop's state
    (params, targets, Adam states, the ring) between K8 collections and K9
    update chunks (their plain versions here) saved and resumed."""
    env = MpeEnv(scenarios.load("simple_spread"), max_steps=4, auto_reset=True, device="cpu")
    ow, a = env.scenario.obs_width, env.n_agents
    collect = build_fused_collect(env, n_envs=8, n_steps=4, block_envs=8, t_chunk=2,
                                  device="cpu")
    chunk = build_fused_update_chunk(env, 3, batch=16, hidden=16, device="cpu")
    gates = np.ones(3, bool)

    def fresh(seed):
        params = init_maddpg(torch.Generator().manual_seed(seed), ow, 5, a, hidden=16)
        return {"params": params, "targets": tree_map3(lambda x: x.clone(), params),
                "opt_states": chunk.init_opt(params),
                "buffer": init_buffer(128, a, ow, 5, device="cpu")}

    def iterate(s, it):
        buffer, _ = collect(s["params"]["actor"], s["buffer"], it)
        params, targets, opt, m = chunk(s["params"], s["targets"], s["opt_states"], buffer,
                                        500 + it, gates)
        return {"params": params, "targets": targets, "opt_states": opt, "buffer": buffer}, m

    state = fresh(0)
    for it in range(3):
        state, _ = iterate(state, it)
    save_train_state(str(tmp_path / "fused"), state, step=3)
    run_a, ms_a = state, []
    for it in range(3, 6):
        run_a, m = iterate(run_a, it)
        ms_a.append({k: float(v) for k, v in m.items()})
    run_b, step, _ = load_train_state(str(tmp_path / "fused"), fresh(9))
    assert step == 3
    ms_b = []
    for it in range(3, 6):
        run_b, m = iterate(run_b, it)
        ms_b.append({k: float(v) for k, v in m.items()})
    assert ms_a == ms_b
    _assert_trees_equal(params_to_numpy3(run_a["params"]), params_to_numpy3(run_b["params"]))
    assert torch.equal(run_a["buffer"].data, run_b["buffer"].data)


def test_step_phase_names_reach_the_profiler():
    env = MpeEnv(scenarios.load("simple"), device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with step_phase("reset"):
            env.reset(4, torch.Generator().manual_seed(0))
    assert "mpe/reset" in {e.key for e in prof.key_averages()}


def test_trace_writes_a_file(tmp_path):
    env = MpeEnv(scenarios.load("simple"), device="cpu")
    with trace(str(tmp_path / "tr")) as prof:
        with step_phase("reset"):
            env.reset(4, torch.Generator().manual_seed(0))
    files = list((tmp_path / "tr").glob("trace.*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert "mpe/reset" in files[0].read_text()
    assert "mpe/reset" in {e.key for e in prof.key_averages()}
