"""The port's MADDPG on the eight scenarios other than simple_spread, comm
heads included, against the JAX package on the CPU (``test_torch_maddpg.py``
holds simple_spread, ``test_torch_maddpg_collect.py`` the collection).

- the committed ``checkpoints/maddpg_*.npz`` read with numpy equal JAX's
  own loader leaf for leaf; their actors give JAX's logits (float32, within
  1e-6 of the largest logit) and per-head greedy actions on the obs the
  scenario's collection visits;
- plain K9 in float64 against the JAX kernel in interpret mode and against
  autograd of the losses (``maddpg_xla_grads``), 1e-9 of each leaf's
  largest entry;
- one update chunk on simple_speaker_listener against JAX's with JAX's
  replay indices injected (float64);
- one chunk of the runner on simple_speaker_listener is its own collect and
  update loop, and one chunk runs on each of the eight through the plain K8
  and K9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe_tpu import scenarios as j_scenarios
from mpe_tpu.envs.functional import MpeEnv as JEnv
from mpe_tpu.learner import maddpg as jm
from mpe_tpu.ops.fused_maddpg_update import fused_maddpg_update as j_update
from mpe_tpu.utils.checkpoint import load_checkpoint
from mpe_tpu_torch import scenarios as t_scenarios
from mpe_tpu_torch.convert import params_from_numpy, params_to_numpy, read_checkpoint_params
from mpe_tpu_torch.envs.functional import MpeEnv as TEnv
from mpe_tpu_torch.learner import fused_loop
from mpe_tpu_torch.learner import maddpg as tm
from mpe_tpu_torch.ops.fused_maddpg import fused_maddpg_trajectory as t_traj
from mpe_tpu_torch.ops.fused_maddpg_update import fused_maddpg_update as t_update
from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

OTHERS = ["simple", "simple_reference", "simple_speaker_listener", "simple_adversary",
          "simple_push", "simple_crypto", "simple_tag", "simple_world_comm"]
CKPTS = {"simple": "simple", "simple_reference": "reference",
         "simple_speaker_listener": "speaker_listener", "simple_adversary": "adversary",
         "simple_push": "push", "simple_crypto": "crypto", "simple_tag": "tag",
         "simple_world_comm": "world_comm"}
MW = 5


def _flat(tree, prefix=""):
    """Nested dicts -> {path: numpy array}."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
    return out


def _assert_trees(got, want, **tol):
    want, got = _flat(want), _flat(got)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, err_msg=name, **tol)


def _dims(name):
    """(agents, obs width, comm logits) of the scenario's MADDPG nets."""
    kscn = kernel_scenario(name)
    return kscn.spec.n_agents, kscn.obs_w, kscn.n_comm


def _jax_params(name, hidden=16, seed=0, dtype=np.float32):
    a, ow, cw = _dims(name)
    return jax.tree.map(lambda x: np.asarray(x, dtype),
                        jm.init_maddpg(jax.random.PRNGKey(seed), ow, MW + cw, a, hidden=hidden))


def test_act_widths_are_the_kernel_heads():
    for name in OTHERS:
        env = TEnv(t_scenarios.load(name), max_steps=25, device="cpu")
        assert tm.maddpg_act_dim(env) == kernel_scenario(name).n_logits, name


@pytest.mark.parametrize("name", OTHERS)
def test_checkpoint_params_and_actor_logits_match_jax(name):
    path = f"checkpoints/maddpg_{CKPTS[name]}.npz"
    a, ow, cw = _dims(name)
    like = {"state": jm.init_maddpg(jax.random.PRNGKey(0), ow, MW + cw, a)}
    payload, _, _ = load_checkpoint(path, like)
    params = read_checkpoint_params(path)
    _assert_trees(params, payload["state"], rtol=0, atol=0)

    tp = params_from_numpy(params, device="cpu")
    obs = t_traj(name, tp["actor"], 32, 10, horizon=5, block_envs=32, t_chunk=5,
                 device="cpu")(1, tp["actor"])[0]                  # [T, A, OW, N]
    obs = obs.permute(0, 3, 1, 2).reshape(-1, a, ow)                # [T*N, A, OW]
    for i in range(a):
        got = tm.actor_logits_i({q: {w: x[i] for w, x in layer.items()}
                                 for q, layer in tp["actor"].items()}, obs[:, i])
        want = np.asarray(jm.actor_logits_i(jax.tree.map(lambda x: jnp.asarray(x[i]),
                                                         payload["state"]["actor"]),
                                            jnp.asarray(obs[:, i].numpy())))
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * scale,
                                   err_msg=f"agent {i}")
        for lo, hi in ((0, MW), (MW, MW + cw)) if cw else ((0, MW),):
            np.testing.assert_array_equal(got[:, lo:hi].argmax(-1).numpy(),
                                          want[:, lo:hi].argmax(-1), err_msg=f"agent {i}")


def _batch(rng, batch, a, ow, cw, dtype=np.float64):
    obs, obs2 = rng.normal(size=(2, batch, a, ow))
    rew = rng.normal(size=(batch, a))
    act = np.eye(MW)[rng.integers(0, MW, (batch, a))]
    if cw:
        act = np.concatenate([act, np.eye(cw)[rng.integers(0, cw, (batch, a))]], -1)
    return tuple(x.astype(dtype) for x in (obs, act, rew, obs2))


def _targets_of(params, seed=9):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: x + 0.1 * rng.normal(size=x.shape), params)


@pytest.mark.parametrize("name", OTHERS)
def test_plain_maddpg_update_f64_matches_jax_kernel_and_autograd(name):
    batch, hidden = 64, 16
    a, ow, cw = _dims(name)
    aw = MW + cw
    params = _jax_params(name, hidden, dtype=np.float64)
    targets = _targets_of(params)
    data = _batch(np.random.default_rng(7), batch, a, ow, cw)
    want, want_m = j_update(a, ow, aw, MW, hidden=hidden, batch=batch, block_b=32,
                            interpret=True, compute_dtype=jnp.float64)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, targets),
        *map(jnp.asarray, data))
    tp, tt = (params_from_numpy(x, device="cpu", dtype=torch.float64) for x in (params, targets))
    tdata = tuple(torch.tensor(x) for x in data)
    grads_fn = t_update(a, ow, aw, MW, hidden, batch, device="cpu", dtype=torch.float64)
    got, got_m = grads_fn(tp, tt, *tdata)
    auto, auto_m = tm.maddpg_xla_grads(tp, tt, *tdata, mw=MW, cw=cw, gamma=0.95, ent_coef=0.01)
    flat_w = _flat(want)
    scale = max(np.abs(w).max() for w in flat_w.values())
    for other, other_m in ((got, got_m), (auto, auto_m)):
        for leaf, g in _flat(other).items():
            assert g.dtype == np.float64, leaf
            np.testing.assert_allclose(g, flat_w[leaf], rtol=1e-9, atol=1e-9 * max(scale, 1.0),
                                       err_msg=leaf)
        np.testing.assert_allclose([float(x) for x in other_m], [float(x) for x in want_m],
                                   rtol=1e-9, atol=1e-12)
    if cw:                                   # the comm logits receive a gradient
        assert np.abs(_flat(got)["actor.out.b"][:, MW:]).max() > 0


def test_update_chunk_matches_jax_with_injected_indices():
    name, n_updates, batch, cap = "simple_speaker_listener", 3, 32, 256
    a, ow, cw = _dims(name)
    j_env = JEnv(j_scenarios.load(name), max_steps=25, auto_reset=True)
    t_env = TEnv(t_scenarios.load(name), max_steps=25, auto_reset=True, device="cpu")
    params = _jax_params(name, 64, dtype=np.float64)
    targets = _targets_of(params, 4)
    data = _batch(np.random.default_rng(5), cap, a, ow, cw, np.float32)
    jb = jm.Buffer.pack(*map(jnp.asarray, data), ptr=jnp.int32(0), size=jnp.int32(cap))
    tb = tm.Buffer.pack(*(torch.tensor(x) for x in data), ptr=0, size=cap)
    key = jax.random.PRNGKey(21)
    gates = np.asarray([True, False, True])
    j_chunk = jm.build_fused_update_chunk(j_env, n_updates, batch=batch, tau_polyak=0.03,
                                          block_b=32, interpret=True, grad_engine="kernel",
                                          compute_dtype=jnp.float64)
    jp, jt = (jax.tree.map(jnp.asarray, x) for x in (params, targets))
    jp, jt, _, jmet = j_chunk(jp, jt, j_chunk.init_opt(jp), jb, key, jnp.asarray(gates))
    keys = jax.vmap(lambda u: jax.random.fold_in(key, u))(jnp.arange(n_updates, dtype=jnp.uint32))
    idx = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (batch,), 0, cap))(keys))
    tp, tt = (params_from_numpy(x, device="cpu", dtype=torch.float64) for x in (params, targets))
    chunk = tm.build_fused_update_chunk(t_env, n_updates, batch=batch, tau_polyak=0.03,
                                        device="cpu", dtype=torch.float64)
    p, t, o, met = chunk(tp, tt, chunk.init_opt(tp), tb, 0, gates, indices=idx)
    _assert_trees(params_to_numpy(p), jp, rtol=1e-9, atol=1e-9)
    _assert_trees(params_to_numpy(t), jt, rtol=1e-9, atol=1e-9)
    assert o["actor"].count == 2 and o["critic"].count == n_updates
    for metric in ("critic_loss", "actor_loss", "q"):
        np.testing.assert_allclose(float(met[metric]), float(jmet[metric]), rtol=1e-9,
                                   err_msg=metric)


def test_comm_runner_chunk_is_its_collect_and_update_loop():
    """One chunk of the runner on simple_speaker_listener (a speaker, a
    silent listener) equals the port's own collections (warm-up seeds
    0..39, then 10_000) and update chunk."""
    name, hor = "simple_speaker_listener", 5
    a, ow, cw = _dims(name)
    run = fused_loop.build_fused_maddpg_runner(name, n_envs=8, horizon=hor, batch=32,
                                               device="cpu")
    params, info = run(hor, seed=2, actor_start=0)
    p = tm.init_maddpg(torch.Generator().manual_seed(2), ow, MW + cw, a)
    t = tm._tree3(torch.clone, p)
    o = run.update_chunk.init_opt(p)
    buf = tm.init_buffer(run.capacity, a, ow, MW + cw, device="cpu")
    for i in range(200 // hor):
        buf, _ = run.collect(p["actor"], buf, i)
    buf, mr = run.collect(p["actor"], buf, 10_000)
    p, t, o, m = run.update_chunk(p, t, o, buf, fused_loop.chunk_key(2, 0),
                                  fused_loop.actor_gates(0, hor, 0))
    _assert_trees(params_to_numpy(params), params_to_numpy(p), rtol=0, atol=0)
    assert float(info["critic_loss"][0]) == float(m["critic_loss"])
    assert float(info["mean_reward"][0]) == float(mr)
    assert info["buffer"].data.shape[1] == a * (2 * ow + MW + cw + 1) == 62
    # the silent listener's stored comm is a one-hot
    act = info["buffer"].act[:info["buffer"].size]
    assert bool((act[:, 1, MW:].sum(-1) == 1).all())
    assert o["actor"].count == 3


@pytest.mark.parametrize("name", OTHERS)
def test_runner_runs_every_scenario_on_the_cpu(name):
    """One chunk of the runner through the plain K8 and K9: the ring's rows
    have the scenario's width, the losses and params are finite."""
    a, ow, cw = _dims(name)
    run = fused_loop.build_fused_maddpg_runner(name, n_envs=4, horizon=25, batch=16,
                                               device="cpu")
    params, info = run(25, seed=1, actor_start=0)
    assert info["buffer"].data.shape[1] == a * (2 * ow + MW + cw + 1)
    assert info["buffer"].size == (8 + 1) * 4 * 25
    assert bool(torch.isfinite(info["critic_loss"]).all())
    assert bool(torch.isfinite(info["mean_reward"]).all())
    for leaf in _flat(params).values():
        assert np.isfinite(leaf).all()
