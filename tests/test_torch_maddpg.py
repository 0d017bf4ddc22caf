"""The port's MADDPG pieces (plain versions of kernels K8 and K9, the ring,
Adam with actor gates, the update chunk, the runner) against the JAX package
on the CPU.

- the committed checkpoint ``checkpoints/maddpg_spread_fused.npz`` read with
  numpy equals JAX's own loader leaf for leaf, and its actors give JAX's
  logits (float32, within 1e-6 of the largest logit) and greedy actions on
  the same observations;
- plain K8 against ``fused_maddpg_trajectory(interpret=True)``, both output
  forms, eps 0 and 0.1: actions equal, values within 1e-5;
- ``build_fused_collect`` fills the ring and wraps a misaligned ``ptr`` as
  JAX's does: rows within 1e-5, ``ptr`` and ``size`` equal;
- plain K9 against the JAX kernel in interpret mode (float64, 1e-9 of each
  leaf's largest entry) and against autograd of the losses
  (``maddpg_xla_grads``);
- ``_apply_maddpg_update`` against JAX's at float64 1e-12, scalar and [A]
  gates, Adam's shared count included;
- one update chunk against JAX's with JAX's replay indices injected (float64);
- the runner's gate schedule and its prefix property, against the port's own
  collect and update loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpe_tpu import scenarios as j_scenarios
from mpe_tpu.envs.functional import MpeEnv as JEnv
from mpe_tpu.learner import maddpg as jm
from mpe_tpu.ops.fused_maddpg import fused_maddpg_trajectory as j_traj
from mpe_tpu.ops.fused_maddpg_update import fused_maddpg_update as j_update
from mpe_tpu.ops.kernel_scenarios import kernel_scenario as j_kernel_scenario
from mpe_tpu.utils.checkpoint import load_checkpoint
from mpe_tpu_torch import scenarios as t_scenarios
from mpe_tpu_torch.convert import params_from_numpy, params_to_numpy, read_checkpoint_params
from mpe_tpu_torch.envs.functional import MpeEnv as TEnv
from mpe_tpu_torch.learner import fused_loop
from mpe_tpu_torch.learner import maddpg as tm
from mpe_tpu_torch.learner.optim import adam
from mpe_tpu_torch.ops.fused_maddpg import fused_maddpg_trajectory as t_traj
from mpe_tpu_torch.ops.fused_maddpg_update import fused_maddpg_update as t_update

A, OW, K = 3, 18, 5
CKPT = "checkpoints/maddpg_spread_fused.npz"


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
    want = _flat(want)
    got = _flat(got)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, err_msg=name, **tol)


def _jax_params(hidden=16, seed=0, dtype=np.float32):
    return jax.tree.map(lambda x: np.asarray(x, dtype),
                        jm.init_maddpg(jax.random.PRNGKey(seed), OW, K, A, hidden=hidden))


def test_checkpoint_params_and_actor_logits_match_jax():
    like = {"state": jm.init_maddpg(jax.random.PRNGKey(0), OW, K, A)}
    payload, step, _ = load_checkpoint(CKPT, like)
    assert step == 24_000
    params = read_checkpoint_params(CKPT)
    _assert_trees(params, payload["state"], rtol=0, atol=0)

    tp = params_from_numpy(params, device="cpu")
    obs = t_traj("simple_spread", tp["actor"], 64, 25, horizon=25, block_envs=64, t_chunk=5,
                 device="cpu")(1, tp["actor"])[0]                  # [T, A, OW, N]
    obs = obs.permute(0, 3, 1, 2).reshape(-1, A, OW)                # [T*N, A, OW]
    for i in range(A):
        got = tm.actor_logits_i({q: {w: x[i] for w, x in layer.items()}
                                 for q, layer in tp["actor"].items()}, obs[:, i])
        want = np.asarray(jm.actor_logits_i(jax.tree.map(lambda x: jnp.asarray(x[i]),
                                                         payload["state"]["actor"]),
                                            jnp.asarray(obs[:, i].numpy())))
        # float32 sums of 64 products in another order: 1e-6 of the largest logit
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * scale,
                                   err_msg=f"agent {i}")
        np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_plain_maddpg_trajectory_matches_jax_interpret(eps):
    kw = dict(n_envs=32, n_steps=12, horizon=6, eps_greedy=eps, block_envs=16, t_chunk=4)
    actor = _jax_params()["actor"]
    tactor = params_from_numpy(actor, device="cpu")
    kscn = j_kernel_scenario("simple_spread")
    for rows in (False, True):
        want = j_traj(kscn, actor, interpret=True, emit_rows=rows, **kw)(
            5, jax.tree.map(jnp.asarray, actor), 1)
        got = t_traj("simple_spread", tactor, emit_rows=rows, device="cpu", **kw)(5, tactor, 1)
        got, want = ((got,), (want,)) if rows else (got, want)
        for name, g, w in zip(("obs", "act", "rew", "obs2"), got, want):
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
            atol = 0 if name == "act" else 1e-5
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol,
                                       err_msg=f"{name} (rows={rows})")
        if not rows:
            act = got[1].numpy()
            np.testing.assert_array_equal(act.sum(2), np.ones((12, A, 32)))
            if eps:
                # the eps coin binds for about eps of the draws: compare with eps = 0
                greedy = t_traj("simple_spread", tactor, device="cpu",
                                **dict(kw, eps_greedy=0.0))(5, tactor, 1)[1].numpy()
                first = (act[0] != greedy[0]).any(1).mean()
                assert 0.0 < first < 0.3, first


def test_fused_collect_fills_and_wraps_the_ring_as_jax():
    hor, n, t = 6, 32, 12
    actor = _jax_params()["actor"]
    j_env = JEnv(j_scenarios.load("simple_spread"), max_steps=hor, auto_reset=True)
    t_env = TEnv(t_scenarios.load("simple_spread"), max_steps=hor, auto_reset=True, device="cpu")
    j_collect = jm.build_fused_collect(j_env, n_envs=n, n_steps=t, block_envs=16, t_chunk=4,
                                       interpret=True)
    t_collect = tm.build_fused_collect(t_env, n, t, block_envs=16, t_chunk=4, device="cpu")
    rpc = t_collect.rows_per_chunk
    assert rpc == j_collect.rows_per_chunk == t * n
    cap, off = 2 * rpc, 37                       # misaligned: the second insert wraps
    jb = jm.init_buffer(cap, A, OW, K)._replace(ptr=jnp.asarray(off, jnp.int32))
    tb = tm.init_buffer(cap, A, OW, K, device="cpu")._replace(ptr=off)
    tactor = params_from_numpy(actor, device="cpu")
    for seed in (0, 1, 2):
        jb, jr = j_collect(jax.tree.map(jnp.asarray, actor), jb, seed)
        tb, tr = t_collect(tactor, tb, seed)
        assert (tb.ptr, tb.size) == (int(jb.ptr), int(jb.size))
        np.testing.assert_allclose(tb.data.numpy(), np.asarray(jb.data), rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(tr), float(jr), rtol=1e-5)
    assert tb.size == cap and tb.ptr == (off + 3 * rpc) % cap
    np.testing.assert_allclose(tb.obs2.numpy(), np.asarray(jb.obs2), rtol=0, atol=1e-5)


def _batch(rng, batch, dtype=np.float64):
    obs, obs2 = rng.normal(size=(2, batch, A, OW))
    rew = rng.normal(size=(batch, A))
    act = np.eye(K)[rng.integers(0, K, (batch, A))]
    return tuple(x.astype(dtype) for x in (obs, act, rew, obs2))


def _targets_of(params, seed=9):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: x + 0.1 * rng.normal(size=x.shape), params)


def test_plain_maddpg_update_f64_matches_jax_kernel_and_autograd():
    batch, hidden = 128, 32
    params = _jax_params(hidden, dtype=np.float64)
    targets = _targets_of(params)
    data = _batch(np.random.default_rng(7), batch)
    want, want_m = j_update(A, OW, K, K, hidden=hidden, batch=batch, block_b=64, interpret=True,
                            compute_dtype=jnp.float64)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, targets),
        *map(jnp.asarray, data))
    tp, tt = (params_from_numpy(x, device="cpu", dtype=torch.float64) for x in (params, targets))
    tdata = tuple(torch.tensor(x) for x in data)
    grads_fn = t_update(A, OW, K, K, hidden, batch, device="cpu", dtype=torch.float64)
    got, got_m = grads_fn(tp, tt, *tdata)
    auto, auto_m = tm.maddpg_xla_grads(tp, tt, *tdata, mw=K, cw=0, gamma=0.95, ent_coef=0.01)
    flat_w = _flat(want)
    scale = max(np.abs(w).max() for w in flat_w.values())
    for other, other_m in ((got, got_m), (auto, auto_m)):
        for name, g in _flat(other).items():
            assert g.dtype == np.float64, name
            np.testing.assert_allclose(g, flat_w[name], rtol=1e-9, atol=1e-9 * max(scale, 1.0),
                                       err_msg=name)
        np.testing.assert_allclose([float(x) for x in other_m], [float(x) for x in want_m],
                                   rtol=1e-9, atol=1e-12)
    # the rows path is the same function
    rows = torch.cat([tdata[0].reshape(batch, -1), tdata[1].reshape(batch, -1), tdata[2],
                      tdata[3].reshape(batch, -1)], 1)
    _assert_trees(grads_fn.from_rows(tp, tt, rows)[0], got, rtol=0, atol=0)


def _jax_opt_state(state):
    adam_state = state[0]
    return adam_state.count, adam_state.mu, adam_state.nu


@pytest.mark.parametrize("gates", [[True, False, True], [[True, False, True], [False, False, False],
                                                        [True, False, True]]])
def test_apply_maddpg_update_matches_jax_f64(gates):
    params = _jax_params(16, dtype=np.float64)
    targets = _targets_of(params)
    rng = np.random.default_rng(3)
    j_aopt, j_copt = optax.adam(1e-3), optax.adam(2e-3)
    t_aopt, t_copt = adam(1e-3), adam(2e-3)
    jp, jt = (jax.tree.map(jnp.asarray, x) for x in (params, targets))
    jo = {"actor": j_aopt.init(jp["actor"]), "critic": j_copt.init(jp["critic"])}
    tp, tt = (params_from_numpy(x, device="cpu", dtype=torch.float64) for x in (params, targets))
    to = {"actor": t_aopt.init(tp["actor"]), "critic": t_copt.init(tp["critic"])}
    for gate in gates:
        grads = jax.tree.map(lambda x: rng.normal(size=x.shape), params)
        jp, jt, jo = jm._apply_maddpg_update(jp, jt, jo, jax.tree.map(jnp.asarray, grads),
                                             jnp.asarray(gate), actor_opt=j_aopt,
                                             critic_opt=j_copt, tau_polyak=0.05)
        tp, tt, to = tm._apply_maddpg_update(tp, tt, to, params_from_numpy(grads, "cpu",
                                                                          torch.float64),
                                             np.asarray(gate), actor_opt=t_aopt,
                                             critic_opt=t_copt, tau_polyak=0.05)
        _assert_trees(params_to_numpy(tp), jp, rtol=1e-12, atol=1e-12)
        _assert_trees(params_to_numpy(tt), jt, rtol=1e-12, atol=1e-12)
        for net in ("actor", "critic"):
            count, mu, nu = _jax_opt_state(jo[net])
            assert to[net].count == int(count), net
            _assert_trees(params_to_numpy(to[net].mu), mu, rtol=1e-12, atol=1e-15)
            _assert_trees(params_to_numpy(to[net].nu), nu, rtol=1e-12, atol=1e-15)
    # an agent gated off at every step kept its actor and its moments
    if np.asarray(gates).ndim == 2:
        assert not np.asarray(gates)[:, 1].any()
        init = params_from_numpy(_jax_params(16, dtype=np.float64), "cpu", torch.float64)
        for q in ("l1", "l2", "out"):
            for w in ("w", "b"):
                assert torch.equal(tp["actor"][q][w][1], init["actor"][q][w][1])
                assert not to["actor"].mu[q][w][1].any()


def test_update_chunk_matches_jax_with_injected_indices():
    n_updates, batch, cap = 4, 64, 512
    j_env = JEnv(j_scenarios.load("simple_spread"), max_steps=25, auto_reset=True)
    t_env = TEnv(t_scenarios.load("simple_spread"), max_steps=25, auto_reset=True, device="cpu")
    params = _jax_params(64, dtype=np.float64)
    targets = jax.tree.map(lambda x: x, params)
    data = _batch(np.random.default_rng(5), cap, np.float32)
    jb = jm.Buffer.pack(*map(jnp.asarray, data), ptr=jnp.int32(0), size=jnp.int32(cap))
    tb = tm.Buffer.pack(*(torch.tensor(x) for x in data), ptr=0, size=cap)
    key = jax.random.PRNGKey(21)
    gates = np.asarray([False, True, True, False])
    j_chunk = jm.build_fused_update_chunk(j_env, n_updates, batch=batch, tau_polyak=0.03,
                                          block_b=64, interpret=True, grad_engine="kernel",
                                          compute_dtype=jnp.float64)
    jp, jt = (jax.tree.map(jnp.asarray, x) for x in (params, targets))
    jp, jt, _, jmet = j_chunk(jp, jt, j_chunk.init_opt(jp), jb, key, jnp.asarray(gates))
    keys = jax.vmap(lambda u: jax.random.fold_in(key, u))(jnp.arange(n_updates, dtype=jnp.uint32))
    idx = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (batch,), 0, cap))(keys))
    tp, tt = (params_from_numpy(x, device="cpu", dtype=torch.float64) for x in (params, targets))
    for engine in ("kernel", "autograd"):
        chunk = tm.build_fused_update_chunk(t_env, n_updates, batch=batch, tau_polyak=0.03,
                                            grad_engine=engine, device="cpu",
                                            dtype=torch.float64)
        p, t, o, met = chunk(tp, tt, chunk.init_opt(tp), tb, 0, gates, indices=idx)
        _assert_trees(params_to_numpy(p), jp, rtol=1e-9, atol=1e-9)
        _assert_trees(params_to_numpy(t), jt, rtol=1e-9, atol=1e-9)
        assert o["actor"].count == 2 and o["critic"].count == n_updates
        for name in ("critic_loss", "actor_loss", "q"):
            np.testing.assert_allclose(float(met[name]), float(jmet[name]), rtol=1e-9, err_msg=name)
    # build_fused_update is a chunk of one: a loop of it is the same chunk
    update_fn = tm.build_fused_update(t_env, batch=batch, tau_polyak=0.03, device="cpu",
                                      dtype=torch.float64)
    state = (tp, tt, update_fn.init_opt(tp))
    for u in range(n_updates):
        *state, _ = update_fn(*state, tb, 0, gates[u], indices=idx[u])
    _assert_trees(params_to_numpy(state[0]), jp, rtol=1e-9, atol=1e-9)


RUNNER = dict(n_envs=8, horizon=5, batch=32, device="cpu")   # 5 updates per chunk


@pytest.fixture(scope="module")
def runner():
    return fused_loop.build_fused_maddpg_runner("simple_spread", **RUNNER)


@pytest.fixture(scope="module")
def one_chunk(runner):
    """A one-chunk run (seed 3, actor_start 2)."""
    return runner(5, seed=3, actor_start=2)


def test_actor_gates_schedule():
    np.testing.assert_array_equal(fused_loop.actor_gates(0, 5, 2), [0, 0, 1, 0, 1])
    np.testing.assert_array_equal(fused_loop.actor_gates(1, 5, 2), [1, 0, 1, 0, 1])
    per = fused_loop.actor_gates(1, 5, 0, (1, 2, 3))      # gated slots 3, 4, 5 of the run
    np.testing.assert_array_equal(per[[0, 2, 4]], [[1, 0, 1], [1, 1, 0], [1, 0, 0]])
    assert not per[[1, 3]].any()
    np.testing.assert_array_equal(fused_loop.actor_gates(3, 25, 0, (1, 1, 1)),
                                  np.repeat(fused_loop.actor_gates(3, 25, 0)[:, None], 3, 1))


def test_runner_is_its_collect_and_update_loop(runner, one_chunk):
    """Two chunks of the runner equal the port's own loop of collections
    (warm-up seeds 0..7, then collect_seed0 + i) and update chunks (key
    ``chunk_key(seed, i)``, gates ``actor_gates``); one chunk is a prefix."""
    params, info = runner(10, seed=3, actor_start=2)
    p = tm.init_maddpg(torch.Generator().manual_seed(3), OW, K, A)
    t = tm._tree3(torch.clone, p)
    o = runner.update_chunk.init_opt(p)
    buf = tm.init_buffer(runner.capacity, A, OW, K, device="cpu")
    for i in range(200 // 5):
        buf, _ = runner.collect(p["actor"], buf, i)
    losses = []
    for i in range(2):
        buf, _ = runner.collect(p["actor"], buf, 10_000 + i)
        p, t, o, m = runner.update_chunk(p, t, o, buf, fused_loop.chunk_key(3, i),
                                         fused_loop.actor_gates(i, 5, 2))
        losses.append(float(m["critic_loss"]))
    _assert_trees(params_to_numpy(params), params_to_numpy(p), rtol=0, atol=0)
    _assert_trees(params_to_numpy(info["targets"]), params_to_numpy(t), rtol=0, atol=0)
    assert info["updates"] == 10 and info["buffer"].size == (40 + 2) * 8 * 5
    np.testing.assert_array_equal(info["critic_loss"].numpy(), np.float32(losses))
    assert o["actor"].count == 2 + 3              # k = 2, 4 in chunk 0; 0, 2, 4 in chunk 1
    assert float(one_chunk[1]["critic_loss"][0]) == losses[0]


def test_runner_actor_period(one_chunk):
    """A uniform ``actor_period`` is the default schedule; with period 2 the
    last agent's actor steps on every other gated slot and leaves the default
    run's path."""
    base = one_chunk[0]
    unif, _ = fused_loop.build_fused_maddpg_runner("simple_spread", actor_period=(1, 1, 1),
                                                   **RUNNER)(5, seed=3, actor_start=2)
    _assert_trees(params_to_numpy(unif), params_to_numpy(base), rtol=0, atol=0)
    het, _ = fused_loop.build_fused_maddpg_runner("simple_spread", actor_period=(1, 1, 2),
                                                  **RUNNER)(5, seed=3, actor_start=2)
    init = tm.init_maddpg(torch.Generator().manual_seed(3), OW, K, A)
    for q in ("l1", "l2", "out"):
        for w in ("w", "b"):
            assert not torch.equal(het["actor"][q][w][2], init["actor"][q][w][2])
            assert not torch.equal(het["actor"][q][w][2], base["actor"][q][w][2])


def test_run_fused_maddpg_is_the_runner(one_chunk):
    params, info = fused_loop.run_fused_maddpg("simple_spread", updates=5, seed=3, actor_start=2,
                                               **RUNNER)
    _assert_trees(params_to_numpy(params), params_to_numpy(one_chunk[0]), rtol=0, atol=0)
    assert info["updates"] == 5 and info["n_envs"] == 8


def test_runner_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="local_critic"):
        fused_loop.build_fused_maddpg_runner("simple_spread", local_critic=True, device="cpu")
    with pytest.raises(ValueError, match="actor_period"):
        fused_loop.build_fused_maddpg_runner("simple_spread", actor_period=(1, 2), device="cpu")
    with pytest.raises(NotImplementedError, match="comm head"):
        t_update(2, 10, 8, 5, 16, 32, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fused_loop.build_fused_maddpg_runner("simple_spread")
