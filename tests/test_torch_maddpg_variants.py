"""The port's MADDPG variants against the JAX package on the CPU, in float64
at 1e-10 (rtol and atol) where the two compute the same losses:

- independent-DDPG critics (``local_critic=True``): ``maddpg_xla_grads``
  against JAX's on simple_spread and simple_speaker_listener (a comm
  head); with one agent the same as the centralized critic; agent 0's
  gradient unmoved when the other agents' obs and actions are scrambled;
  the fused runner end to end;
- ``gumbel_softmax_st`` on JAX's uniforms: the one-hot and the gradient;
- ``build_maddpg``: ``update_fn`` against JAX's with JAX's rows injected,
  the actor gate on and off; the port's ``build_fused_update`` (plain K9)
  against it on the same rows; ``collect_fn``'s rows, ``ptr``, ``size`` and
  the pre-reset next obs at the horizon; comm actions as two one-hots; the
  capacity check;
- §4.3 ensembles: ``ensemble_xla_grads`` against JAX's at K = 2 and 3 with
  the same ``k_b``; K = 1 is ``maddpg_xla_grads``; a sub with no samples
  gets a zero gradient; ``sub_slice``; the runner's ``train_mask`` and
  ``k_active``; the chunk-alignment check;
- §4.2 approximations: ``approx_xla_grads`` against JAX's; with the true
  actors copied in, vanilla's actor and critic gradients; gradient steps
  lower the MLE loss; the runner end to end and its refusal of one agent;
- ``convert`` carries an ensemble tree and an approx tree both ways.

JAX's learners cast to float32, which narrows float64 under x64, so the
JAX modules run with a ``jnp`` whose ``float32`` is float64. The JAX
runners are not run (their K8 runs in Pallas interpret mode); the port's
runners run end to end at small sizes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpe_tpu.learner.approx_others as j_approx
import mpe_tpu.learner.ensemble as j_ens
import mpe_tpu.learner.maddpg as jm
from mpe_tpu import scenarios as j_scenarios
from mpe_tpu.envs.functional import MpeEnv as JEnv
from mpe_tpu_torch import scenarios as t_scenarios
from mpe_tpu_torch.convert import params_from_numpy, params_to_numpy
from mpe_tpu_torch.envs.functional import MpeEnv as TEnv
from mpe_tpu_torch.learner import approx_others as t_approx
from mpe_tpu_torch.learner import ensemble as t_ens
from mpe_tpu_torch.learner import fused_loop
from mpe_tpu_torch.learner import maddpg as tm
from mpe_tpu_torch.learner.optim import tree_map
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-10, atol=1e-10)
HIDDEN, BATCH = 16, 32
GAMMA, ENT = 0.95, 0.01
COMM = ["simple_spread", "simple_speaker_listener"]


class _Float64Jnp:
    """``jax.numpy`` with ``float32`` meaning float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@pytest.fixture()
def f64(monkeypatch):
    for module in (jm, j_ens, j_approx):
        monkeypatch.setattr(module, "jnp", _Float64Jnp())


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
    return out


def _close(got, want, **tol):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, err_msg=name, **(tol or TOL))


def _dims(name):
    """(agents, obs width, act width, move width, comm width)."""
    env = TEnv(t_scenarios.load(name), max_steps=25, auto_reset=True, device="cpu")
    _, o, aw, mw, cw = tm._dims(env)
    return env.n_agents, o, aw, mw, cw


def _batch(name, batch=BATCH, seed=7):
    """A replay batch of float64 (obs, act one-hots per head, rew, obs2)."""
    a, o, aw, mw, cw = _dims(name)
    rng = np.random.default_rng(seed)
    obs, obs2 = rng.normal(size=(2, batch, a, o))
    act = np.eye(mw)[rng.integers(0, mw, (batch, a))]
    if cw:
        act = np.concatenate([act, np.eye(cw)[rng.integers(0, cw, (batch, a))]], -1)
    return obs, act, rng.normal(size=(batch, a)), obs2


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


def _perturbed(tree, seed=9):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: x + 0.1 * rng.normal(size=x.shape), tree)


def _t(tree):
    return params_from_numpy(tree, device="cpu", dtype=torch.float64)


def _grads_close(t_out, j_out):
    (tg, tm_), (jg, jm_) = t_out, j_out
    _close(tg, jg)
    np.testing.assert_allclose([float(x) for x in tm_], [float(x) for x in jm_], **TOL)


# ---- independent-DDPG critics ------------------------------------------------

@pytest.mark.parametrize("name", COMM)
def test_local_critic_grads_match_jax(f64, name):
    a, o, aw, mw, cw = _dims(name)
    params = _np_tree(jm.init_maddpg(jax.random.PRNGKey(0), o, aw, a, hidden=HIDDEN,
                                     local_critic=True))
    assert params["critic"]["l1"]["w"].shape == (a, o + aw, HIDDEN)
    targets = _perturbed(params)
    data = _batch(name)
    kw = dict(mw=mw, cw=cw, gamma=GAMMA, ent_coef=ENT, local_critic=True)
    want = jax.jit(functools.partial(jm.maddpg_xla_grads, **kw))(
        params, targets, *map(jnp.asarray, data))
    got = tm.maddpg_xla_grads(_t(params), _t(targets), *map(torch.tensor, data), **kw)
    _grads_close(got, want)


def test_local_critic_with_one_agent_is_the_centralized_critic():
    a, o, aw, mw, cw = _dims("simple")
    assert a == 1
    params = tm.init_maddpg(torch.Generator().manual_seed(0), o, aw, a, hidden=HIDDEN,
                            dtype=torch.float64, local_critic=True)
    targets = tm._tree3(lambda x: x + 0.1, params)
    data = tuple(torch.tensor(x) for x in _batch("simple"))
    kw = dict(mw=mw, cw=cw, gamma=GAMMA, ent_coef=ENT)
    local = tm.maddpg_xla_grads(params, targets, *data, local_critic=True, **kw)
    central = tm.maddpg_xla_grads(params, targets, *data, **kw)
    _grads_close(local, central)


def test_local_critic_agent_ignores_the_others():
    """Agent 0's gradient is the same bit for bit when agents 1 and 2's obs,
    next obs and actions are scrambled: its critic sees only its own."""
    a, o, aw, mw, cw = _dims("simple_spread")
    params = tm.init_maddpg(torch.Generator().manual_seed(0), o, aw, a, hidden=HIDDEN,
                            local_critic=True)
    targets = tm.init_maddpg(torch.Generator().manual_seed(1), o, aw, a, hidden=HIDDEN,
                             local_critic=True)
    obs, act, rew, obs2 = (torch.tensor(x, dtype=torch.float32)
                           for x in _batch("simple_spread", 64))
    kw = dict(mw=mw, cw=cw, gamma=GAMMA, ent_coef=ENT, local_critic=True)
    g1, _ = tm.maddpg_xla_grads(params, targets, obs, act, rew, obs2, **kw)
    gen = torch.Generator().manual_seed(9)
    obs_s, obs2_s, act_s = obs.clone(), obs2.clone(), act.clone()
    obs_s[:, 1:] += torch.randn(obs[:, 1:].shape, generator=gen)
    obs2_s[:, 1:] += torch.randn(obs2[:, 1:].shape, generator=gen)
    act_s[:, 1:] = act[:, 1:].roll(1, dims=0)
    g2, _ = tm.maddpg_xla_grads(params, targets, obs_s, act_s, rew, obs2_s, **kw)
    for net in ("actor", "critic"):
        for name, x in _flat(g1[net]).items():
            np.testing.assert_array_equal(x[0], _flat(g2[net])[name][0], err_msg=name)


def test_local_critic_runner_end_to_end():
    run = fused_loop.build_fused_maddpg_runner("simple_spread", local_critic=True, n_envs=8,
                                               batch=BATCH, hidden=HIDDEN, device="cpu")
    params, info = run(50, seed=0, actor_start=25)
    a, o, aw, _, _ = _dims("simple_spread")
    assert params["critic"]["l1"]["w"].shape == (a, o + aw, HIDDEN)
    assert info["updates"] == 50 and info["critic_loss"].shape == (2,)
    assert torch.isfinite(info["critic_loss"]).all() and torch.isfinite(info["mean_reward"]).all()
    for x in _flat(params).values():
        assert np.isfinite(x).all()
    assert info["opt_states"]["actor"].count == 13         # gated slots 0, 2, ..., 24 of chunk 1
    with pytest.raises(ValueError, match="autograd"):
        tm.build_fused_update_chunk(run.env, 25, local_critic=True, device="cpu")


# ---- gumbel_softmax_st ---------------------------------------------------------

def test_gumbel_softmax_st_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(16, 3, 5))
    w = rng.normal(size=(16, 3, 5))
    key, tau = jax.random.PRNGKey(4), 0.7
    u = np.asarray(jax.random.uniform(key, logits.shape, minval=1e-10, maxval=1.0))
    fwd = jm.gumbel_softmax_st(jnp.asarray(logits), key, tau)
    jgrad = jax.grad(lambda z: jnp.sum(jnp.asarray(w) * jm.gumbel_softmax_st(z, key, tau)))(
        jnp.asarray(logits))
    z = torch.tensor(logits, requires_grad=True)
    out = tm.gumbel_softmax_st(z, tau=tau, uniform=torch.tensor(u))
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(out.detach().round().numpy(), np.asarray(fwd).round())
    assert set(np.unique(out.detach().round().numpy())) == {0.0, 1.0}
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(fwd), **TOL)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(jgrad), **TOL)


# ---- build_maddpg --------------------------------------------------------------

def _maddpg_setup(name, n_envs=8, capacity=256):
    a, o, aw, mw, cw = _dims(name)
    params = _np_tree(jm.init_maddpg(jax.random.PRNGKey(0), o, aw, a, hidden=HIDDEN))
    targets = _perturbed(params)
    rng = np.random.default_rng(5)
    moves = np.eye(mw, dtype=np.float32)[rng.integers(0, mw, (capacity, a))]
    act = moves if not cw else np.concatenate(
        [moves, np.eye(cw, dtype=np.float32)[rng.integers(0, cw, (capacity, a))]], -1)
    data = (rng.normal(size=(capacity, a, o)).astype(np.float32), act,
            rng.normal(size=(capacity, a)).astype(np.float32),
            rng.normal(size=(capacity, a, o)).astype(np.float32))
    t_env = TEnv(t_scenarios.load(name), max_steps=25, auto_reset=True, dtype=torch.float64,
                 device="cpu")
    return params, targets, data, t_env


@pytest.mark.parametrize("name", COMM)
def test_build_maddpg_update_fn_matches_jax(f64, name):
    """Two updates, the actor gate on then off, JAX's rows injected."""
    params, targets, data, t_env = _maddpg_setup(name)
    cap = data[0].shape[0]
    j_env = JEnv(j_scenarios.load(name), max_steps=25, auto_reset=True, dtype=jnp.float64)
    kw = dict(n_envs=8, capacity=cap, batch=BATCH, tau_polyak=0.03, critic_lr=2e-3)
    _, _, j_update, j_init = jm.build_maddpg(j_env, **kw)
    _, _, t_update, t_init = tm.build_maddpg(t_env, **kw)
    jb = jm.Buffer.pack(*map(jnp.asarray, data), ptr=jnp.int32(0), size=jnp.int32(cap))
    tb = tm.Buffer.pack(*map(torch.tensor, data), ptr=0, size=cap)
    jp, jt = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, targets)
    js = j_init(jp)
    tp, tt = _t(params), _t(targets)
    ts = t_init(tp)
    for u, gate in enumerate((True, False)):
        key = jax.random.PRNGKey(20 + u)
        idx = np.asarray(jax.random.randint(key, (BATCH,), 0, jnp.maximum(jnp.int32(cap), 1)))
        jp, jt, js, jmet = j_update(jp, jt, js, jb, key, gate)
        tp, tt, ts, tmet = t_update(tp, tt, ts, tb, 0, do_actor=gate, indices=idx)
        _close(params_to_numpy(tp), jp)
        _close(params_to_numpy(tt), jt)
        for net in ("actor", "critic"):
            assert ts[net].count == int(js[net][0].count), net
            _close(params_to_numpy(ts[net].mu), js[net][0].mu, rtol=1e-10, atol=1e-13)
            _close(params_to_numpy(ts[net].nu), js[net][0].nu, rtol=1e-10, atol=1e-16)
        for k in jmet:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), err_msg=k, **TOL)
    assert ts["actor"].count == 1 and ts["critic"].count == 2


@pytest.mark.parametrize("name", COMM)
def test_fused_update_is_build_maddpg_update_fn(name):
    """The port's ``build_fused_update`` (the plain K9 on the CPU) and
    ``build_maddpg``'s ``update_fn`` (autograd) on the same rows."""
    params, targets, data, t_env = _maddpg_setup(name)
    cap = data[0].shape[0]
    tb = tm.Buffer.pack(*map(torch.tensor, data), ptr=0, size=cap)
    fused = tm.build_fused_update(t_env, batch=BATCH, tau_polyak=0.03, hidden=HIDDEN,
                                  device="cpu", dtype=torch.float64)
    _, _, update, init = tm.build_maddpg(t_env, n_envs=8, capacity=cap, batch=BATCH,
                                         tau_polyak=0.03)
    sf = sm = (_t(params), _t(targets), init(_t(params)))
    rng = np.random.default_rng(11)
    for gate in (True, False, True):
        idx = rng.integers(0, cap, BATCH)
        *sf, mf = fused(*sf, tb, 0, gate, indices=idx)
        *sm, mm = update(*sm, tb, 0, do_actor=gate, indices=idx)
        for x, y in zip(sf[:2], sm[:2]):
            _close(params_to_numpy(x), params_to_numpy(y), rtol=1e-9, atol=1e-9)
        for k in mm:
            np.testing.assert_allclose(float(mf[k]), float(mm[k]), rtol=1e-9, err_msg=k)


def _assert_one_hots(x):
    """Straight-through one-hots (``hard + soft - soft``), as JAX's comm
    test holds them: each sums and peaks at 1 within 1e-6, none negative."""
    np.testing.assert_allclose(x.sum(-1).numpy(), 1.0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(x.amax(-1).numpy(), 1.0, rtol=0, atol=1e-6)
    assert x.min() >= 0


def test_build_maddpg_collect_fn():
    """Each step writes ``n_envs`` rows ``[obs | act | rew | obs2]`` at
    ``ptr``; at the horizon the stored obs2 is the true next obs (the plain
    env's step on the stored actions) while the returned obs and state are a
    fresh reset; the ring wraps."""
    name, n, cap = "simple_spread", 8, 32
    a, o, aw, mw, _ = _dims(name)
    scn = t_scenarios.load(name)
    env = TEnv(scn, max_steps=3, auto_reset=True, device="cpu")
    plain = TEnv(scn, max_steps=3, device="cpu")
    reset_fn, collect_fn, _, _ = tm.build_maddpg(env, n_envs=n, capacity=cap, batch=8)
    params = tm.init_maddpg(torch.Generator().manual_seed(1), o, aw, a, hidden=HIDDEN)
    gen = torch.Generator().manual_seed(0)
    states, obs = reset_fn(gen)
    buf = tm.init_buffer(cap, a, o, aw, device="cpu")
    for step in range(4):
        before, obs_before = states, obs
        states, obs, buf, mr = collect_fn(params, states, obs, buf, gen)
        assert (buf.ptr, buf.size) == ((step + 1) * n % cap, min((step + 1) * n, cap))
        s_obs, s_act, s_rew, s_obs2 = buf._split(buf.data[step * n:(step + 1) * n])
        torch.testing.assert_close(s_obs, obs_before, rtol=0, atol=0)
        _assert_one_hots(s_act[..., :mw])
        pad = torch.zeros((n, a, env.action_width - aw))
        _, obs2, rew, done, _ = plain.step(before, torch.cat([s_act, pad], -1))
        torch.testing.assert_close(s_obs2, obs2, rtol=0, atol=0)
        torch.testing.assert_close(s_rew, rew, rtol=0, atol=0)
        assert float(mr) == float(rew.mean())
        if step == 2:                       # the horizon: stored obs2 pre-reset, lanes reset
            assert done.all() and (states.t == 0).all() and not torch.equal(obs, obs2)
        else:
            assert not done.any() and torch.equal(obs, obs2)


def test_build_maddpg_comm_actions_are_two_one_hots():
    name, n = "simple_speaker_listener", 8
    a, o, aw, mw, cw = _dims(name)
    env = TEnv(t_scenarios.load(name), max_steps=25, auto_reset=True, device="cpu")
    reset_fn, collect_fn, update_fn, init_opt = tm.build_maddpg(env, n_envs=n, capacity=n * 50,
                                                                batch=16)
    params = tm.init_maddpg(torch.Generator().manual_seed(0), o, aw, a, hidden=HIDDEN)
    gen = torch.Generator().manual_seed(1)
    states, obs = reset_fn(gen)
    buf = tm.init_buffer(n * 50, a, o, aw, device="cpu")
    for _ in range(3):
        states, obs, buf, _ = collect_fn(params, states, obs, buf, gen)
    act = buf.act[:buf.size]                                   # [rows, A, 8]
    assert aw == 8 and cw == 3
    for part in (act[..., :mw], act[..., mw:]):
        _assert_one_hots(part)
    # an update drawing its rows from the generator: the comm head's logits move
    new, _, _, m = update_fn(params, tm._tree3(torch.clone, params), init_opt(params), buf, gen)
    assert all(bool(torch.isfinite(x)) for x in m.values())
    assert not torch.equal(new["actor"]["out"]["w"][..., mw:], params["actor"]["out"]["w"][..., mw:])


def test_build_maddpg_capacity_must_hold_whole_steps():
    env = TEnv(t_scenarios.load("simple_spread"), max_steps=25, auto_reset=True, device="cpu")
    with pytest.raises(ValueError, match="multiple of n_envs"):
        tm.build_maddpg(env)                                   # JAX's 32 envs, 50,000 rows
    with pytest.raises(ValueError, match="auto_reset"):
        tm.build_maddpg(TEnv(t_scenarios.load("simple_spread"), device="cpu"), capacity=64)


# ---- §4.3 ensembles ----------------------------------------------------------

def _ens_setup(name, k_ens, seed=0):
    a, o, aw, mw, cw = _dims(name)
    params = _np_tree(j_ens.init_ensemble(jax.random.PRNGKey(seed), o, aw, a, k_ens,
                                          hidden=HIDDEN))
    k_b = np.random.default_rng(4).integers(0, k_ens, (BATCH, a)).astype(np.int32)
    return params, _perturbed(params), _batch(name), k_b, dict(mw=mw, cw=cw, gamma=GAMMA,
                                                                ent_coef=ENT)


@pytest.mark.parametrize("name, k_ens", [("simple_spread", 2), ("simple_spread", 3),
                                         ("simple_speaker_listener", 2),
                                         ("simple_speaker_listener", 3)])
def test_ensemble_grads_match_jax(f64, name, k_ens):
    params, targets, data, k_b, kw = _ens_setup(name, k_ens)
    want = jax.jit(functools.partial(j_ens.ensemble_xla_grads, **kw))(
        params, targets, *map(jnp.asarray, data), jnp.asarray(k_b))
    got = t_ens.ensemble_xla_grads(_t(params), _t(targets), *map(torch.tensor, data),
                                   torch.tensor(k_b), **kw)
    _grads_close(got, want)


@pytest.mark.parametrize("name", COMM)
def test_ensemble_of_one_is_vanilla(name):
    a, o, aw, mw, cw = _dims(name)
    params = t_ens.init_ensemble(torch.Generator().manual_seed(0), o, aw, a, 1, hidden=HIDDEN,
                                 dtype=torch.float64)
    again = tm.init_maddpg(torch.Generator().manual_seed(0), o, aw, a, hidden=HIDDEN,
                           dtype=torch.float64)
    sub = lambda t: tm._tree3(lambda x: x[:, 0], t)
    _close(params_to_numpy(sub(params)), params_to_numpy(again), rtol=0, atol=0)
    targets = tm._tree3(lambda x: x + 0.05, params)
    data = tuple(torch.tensor(x) for x in _batch(name))
    kw = dict(mw=mw, cw=cw, gamma=GAMMA, ent_coef=ENT)
    (ge, me) = t_ens.ensemble_xla_grads(params, targets, *data, torch.zeros((BATCH, a), dtype=int),
                                        **kw)
    gv, mv = tm.maddpg_xla_grads(sub(params), sub(targets), *data, **kw)
    _grads_close((sub(ge), me), (gv, mv))


def test_ensemble_sub_without_samples_gets_no_gradient():
    """Every transition from sub 0: sub 1's gradient is zero, sub 0's is
    vanilla's on its slice."""
    a, o, aw, mw, cw = _dims("simple_spread")
    params = t_ens.init_ensemble(torch.Generator().manual_seed(0), o, aw, a, 2, hidden=HIDDEN,
                                 dtype=torch.float64)
    targets = t_ens.init_ensemble(torch.Generator().manual_seed(1), o, aw, a, 2, hidden=HIDDEN,
                                  dtype=torch.float64)
    data = tuple(torch.tensor(x) for x in _batch("simple_spread", 64))
    kw = dict(mw=mw, cw=cw, gamma=GAMMA, ent_coef=ENT)
    ge, _ = t_ens.ensemble_xla_grads(params, targets, *data, torch.zeros((64, a), dtype=int),
                                     **kw)
    sub = lambda t, k: tm._tree3(lambda x: x[:, k], t)
    gv, _ = tm.maddpg_xla_grads(sub(params, 0), sub(targets, 0), *data, **kw)
    assert not any(x.any() for x in _flat(sub(ge, 1)).values())
    _close(params_to_numpy(sub(ge, 0)), params_to_numpy(gv), rtol=1e-12, atol=1e-12)


def test_sub_slice_matches_jax():
    a, o, aw, _, _ = _dims("simple_tag")
    params = _np_tree(j_ens.init_ensemble(jax.random.PRNGKey(2), o, aw, a, 3, hidden=8))
    k_vec = np.array([2, 0, 1, 2])
    want = j_ens.sub_slice(params["actor"], jnp.asarray(k_vec))
    got = t_ens.sub_slice(_t(params)["actor"], k_vec)
    _close(got, want, rtol=0, atol=0)
    assert all(x.is_contiguous() for x in _flat(got).values() if torch.is_tensor(x))
    _close(t_ens.sub_slice(_t(params)["actor"], torch.tensor(k_vec)), want, rtol=0, atol=0)


def test_ensemble_runner_train_mask_freezes_agent_zero():
    """``train_mask=(False, True, True)``, ``k_active=(2, 1, 1)``: agent 0's
    actors stay their initial values bit for bit; agent 1's sub 0 moves and
    its sub 1, never sampled, keeps actor and critic."""
    run = t_ens.build_ensemble_runner("simple_spread", 2, n_envs=8, batch=BATCH, hidden=HIDDEN,
                                      train_mask=(False, True, True), k_active=(2, 1, 1),
                                      device="cpu")
    params, info = run(25, seed=0, actor_start=0)
    a, o, aw, _, _ = _dims("simple_spread")
    init = t_ens.init_ensemble(torch.Generator().manual_seed(0), o, aw, a, 2, hidden=HIDDEN)
    for q in ("l1", "l2", "out"):
        for w in ("w", "b"):
            assert torch.equal(params["actor"][q][w][0], init["actor"][q][w][0]), (q, w)
            assert not torch.equal(params["actor"][q][w][1, 0], init["actor"][q][w][1, 0])
            for net in ("actor", "critic"):
                assert torch.equal(params[net][q][w][1, 1], init[net][q][w][1, 1]), (net, q, w)
    assert not torch.equal(params["critic"]["l1"]["w"][0], init["critic"]["l1"]["w"][0])
    assert torch.isfinite(info["critic_loss"]).all()
    assert (info["k_ring"][:, 1:] == 0).all() and info["buffer"].size == 9 * 8 * 25


def test_ensemble_runner_needs_whole_chunks_in_the_ring():
    with pytest.raises(ValueError, match="divide 1600"):
        t_ens.build_ensemble_runner("simple_spread", 2, horizon=30, device="cpu")


# ---- §4.2 approximate other-agent policies -----------------------------------

@pytest.mark.parametrize("name", COMM)
def test_approx_grads_match_jax(f64, name):
    a, o, aw, mw, cw = _dims(name)
    params = _np_tree(jm.init_maddpg(jax.random.PRNGKey(0), o, aw, a, hidden=HIDDEN))
    params["approx"] = _np_tree(j_approx.init_approx(jax.random.PRNGKey(31), o, aw, a,
                                                     hidden=HIDDEN))
    targets = _perturbed(params)
    data = _batch(name)
    kw = dict(mw=mw, cw=cw, gamma=GAMMA, ent_coef=ENT)
    want = jax.jit(functools.partial(j_approx.approx_xla_grads, **kw))(
        params, targets, *map(jnp.asarray, data))
    got = t_approx.approx_xla_grads(_t(params), _t(targets), *map(torch.tensor, data), **kw)
    _grads_close(got, want)


@pytest.mark.parametrize("name", COMM)
def test_approx_from_true_actors_is_vanilla(name):
    a, o, aw, mw, cw = _dims(name)
    params = tm.init_maddpg(torch.Generator().manual_seed(0), o, aw, a, hidden=HIDDEN,
                            dtype=torch.float64)
    targets = tm._tree3(lambda x: x + 0.05, params)
    params["approx"] = t_approx.approx_from_actors(params["actor"], a)
    targets["approx"] = t_approx.approx_from_actors(targets["actor"], a)
    data = tuple(torch.tensor(x) for x in _batch(name))
    kw = dict(mw=mw, cw=cw, gamma=GAMMA, ent_coef=ENT)
    g, (closs, aloss, _) = t_approx.approx_xla_grads(params, targets, *data, **kw)
    gv, (closs_v, aloss_v, _) = tm.maddpg_xla_grads(params, targets, *data, **kw)
    _close(params_to_numpy({k: g[k] for k in ("actor", "critic")}), params_to_numpy(gv),
           rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose([float(closs), float(aloss)], [float(closs_v), float(aloss_v)],
                               rtol=1e-12)


def test_approx_gradient_steps_lower_the_mle_loss():
    a, o, aw, mw, cw = _dims("simple_speaker_listener")
    params = tm.init_maddpg(torch.Generator().manual_seed(0), o, aw, a, hidden=HIDDEN,
                            dtype=torch.float64)
    params["approx"] = t_approx.init_approx(torch.Generator().manual_seed(1), o, aw, a,
                                            hidden=HIDDEN, dtype=torch.float64)
    data = tuple(torch.tensor(x) for x in _batch("simple_speaker_listener", 64))
    kw = dict(mw=mw, cw=cw, gamma=GAMMA, ent_coef=ENT)
    losses = []
    for _ in range(6):
        g, (_, _, ploss) = t_approx.approx_xla_grads(params, params, *data, **kw)
        losses.append(float(ploss))
        params["approx"] = tree_map(lambda p, d: p - 0.5 * d, params["approx"], g["approx"])
    assert all(x > y for x, y in zip(losses, losses[1:])), losses


def test_approx_runner_end_to_end():
    run = t_approx.build_approx_runner("simple_spread", n_envs=8, batch=BATCH, hidden=HIDDEN,
                                       device="cpu")
    params, info = run(25, seed=0, actor_start=0)
    a, o, aw, _, _ = _dims("simple_spread")
    init = t_approx.init_approx(torch.Generator().manual_seed(31), o, aw, a, hidden=HIDDEN)
    assert not torch.equal(params["approx"]["l1"]["w"], init["l1"]["w"])
    assert info["opt_states"]["approx"].count == 25 and info["opt_states"]["actor"].count == 13
    assert torch.isfinite(info["critic_loss"]).all()
    for x in _flat(params).values():
        assert np.isfinite(x).all()
    with pytest.raises(ValueError, match="OTHER agents"):
        t_approx.build_approx_runner("simple", device="cpu")


# ---- weights carried across --------------------------------------------------

def test_convert_carries_ensemble_and_approx_trees():
    a, o, aw, _, _ = _dims("simple_speaker_listener")
    as_np = functools.partial(jax.tree.map, np.asarray)
    ens = as_np(j_ens.init_ensemble(jax.random.PRNGKey(0), o, aw, a, 3, hidden=8))
    approx = as_np(jm.init_maddpg(jax.random.PRNGKey(1), o, aw, a, hidden=8))
    approx["approx"] = as_np(j_approx.init_approx(jax.random.PRNGKey(2), o, aw, a, hidden=8))
    assert approx["approx"]["l1"]["w"].shape == (a, a, o, 8)
    assert ens["critic"]["l1"]["w"].shape == (a, 3, a * (o + aw), 8)
    for tree in (ens, approx):
        there = params_from_numpy(tree, device="cpu")
        _close(there, tree, rtol=0, atol=0)
        back = params_to_numpy(there)
        _close(back, tree, rtol=0, atol=0)
        assert all(x.dtype == np.float32 for x in _flat(back).values())
