"""The port's non-fused learners (``learner/pg.py``, ``learner/ppo.py``,
``learner/eval.py``) against the JAX package, on the CPU in float64 at
1e-10 (rtol and atol).

JAX's non-fused learners cast logits and values to float32
(``astype(jnp.float32)``), which under x64 narrows float64 too; the port
keeps float64 params in float64. So the JAX references here run with a
``jnp`` whose ``float32`` is float64 (``_float64_learners``): the same code,
in float64 throughout.

- the forward functions on converted params;
- the log-probs of ``sample_actions`` and ``_sample_move`` for the
  indices JAX drew;
- ``_gae_scan`` with dones;
- ``_clipped_objective`` and the PPO and MAPPO losses with their autograd
  gradients against ``jax.grad``, on a batch where both clips bind;
- two epochs of clip + Adam with the linear schedule against ``optax``;
- REINFORCE's loss and gradient on an injected episode;
- ``build_greedy_policy`` with ``mute_comm`` and ``obs_mask``;
- ``greedy_state_rollout`` against stepping ``MpeEnv`` by hand;
- one step of each builder on the CPU, with finite metrics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mpe_tpu.learner.eval as j_eval
import mpe_tpu.learner.maddpg as j_maddpg
import mpe_tpu.learner.pg as j_pg
import mpe_tpu.learner.ppo as j_ppo
from mpe_tpu import scenarios as j_scenarios
from mpe_tpu.envs.functional import MpeEnv as JMpeEnv
from mpe_tpu_torch import make_generator
from mpe_tpu_torch import scenarios as t_scenarios
from mpe_tpu_torch.convert import params_from_numpy, params_to_numpy
from mpe_tpu_torch.core.actions import ActionMode
from mpe_tpu_torch.envs import MpeEnv
from mpe_tpu_torch.learner import eval as t_eval
from mpe_tpu_torch.learner import init_maddpg, optim
from mpe_tpu_torch.learner import pg as t_pg
from mpe_tpu_torch.learner import ppo as t_ppo
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-10, atol=1e-10)
HIDDEN = 16


class _Float64Jnp:
    """``jax.numpy`` with ``float32`` meaning float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@pytest.fixture()
def _float64_learners(monkeypatch):
    for module in (j_pg, j_ppo, j_maddpg):
        monkeypatch.setattr(module, "jnp", _Float64Jnp())


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(t, j, msg=""):
    np.testing.assert_allclose(_np(t), np.asarray(j), err_msg=msg, **TOL)


def _tree_close(t_tree, j_tree):
    for k in j_tree:
        for q in j_tree[k]:
            _close(t_tree[k][q], j_tree[k][q], f"{k}.{q}")


def _f64_params(init, *args):
    """JAX params of ``init`` in float64, as numpy, and the same in the port."""
    tree = jax.tree.map(lambda x: np.asarray(x, np.float64),
                        init(jax.random.PRNGKey(0), *args, hidden=HIDDEN))
    return tree, params_from_numpy(tree, device="cpu", dtype=torch.float64)


def _env(name, **kw):
    return (JMpeEnv(j_scenarios.load(name), dtype=jnp.float64, **kw),
            MpeEnv(t_scenarios.load(name), dtype=torch.float64, device="cpu", **kw))


# ---- forward functions ------------------------------------------------------

def test_forward_functions_match_jax(_float64_learners):
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(4, 3, 18))
    t_obs = torch.as_tensor(obs)
    tree, params = _f64_params(j_pg.init_policy, 18, 7)
    got = t_pg.policy_logits(params, t_obs)
    assert got.dtype == torch.float64
    _close(got, j_pg.policy_logits(tree, jnp.asarray(obs)))
    tree, params = _f64_params(j_ppo.init_ac, 18, 5)
    for t, j in zip(t_ppo.policy_value(params, t_obs), j_ppo.policy_value(tree, jnp.asarray(obs))):
        _close(t, j)
    tree, params = _f64_params(j_ppo.init_mappo, 18, 5, 3)
    _close(t_ppo.actor_logits(params, t_obs), j_ppo.actor_logits(tree, jnp.asarray(obs)))
    value = t_ppo.central_value(params, t_obs)
    assert value.shape == (4,)
    _close(value, j_ppo.central_value(tree, jnp.asarray(obs)))
    # float32 params give float32 logits, as JAX's cast does
    f32 = params_from_numpy(tree, device="cpu")
    assert t_ppo.actor_logits(f32, t_obs).dtype == torch.float32


# ---- sampling ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["simple_spread", "simple_reference"])
def test_sample_actions_logp_for_jax_indices(_float64_learners, name):
    j_env, t_env = _env(name)
    spec = t_env.spec
    width = t_env.action_width
    tree, params = _f64_params(j_pg.init_policy, t_env.scenario.obs_width, width)
    obs = np.random.default_rng(1).normal(size=(6, spec.n_agents, t_env.scenario.obs_width))
    keys = jax.random.split(jax.random.PRNGKey(2), 6)
    j_acts, j_logp = jax.vmap(lambda o, k: j_pg.sample_actions(j_env, tree, o, k))(
        jnp.asarray(obs), keys)
    j_acts = np.asarray(j_acts)
    mi = torch.as_tensor(j_acts[..., :5].argmax(-1))
    ci = torch.as_tensor(j_acts[..., 5:].argmax(-1)) if spec.dim_c else None
    logits = t_pg.policy_logits(params, torch.as_tensor(obs))
    _close(t_pg.action_logp(t_env, logits, mi, ci), j_logp)
    # the port's own draw: one-hot rows whose log-prob it returns
    acts, logp = t_pg.sample_actions(t_env, params, torch.as_tensor(obs), make_generator(0, "cpu"))
    assert acts.shape == j_acts.shape and acts.dtype == torch.float64
    assert torch.equal(acts[..., :5].sum(-1), torch.ones(6, spec.n_agents, dtype=torch.float64))
    ci = acts[..., 5:].argmax(-1) if spec.dim_c else None
    _close(logp, t_pg.action_logp(t_env, logits, acts[..., :5].argmax(-1), ci))


def test_sample_move_logp_for_jax_indices(_float64_learners):
    logits = np.random.default_rng(3).normal(size=(8, 3, 5))
    j_acts, j_idx, j_logp = jax.vmap(lambda x, k: j_ppo._sample_move(x, k, 5, 2, jnp.float64))(
        jnp.asarray(logits), jax.random.split(jax.random.PRNGKey(0), 8))
    _close(t_pg.index_logp(torch.as_tensor(logits), torch.as_tensor(np.array(j_idx))), j_logp)
    acts, idx, logp = t_ppo._sample_move(torch.as_tensor(logits), make_generator(1, "cpu"), 5, 2,
                                         torch.float64)
    assert acts.shape == (8, 3, 7) and torch.equal(acts[..., 5:], torch.zeros(8, 3, 2,
                                                                               dtype=torch.float64))
    assert torch.equal(acts[..., :5].argmax(-1), idx)
    _close(logp, t_pg.index_logp(torch.as_tensor(logits), idx))
    with pytest.raises(AssertionError, match="act_dim=5"):
        t_ppo._sample_move(torch.zeros(2, 3, 7), make_generator(1, "cpu"), 5, 2, torch.float64)


def test_categorical_draws_follow_softmax():
    logits = torch.log(torch.tensor([0.1, 0.2, 0.7], dtype=torch.float64)).expand(20000, 3)
    freq = torch.bincount(t_pg.categorical(logits, make_generator(5, "cpu")), minlength=3)
    freq = freq.to(torch.float64) / 20000
    torch.testing.assert_close(freq, torch.tensor([0.1, 0.2, 0.7], dtype=torch.float64),
                               rtol=0, atol=0.015)


# ---- GAE and the clipped objective ------------------------------------------

def test_gae_scan_matches_jax(_float64_learners):
    rng = np.random.default_rng(4)
    values, rewards = rng.normal(size=(2, 12, 5, 3))
    dones = rng.uniform(size=(12, 5, 3)) < 0.2
    last = rng.normal(size=(5, 3))
    got = t_ppo._gae_scan(*map(torch.as_tensor, (values, rewards, dones, last)), 0.95, 0.9)
    want = j_ppo._gae_scan(*map(jnp.asarray, (values, rewards, dones, last)), 0.95, 0.9)
    assert dones.any()
    for t, j in zip(got, want):
        _close(t, j)


def _binding_batch(params, obs, rng, team=False):
    """A batch on ``obs`` whose ratio clip and value clip both bind: the
    old log-probs and values are the current ones pushed far off."""
    with torch.no_grad():
        if team:
            logits = t_ppo.actor_logits(params, obs)
            value = t_ppo.central_value(params, obs)
        else:
            logits, value = t_ppo.policy_value(params, obs)
    act = torch.as_tensor(rng.integers(0, 5, logits.shape[:-1]))
    logp = t_pg.index_logp(logits, act)
    logp_old = logp + torch.as_tensor(rng.normal(0, 0.5, logp.shape))
    value_old = value + torch.as_tensor(rng.normal(0, 0.5, value.shape))
    adv = torch.as_tensor(rng.normal(size=value.shape))
    ret = value + torch.as_tensor(rng.normal(size=value.shape))
    ratio = torch.exp(logp - logp_old)
    assert ((ratio < 0.8) | (ratio > 1.2)).float().mean() > 0.2
    assert ((value - value_old).abs() > 0.2).float().mean() > 0.2
    return (obs, act, logp_old, value_old, adv, ret)


def _jax_loss(team, clip=0.2, vf_coef=0.5, ent_coef=0.01):
    """The loss of JAX's ``build_ppo_step`` (``build_mappo_step``), from
    its module's pieces."""
    def loss_fn(params, batch):
        obs, act, logp_old, value_old, adv, ret = batch
        if team:
            logits, value = j_ppo.actor_logits(params, obs), j_ppo.central_value(params, obs)
        else:
            logits, value = j_ppo.policy_value(params, obs)
        adv_n = (adv - adv.mean()) / (adv.std() + 1e-8)
        pg, vloss, ent = j_ppo._clipped_objective(logits, act, logp_old, value, value_old,
                                                  adv_n[..., None] if team else adv_n, ret, clip)
        return pg + vf_coef * vloss - ent_coef * ent, (pg, vloss, ent)

    return loss_fn


@pytest.mark.parametrize("team", [False, True], ids=["ppo", "mappo"])
def test_losses_and_gradients_match_jax_grad(_float64_learners, team):
    _, t_env = _env("simple_spread")
    build = t_ppo.build_mappo_step if team else t_ppo.build_ppo_step
    tree, params = (_f64_params(j_ppo.init_mappo, 18, 5, 3) if team
                    else _f64_params(j_ppo.init_ac, 18, 5))
    step = build(t_env, 4, 6)
    rng = np.random.default_rng(5)
    batch = _binding_batch(params, torch.as_tensor(rng.normal(size=(6, 4, 3, 18))), rng,
                           team)
    j_batch = tuple(jnp.asarray(_np(x)) for x in batch)
    (j_loss, j_aux), j_grads = jax.value_and_grad(_jax_loss(team), has_aux=True)(tree, j_batch)
    leaves = optim.tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss, aux = step.loss_fn(leaves, batch)
    grads = torch.autograd.grad(loss, optim.tree_leaves(leaves))
    _close(loss, j_loss)
    for t, j in zip(aux, j_aux):
        _close(t, j)
    for t, j in zip(grads, jax.tree.leaves(j_grads)):
        _close(t, j)
    # the shared pieces on their own
    logits = t_ppo.actor_logits(params, batch[0]) if team else t_ppo.policy_value(params,
                                                                                  batch[0])[0]
    adv_b = batch[4][..., None] if team else batch[4]
    value = batch[3] + 0.1
    got = t_ppo._clipped_objective(logits, batch[1], batch[2], value, batch[3], adv_b, batch[5],
                                   0.2)
    want = j_ppo._clipped_objective(jnp.asarray(_np(logits)), j_batch[1], j_batch[2],
                                    jnp.asarray(_np(value)), j_batch[3],
                                    jnp.asarray(_np(adv_b)), j_batch[5], 0.2)
    for t, j in zip(got, want):
        _close(t, j)


def test_epochs_of_clip_adam_with_schedule_match_optax(_float64_learners):
    _, t_env = _env("simple_spread")
    tree, params = _f64_params(j_ppo.init_ac, 18, 5)
    step = t_ppo.build_ppo_step(t_env, 4, 6, lr=0.05, ppo_epochs=2, anneal_iters=3)
    rng = np.random.default_rng(6)
    batch = _binding_batch(params, torch.as_tensor(rng.normal(size=(6, 4, 3, 18))), rng)
    mean_rew = torch.tensor(-1.5, dtype=torch.float64)
    (new, _), metrics = t_ppo._epoch_metrics_step(step.loss_fn, batch, step.opt, 2, mean_rew)(
        *step.init_state(params))
    opt = j_ppo._make_opt(0.05, 3, 2)
    j_params, j_state = tree, opt.init(tree)
    loss_fn = _jax_loss(False)
    j_batch = tuple(jnp.asarray(_np(x)) for x in batch)
    for _ in range(2):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(j_params, j_batch)
        updates, j_state = opt.update(grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
    _tree_close(new, j_params)
    for k, j in zip(("loss", "pg_loss", "v_loss", "entropy"), (loss, *aux)):
        _close(metrics[k], j, k)
    assert metrics["mean_reward"] is mean_rew


# ---- REINFORCE --------------------------------------------------------------

@pytest.mark.parametrize("name", ["simple_spread", "simple_speaker_listener"])
def test_reinforce_loss_and_gradient_match_jax(_float64_learners, name):
    j_env, t_env = _env(name)
    a, ow, width = t_env.n_agents, t_env.scenario.obs_width, t_env.action_width
    tree, params = _f64_params(j_pg.init_policy, ow, width)
    rng = np.random.default_rng(7)
    t_steps, b = 9, 5
    obs = rng.normal(size=(t_steps, b, a, ow))
    mi = rng.integers(0, 5, (t_steps, b, a))
    ci = rng.integers(0, t_env.spec.dim_c, (t_steps, b, a))
    team_rew = rng.normal(size=(t_steps, b))

    def j_loss(p):
        def one_env(o, m, c, r):                          # [T, A, O], [T, A], [T, A], [T]
            mlog, clog = j_pg._split_logits(j_env, j_pg.policy_logits(p, o))
            rows = jnp.arange(a)
            logp = jax.vmap(lambda ml, cl, mm, cc: jnp.sum(jax.nn.log_softmax(ml)[rows, mm])
                            + jnp.sum(jax.nn.log_softmax(cl)[rows, cc]))(mlog, clog, m, c)

            def disc(carry, rr):
                g = rr + 0.95 * carry
                return g, g
            _, returns = jax.lax.scan(disc, jnp.zeros(()), r, reverse=True)
            return -jnp.mean(logp * jax.lax.stop_gradient(returns))
        losses = jax.vmap(one_env, in_axes=1)(*map(jnp.asarray, (obs, mi, ci, team_rew)))
        return jnp.mean(losses)

    j_val, j_grads = jax.value_and_grad(j_loss)(tree)
    leaves = optim.tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss = t_pg.reinforce_loss(t_env, leaves, *map(torch.as_tensor, (obs, mi, ci, team_rew)))
    grads = torch.autograd.grad(loss, optim.tree_leaves(leaves))
    _close(loss, j_val)
    for t, j in zip(grads, jax.tree.leaves(j_grads)):
        _close(t, j)


# ---- greedy evaluation ------------------------------------------------------

@pytest.mark.parametrize("mute_comm", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["simple_speaker_listener", "simple_spread"])
def test_greedy_policy_matches_jax(_float64_learners, name, mute_comm, masked):
    j_env, t_env = _env(name)
    a, ow = t_env.n_agents, t_env.scenario.obs_width
    k = 5 + (t_env.spec.dim_c if name == "simple_speaker_listener" else 0)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float64),
                        j_maddpg.init_maddpg(jax.random.PRNGKey(1), ow, k, a, hidden=HIDDEN))
    params = params_from_numpy(tree, device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(8)
    mask = (rng.uniform(size=(a, ow)) < 0.7).astype(np.float64) if masked else None
    obs = rng.normal(size=(16, a, ow))
    want = j_eval.build_greedy_policy(j_env, tree, mute_comm, mask)(jnp.asarray(obs), None)
    got = t_eval.build_greedy_policy(t_env, params, mute_comm, mask)(torch.as_tensor(obs))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_state_rollout_is_stepping_mpe_env_by_hand():
    scn = t_scenarios.load("simple_speaker_listener")
    params = init_maddpg(torch.Generator().manual_seed(0), 11, 8, 2, hidden=HIDDEN)
    states, rew = t_eval.greedy_state_rollout(scn, params, n_envs=8, n_steps=6, seed=3,
                                              device="cpu")
    j_states, j_rew = j_eval.greedy_state_rollout(
        j_scenarios.load("simple_speaker_listener"), None, n_envs=8, n_steps=6)
    for leaf in ("pos", "vel", "comm", "goal", "t"):
        assert getattr(states, leaf).shape == getattr(j_states, leaf).shape, leaf
        assert isinstance(getattr(states, leaf), np.ndarray)
    assert rew.shape == j_rew.shape == (6, 8, 2)
    env = MpeEnv(scn, device="cpu")
    pol = t_eval.build_greedy_policy(env, params)
    gen = make_generator(3, "cpu")
    state, obs = env.reset(8, gen)
    for t in range(6):
        state, obs, r, _, _ = env.step(state, pol(obs, gen), gen)
        np.testing.assert_array_equal(states.pos[t], state.pos.numpy())
        np.testing.assert_array_equal(states.comm[t], state.comm.numpy())
        np.testing.assert_array_equal(rew[t], r.numpy())
    random_states, random_rew = t_eval.greedy_state_rollout(scn, None, n_envs=8, n_steps=6,
                                                            device="cpu")
    assert random_states.pos.shape == (6, 8, 5, 2) and np.isfinite(random_rew).all()


# ---- the builders, one step each ----------------------------------------------

def test_each_builder_takes_a_finite_step():
    gen = make_generator(0, "cpu")
    env = MpeEnv(t_scenarios.load("simple_spread"), max_steps=25, auto_reset=True, device="cpu")
    params = t_pg.init_policy(gen, 18, 7, hidden=HIDDEN)
    new, loss = t_pg.build_train_step(env, 16, 5)(params, gen)
    assert torch.isfinite(loss) and not torch.equal(new["l1"]["w"], params["l1"]["w"])
    for build, init in ((t_ppo.build_ppo_step, lambda: t_ppo.init_ac(gen, 18, 5, HIDDEN)),
                        (t_ppo.build_mappo_step, lambda: t_ppo.init_mappo(gen, 18, 5, 3, HIDDEN))):
        step = build(env, 16, 8, ppo_epochs=2)
        state0 = step.init_state(init())
        (p, opt_state), metrics = step(state0, gen)
        assert set(metrics) == {"loss", "pg_loss", "v_loss", "entropy", "mean_reward"}
        assert all(torch.isfinite(v) for v in metrics.values())
        assert opt_state.count == 2
        traj, last_value = step.rollout(p, gen)
        assert traj.obs.shape == (8, 16, 3, 18) and traj.act.shape == (8, 16, 3)
        assert last_value.shape == traj.value.shape[1:]
    with pytest.raises(ValueError, match="DISCRETE"):
        t_ppo.build_ppo_step(MpeEnv(t_scenarios.load("simple"), action_mode=ActionMode.CONTINUOUS,
                                    device="cpu"), 4)
    assert params_to_numpy(new)["l1"]["w"].shape == (18, HIDDEN)
