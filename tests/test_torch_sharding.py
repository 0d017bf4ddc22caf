"""The port's multi-device path over ``torch.distributed`` against its own
single-process runs and the JAX package's two-device mesh, on the CPU.

One launch of two gloo ranks per module (``parallel.launch``, the rank worker
``tests/_torch_dist_worker.py``) runs every phase and writes its results; the
JAX side runs here on ``jax.devices()[:2]`` (conftest's virtual devices,
kernels in Pallas interpret mode):

- (a) ``sharded_rollout``'s shapes and bench total, ``fold_host_key`` distinct
  per rank; here, a one-rank ``build_rollout(mesh=)`` equals ``build_rollout``
  and ``init_multihost()`` with nothing set starts no process group;
- (b) ``sharded_fused_rollout`` (K2) gathered: the single-process plain K2 bit
  for bit, JAX's ``sharded_fused_rollout`` within the port's K2 tolerance;
- (c) K5 at the ranks' block offsets gathered: the single run bit for bit;
- (d) ``sharded_fused_maddpg_trajectory`` (K8): the single run bit for bit,
  JAX's sharded collector within the port's K8 tolerance;
- (e) the data-parallel fused PPO and MAPPO, two iterations: JAX's on a
  two-device mesh at 1e-5, the same params on both ranks, a one-process twin
  (both halves collected, their gradients averaged) bit for bit;
- (f) ``build_fused_maddpg_dp``, two chunks on JAX's own replay draws: JAX's
  at 1e-5, the same params on both ranks;
- (g) REINFORCE, PPO and MAPPO on the generic engine with ``mesh=``: a
  one-process twin at 1e-12 in float64; one rank equals no mesh bit for bit;
- (h) a rank that raises fails the launch, and the error names it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_dist_worker as W
from mpe_tpu import scenarios as j_scenarios
from mpe_tpu.envs.functional import MpeEnv as JEnv
from mpe_tpu.learner import build_fused_maddpg_dp as j_dp
from mpe_tpu.learner import fused_ppo as j_ppo
from mpe_tpu.learner.maddpg import init_maddpg as j_init_maddpg
from mpe_tpu.learner.maddpg import maddpg_act_dim as j_act_dim
from mpe_tpu.ops.fused_maddpg import sharded_fused_maddpg_trajectory as j_sharded_k8
from mpe_tpu.ops.fused_rollout import sharded_fused_rollout as j_sharded_k2
from mpe_tpu.ops.kernel_scenarios import kernel_scenario as j_kernel_scenario
from mpe_tpu_torch import scenarios
from mpe_tpu_torch.convert import params_from_numpy, state_to_numpy
from mpe_tpu_torch.envs.functional import MpeEnv
from mpe_tpu_torch.learner import fused_ppo as t_ppo
from mpe_tpu_torch.learner import optim
from mpe_tpu_torch.learner.pg import _episode_loss, build_train_step
from mpe_tpu_torch.learner.ppo import _gae_scan, build_mappo_step, build_ppo_step
from mpe_tpu_torch.ops.fused_maddpg import fused_maddpg_trajectory
from mpe_tpu_torch.ops.fused_policy import fused_policy_trajectory
from mpe_tpu_torch.ops.fused_rollout import fused_rollout
from mpe_tpu_torch.parallel.launch import launch
from mpe_tpu_torch.parallel.mesh import (EnvMesh, build_rollout, env_mesh, fold_host_key,
                                         init_multihost, pick_backend)
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_dist_worker.py")
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _mesh2():
    return Mesh(np.array(jax.devices()[:2]), ("env",))


def _leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_leaves(v, f"{prefix}{k}.") if isinstance(v, dict)
                   else {f"{prefix}{k}": np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)})
    return out


def _jax_dp_env():
    return JEnv(j_scenarios.load("simple_spread"), max_steps=W.DP["horizon"], auto_reset=True)


def _jax_dp_indices(seed: int, rank: int, size: int) -> np.ndarray:
    """JAX's DP MADDPG draw of one rank's replay rows for one chunk
    (``mpe_tpu/learner/maddpg.py:954-959``)."""
    base = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(11), seed), rank)
    keys = jax.vmap(lambda u: jax.random.fold_in(base, u))(
        jnp.arange(W.DP["updates_per_chunk"], dtype=jnp.uint32))
    return np.asarray(jax.vmap(lambda k: jax.random.randint(
        k, (W.DP["batch"],), 0, jnp.maximum(jnp.int32(size), 1)))(keys))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Inputs from the JAX package, one launch of two gloo ranks -> (inputs,
    [rank 0's results, rank 1's])."""
    tmp = tmp_path_factory.mktemp("ranks")
    inputs = {}
    for kind, build in (("ppo", j_ppo.build_fused_ppo_step),
                        ("mappo", j_ppo.build_fused_mappo_step)):
        step = build("simple_spread", _mesh2(), interpret=True, compute_dtype=jnp.float32,
                     **W.PPO)
        inputs.update({f"{kind}.{k}": v for k, v in _leaves(jax.tree.map(
            np.asarray, step.init_params(jax.random.PRNGKey(0)))).items()})
    env = _jax_dp_env()
    md = j_init_maddpg(jax.random.PRNGKey(4), env.scenario.obs_width, j_act_dim(env),
                       env.n_agents, hidden=W.DP["hidden"])
    inputs.update({f"md.{k}": v.astype(np.float32)
                   for k, v in _leaves(jax.tree.map(np.asarray, md)).items()})
    local = W.DP["n_envs"] // 2
    rows = W.DP["horizon"] * local
    for c, seed in enumerate(W.DP_SEEDS):
        size = min((c + 1) * rows, W.DP["cap_chunks"] * rows)
        for r in (0, 1):
            inputs[f"idx.r{r}.c{seed}"] = _jax_dp_indices(seed, r, size)
    in_path = str(tmp / "inputs.npz")
    np.savez(in_path, **inputs)
    launch(f"{WORKER}:run_all", 2, in_path, str(tmp), device="cpu", timeout=300)
    return inputs, [dict(np.load(tmp / f"rank{r}.npz")) for r in (0, 1)]


# ---- (a) the generic engine ----------------------------------------------

def test_sharded_rollout_shapes_total_and_host_keys(ranks):
    _, (r0, r1) = ranks
    for r in (r0, r1):
        assert tuple(r["a.local_obs_shape"]) == (3, 4, 3, 18)
        assert tuple(r["a.local_pos_shape"]) == (4, 6, 2)
        assert r["a.obs"].shape == (3, 8, 3, 18)
        assert r["a.total"] == r0["a.local_total"] + r1["a.local_total"]
    np.testing.assert_array_equal(r0["a.obs"], r1["a.obs"])
    assert r0["fold_int"] != r1["fold_int"]
    assert (r0["fold_int"], r1["fold_int"]) == (fold_host_key(5, 0), fold_host_key(5, 1))
    assert not np.array_equal(r0["fold_gen"], r1["fold_gen"])


@pytest.mark.parametrize("trajectory", [False, True])
def test_one_rank_build_rollout_equals_no_mesh(trajectory):
    env = MpeEnv(scenarios.load("simple_tag"), max_steps=3, auto_reset=True, device="cpu")
    one = env_mesh("cpu")
    assert (one.rank, one.size, one.group) == (0, 1, None)
    runs = [build_rollout(env, 6, 5, return_trajectory=trajectory, mesh=m)(
        torch.Generator().manual_seed(2)) for m in (one, None)]
    (s1, o1), (s0, o0) = runs
    for a, b in zip(state_to_numpy(s1), state_to_numpy(s0)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(o1 if trajectory else {"total": o1}).values(),
                    _leaves(o0 if trajectory else {"total": o0}).values()):
        np.testing.assert_array_equal(a, b)


def test_init_multihost_without_a_cluster_is_one_rank(monkeypatch):
    import torch.distributed as dist

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    mesh = init_multihost(device="cpu")
    assert (mesh.rank, mesh.size, mesh.group, mesh.device.type) == (0, 1, None, "cpu")
    assert not dist.is_initialized()
    assert pick_backend("cpu", 1) == "gloo"
    x = [torch.arange(3.0)]
    assert mesh.mean_(x)[0] is x[0] and mesh.reduces == 0


def test_a_rank_view_shards_but_refuses_collectives():
    view = EnvMesh(1, 2, "cpu")
    assert view.shard_envs(64, 16) == (32, 16, 2)
    x = torch.arange(24).reshape(3, 8)
    assert torch.equal(view.local(x, axis=1), x[:, 4:])
    with pytest.raises(RuntimeError, match="no process group"):
        view.gather(x, axis=1)
    with pytest.raises(RuntimeError, match="no process group"):
        view.mean_([torch.zeros(2)])
    with pytest.raises(ValueError, match="not divisible"):
        view.local_envs(7)
    with pytest.raises(ValueError, match="lane for lane"):       # 24 a rank: blocks of 12
        view.shard_envs(48, 16)


@pytest.mark.parametrize("entry", ["env_mesh", "init_multihost", "sharded_fused_rollout",
                                   "sharded_fused_maddpg_trajectory", "build_fused_maddpg_dp",
                                   "dryrun_multichip"])
def test_entry_points_raise_without_a_card(entry, monkeypatch):
    """``device=None`` is the card: without one every multi-device entry
    point raises rather than run on the CPU."""
    from mpe_tpu_torch.entry import dryrun_multichip
    from mpe_tpu_torch.learner import build_fused_maddpg_dp
    from mpe_tpu_torch.ops.fused_maddpg import sharded_fused_maddpg_trajectory
    from mpe_tpu_torch.ops.fused_rollout import sharded_fused_rollout

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    actor = W.unflatten({"a.l1.w": torch.zeros(18, 8), "a.l1.b": torch.zeros(8),
                         "a.l2.w": torch.zeros(8, 8), "a.l2.b": torch.zeros(8),
                         "a.out.w": torch.zeros(8, 5), "a.out.b": torch.zeros(5)}, "a")
    env = MpeEnv(scenarios.load("simple_spread"), max_steps=4, auto_reset=True, device="cpu")
    calls = {"env_mesh": lambda: env_mesh(),
             "init_multihost": lambda: init_multihost(),
             "sharded_fused_rollout": lambda: sharded_fused_rollout("simple_spread", 64, 2),
             "sharded_fused_maddpg_trajectory": lambda: sharded_fused_maddpg_trajectory(
                 "simple_spread", actor, 64, 4, horizon=4, t_chunk=4),
             "build_fused_maddpg_dp": lambda: build_fused_maddpg_dp(env, 4),
             "dryrun_multichip": lambda: dryrun_multichip(2)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


# ---- (b)-(d) the sharded kernels ------------------------------------------

@pytest.mark.parametrize("name", W.K2_NAMES)
def test_sharded_fused_rollout_equals_single_and_jax(ranks, name):
    _, (r0, r1) = ranks
    single = fused_rollout(name, device="cpu", **W.K2)(5)
    want = j_sharded_k2(name, mesh=_mesh2(), interpret=True, **W.K2)(5)
    for label, s, j in zip(("pos", "vel", "rew", "ocs"), single, want):
        got = r0[f"b.{name}.{label}"]
        np.testing.assert_array_equal(got, r1[f"b.{name}.{label}"])
        np.testing.assert_array_equal(got, s.numpy(), err_msg=label)
        np.testing.assert_allclose(got, np.asarray(j), err_msg=label, **F32_TOL)


def test_policy_trajectory_at_rank_offsets_equals_single(ranks):
    inputs, (r0, _) = ranks
    p = params_from_numpy(W.unflatten(inputs, "ppo"), device="cpu")
    actor = {"l1": p["l1"], "l2": p["l2"], "out": p["pi"]}
    kw = dict(W.K5)
    n_envs, n_steps = kw.pop("n_envs"), kw.pop("n_steps")
    want = fused_policy_trajectory("simple_spread", actor, n_envs, n_steps, device="cpu",
                                   **kw)(7, actor)
    for label, w in zip(("obs", "act", "rew", "last_obs"), want):
        np.testing.assert_array_equal(r0[f"c.{label}"], w.numpy(), err_msg=label)


def test_sharded_maddpg_collect_equals_single_and_jax(ranks):
    inputs, (r0, r1) = ranks
    md = W.unflatten(inputs, "md")
    actor = params_from_numpy(md["actor"], device="cpu")
    single = fused_maddpg_trajectory("simple_spread", actor, device="cpu", **W.K8)(3, actor)
    j_actor = jax.tree.map(jnp.asarray, md["actor"])
    want = j_sharded_k8(j_kernel_scenario("simple_spread"), j_actor, mesh=_mesh2(),
                        interpret=True, **W.K8)(3, j_actor)
    for label, s, j in zip(("obs", "act", "rew", "obs2"), single, want):
        got = r0[f"d.{label}"]
        np.testing.assert_array_equal(got, r1[f"d.{label}"])
        np.testing.assert_array_equal(got, s.numpy(), err_msg=label)
        np.testing.assert_allclose(got, np.asarray(j), rtol=0,
                                   atol=0 if label == "act" else 1e-5, err_msg=label)


# ---- (e) the data-parallel fused PPO and MAPPO -----------------------------

def _fused_twin(kind: str, params, seeds):
    """Both ranks' halves in one process: each epoch's gradient is the mean
    of the two halves' K6 (K7) gradients."""
    build = t_ppo.build_fused_ppo_step if kind == "ppo" else t_ppo.build_fused_mappo_step
    steps = [build("simple_spread", mesh=EnvMesh(r, 2, "cpu"), device="cpu", **W.PPO)
             for r in (0, 1)]
    opt_state = steps[0].opt.init(params)
    for seed in seeds:
        batches = [s.collect(params, seed) for s in steps]
        for _ in range(4):
            grads = []
            for s, (obs, mv, cm, lp, value, adv_n, ret) in zip(steps, batches):
                grads.append(s.update(params, obs, mv, cm, lp, adv_n, ret, value)[0])
            # the mean into the first half's storage, as the ranks' in-place reduce
            g = optim.tree_map(lambda a, b: a.copy_((a + b) / 2), *grads)
            updates, opt_state = steps[0].opt.update(g, opt_state)
            params = optim.apply_updates(params, updates)
    return params


@pytest.mark.parametrize("kind", ["ppo", "mappo"])
def test_dp_fused_trainer_matches_jax_and_twin(ranks, kind):
    inputs, (r0, r1) = ranks
    build = j_ppo.build_fused_ppo_step if kind == "ppo" else j_ppo.build_fused_mappo_step
    j_step = build("simple_spread", _mesh2(), interpret=True, compute_dtype=jnp.float32,
                   **W.PPO)
    j_state = j_step.init_state(jax.tree.map(jnp.asarray, W.unflatten(inputs, kind)))
    for seed in W.PPO_SEEDS:
        j_state, j_m = j_step(j_state, seed)
        for key in j_m:
            got = r0[f"e.{kind}.{seed}.m.{key}"]
            assert got == r1[f"e.{kind}.{seed}.m.{key}"]
            np.testing.assert_allclose(got, float(j_m[key]), err_msg=f"{seed}: {key}",
                                       **F32_TOL)
        for name, want in _leaves(jax.tree.map(np.asarray, j_state[0])).items():
            got = r0[f"e.{kind}.{seed}.p.{name}"]
            np.testing.assert_array_equal(got, r1[f"e.{kind}.{seed}.p.{name}"], err_msg=name)
            np.testing.assert_allclose(got, want, err_msg=f"{seed}: {name}", **F32_TOL)
    assert r0[f"e.{kind}.reduces"] == len(W.PPO_SEEDS) * (4 + 1)     # per epoch, and metrics
    twin = _fused_twin(kind, params_from_numpy(W.unflatten(inputs, kind), device="cpu"),
                       W.PPO_SEEDS)
    last = W.PPO_SEEDS[-1]
    for name, x in _leaves(twin).items():
        np.testing.assert_array_equal(r0[f"e.{kind}.{last}.p.{name}"], x, err_msg=name)


# ---- (f) the data-parallel fused MADDPG -------------------------------------

def test_dp_maddpg_matches_jax_on_its_draws(ranks):
    inputs, (r0, r1) = ranks
    env = _jax_dp_env()
    dp = j_dp(env, _mesh2(), interpret=True, **W.DP)
    md = jax.tree.map(jnp.asarray, W.unflatten(inputs, "md"))
    state = (md, jax.tree.map(lambda x: x, md), dp.init_opt(md), dp.init_buffer())
    for seed in W.DP_SEEDS:
        state, m = dp(state, seed)
        for key in m:
            got = r0[f"f.{seed}.m.{key}"]
            assert got == r1[f"f.{seed}.m.{key}"]
            np.testing.assert_allclose(got, float(m[key]), err_msg=key, **F32_TOL)
        for name, want in _leaves(jax.tree.map(np.asarray, state[0])).items():
            got = r0[f"f.{seed}.p.{name}"]
            np.testing.assert_array_equal(got, r1[f"f.{seed}.p.{name}"], err_msg=name)
            np.testing.assert_allclose(got, want, err_msg=f"{seed}: {name}", **F32_TOL)
    ring = np.asarray(state[3].data)                                 # [2 * cap_local, W]
    half = ring.shape[0] // 2
    np.testing.assert_allclose(r0["f.ring"], ring[:half], rtol=0, atol=1e-5)
    np.testing.assert_allclose(r1["f.ring"], ring[half:], rtol=0, atol=1e-5)
    # one all_reduce per update (the packed gradient) and one for the metrics
    assert r0["f.reduces"] == len(W.DP_SEEDS) * (W.DP["updates_per_chunk"] + 1)


# ---- (g) the generic-engine learners ---------------------------------------

def _generic_twin(kind: str):
    """Both ranks in one process, each with its folded generator, the
    gradients averaged -> {seed: (metrics, params)}."""
    env = W.generic_env()
    n, out = W.GENERIC["n_envs"], {}
    views = [EnvMesh(r, 2, "cpu") for r in (0, 1)]
    if kind == "reinforce":
        params = W.generic_params(kind)
        for seed in W.GENERIC_SEEDS:
            grads, losses = [], []
            for r in (0, 1):
                gen = fold_host_key(torch.Generator().manual_seed(seed), r)
                leaves = optim.tree_map(lambda x: x.detach().requires_grad_(True), params)
                loss = _episode_loss(env, leaves, gen, n // 2, 4)
                grads.append(optim.tree_unflatten(
                    leaves, torch.autograd.grad(loss, optim.tree_leaves(leaves))))
                losses.append(loss.detach())
            g = optim.tree_map(lambda a, b: (a + b) / 2, *grads)
            params = optim.tree_map(lambda x, d: x - 1e-2 * d, params, g)
            out[seed] = ({"loss": (losses[0] + losses[1]) / 2}, params)
        return out
    build = build_ppo_step if kind == "ppo" else build_mappo_step
    steps = [build(env, n, n_steps=6, ppo_epochs=2, mesh=v) for v in views]
    params = W.generic_params(kind)
    opt_state = steps[0].opt.init(params)
    for seed in W.GENERIC_SEEDS:
        batches = []
        for r, s in enumerate(steps):
            traj, last_value = s.rollout(params, fold_host_key(
                torch.Generator().manual_seed(seed), r))
            adv, ret = _gae_scan(traj.value, traj.reward, traj.done, last_value, 0.95, 0.95)
            batches.append(((traj.obs, traj.act, traj.logp, traj.value, adv, ret),
                            traj.reward.mean()))
        for _ in range(2):
            grads, aux = [], []
            for s, (batch, _) in zip(steps, batches):
                leaves = optim.tree_map(lambda x: x.detach().requires_grad_(True), params)
                loss, (pg, vl, ent) = s.loss_fn(leaves, batch)
                grads.append(optim.tree_unflatten(
                    leaves, torch.autograd.grad(loss, optim.tree_leaves(leaves))))
                aux.append([x.detach() for x in (loss, pg, vl, ent)])
            g = optim.tree_map(lambda a, b: (a + b) / 2, *grads)
            updates, opt_state = steps[0].opt.update(g, opt_state)
            params = optim.apply_updates(params, updates)
        names = ("loss", "pg_loss", "v_loss", "entropy")
        metrics = {k: (a + b) / 2 for k, a, b in zip(names, *aux)}
        metrics["mean_reward"] = (batches[0][1] + batches[1][1]) / 2
        out[seed] = (metrics, params)
    return out


@pytest.mark.parametrize("kind", ["reinforce", "ppo", "mappo"])
def test_dp_generic_learners_match_one_process_twin(ranks, kind):
    _, (r0, r1) = ranks
    for seed, (metrics, params) in _generic_twin(kind).items():
        for key, want in metrics.items():
            got = r0[f"g.{kind}.{seed}.m.{key}"]
            assert got == r1[f"g.{kind}.{seed}.m.{key}"]
            np.testing.assert_allclose(got, float(want), rtol=1e-12, atol=1e-12, err_msg=key)
        for name, want in _leaves(params).items():
            got = r0[f"g.{kind}.{seed}.p.{name}"]
            assert got.dtype == np.float64
            np.testing.assert_array_equal(got, r1[f"g.{kind}.{seed}.p.{name}"], err_msg=name)
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("kind", ["reinforce", "ppo", "mappo"])
def test_one_rank_generic_learner_equals_no_mesh(kind):
    env = W.generic_env()
    one = EnvMesh(0, 1, "cpu")
    if kind == "reinforce":
        a, b = (build_train_step(env, 8, n_steps=4, lr=1e-2, mesh=m) for m in (one, None))
        sa = sb = W.generic_params(kind)
    else:
        build = build_ppo_step if kind == "ppo" else build_mappo_step
        a, b = (build(env, 8, n_steps=6, ppo_epochs=2, mesh=m) for m in (one, None))
        sa = sb = a.init_state(W.generic_params(kind))
    for seed in W.GENERIC_SEEDS:
        sa, ma = a(sa, torch.Generator().manual_seed(seed))
        sb, mb = b(sb, torch.Generator().manual_seed(seed))
    pa, pb = (sa, sb) if kind == "reinforce" else (sa[0], sb[0])
    for (name, x), y in zip(_leaves(pa).items(), _leaves(pb).values()):
        np.testing.assert_array_equal(x, y, err_msg=name)


# ---- (h) a failed rank fails the launch ------------------------------------

def test_a_failed_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 failed \(exit code 1\)[\s\S]*"
                                           r"rank 1 stops here on purpose"):
        launch(f"{WORKER}:fail_on_rank_1", 2, device="cpu", timeout=120)
