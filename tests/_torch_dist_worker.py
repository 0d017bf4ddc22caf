"""One rank of the port's multi-process tests (``tests/test_torch_sharding.py``),
run by ``mpe_tpu_torch.parallel.launch.launch``: it imports torch and the port
only.

``run_all(mesh, in_path, out_dir)`` reads the inputs the test wrote (initial
params made by the JAX package, the JAX draws of the data-parallel MADDPG's
replay indices), runs every phase on this rank and writes its results to
``out_dir/rank<r>.npz``. ``fail_on_rank_1(mesh)`` raises on rank 1 while rank 0
waits in a collective.
"""

import os

import numpy as np
import torch

from mpe_tpu_torch import scenarios
from mpe_tpu_torch.convert import params_from_numpy
from mpe_tpu_torch.envs.functional import MpeEnv
from mpe_tpu_torch.learner import (build_fused_maddpg_dp, build_fused_mappo_step,
                                   build_fused_ppo_step, build_mappo_step, build_ppo_step,
                                   build_train_step, init_ac, init_mappo, init_policy)
from mpe_tpu_torch.ops.fused_maddpg import sharded_fused_maddpg_trajectory
from mpe_tpu_torch.ops.fused_policy import fused_policy_trajectory
from mpe_tpu_torch.ops.fused_rollout import sharded_fused_rollout
from mpe_tpu_torch.parallel.mesh import build_rollout, fold_host_key, sharded_rollout

# the phases' shapes, shared with the test
K2 = dict(n_envs=64, n_steps=6, horizon=4, block_envs=16)
K2_NAMES = ("simple_spread", "simple_adversary")
K5 = dict(n_envs=64, n_steps=8, horizon=8, block_envs=16, t_chunk=4)
K8 = dict(n_envs=64, n_steps=8, horizon=4, block_envs=16, t_chunk=4)
PPO = dict(n_envs=64, n_steps=4, horizon=4, hidden=16, block_envs=16, t_chunk=4)
PPO_SEEDS = (0, 1)
DP = dict(n_envs=4, horizon=4, updates_per_chunk=2, cap_chunks=2, batch=16, block_envs=2,
          t_chunk=2, hidden=8)
DP_SEEDS = (0, 1)
GENERIC = dict(n_envs=8, hidden=8)
GENERIC_SEEDS = (20, 21)


def unflatten(flat: dict, prefix: str) -> dict:
    """``{"prefix.a.b": x}`` -> ``{"a": {"b": x}}`` (any depth)."""
    out: dict = {}
    for key, x in flat.items():
        if not key.startswith(prefix + "."):
            continue
        *path, leaf = key[len(prefix) + 1:].split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = x
    return out


def flatten(tree, prefix: str, out: dict) -> dict:
    for k, v in tree.items():
        if isinstance(v, dict):
            flatten(v, f"{prefix}.{k}", out)
        else:
            out[f"{prefix}.{k}"] = v.detach().cpu().numpy() if torch.is_tensor(v) else v
    return out


def generic_env():
    return MpeEnv(scenarios.load("simple_spread"), max_steps=4, auto_reset=True,
                  dtype=torch.float64, device="cpu")


def generic_params(kind: str) -> dict:
    """The generic learners' initial params (float64), made alike here and
    in the test."""
    env = generic_env()
    gen = torch.Generator().manual_seed(3)
    ow, h = env.scenario.obs_width, GENERIC["hidden"]
    if kind == "reinforce":
        return init_policy(gen, ow, env.action_width, hidden=h, dtype=torch.float64)
    if kind == "ppo":
        return init_ac(gen, ow, 5, hidden=h, dtype=torch.float64)
    return init_mappo(gen, ow, 5, env.n_agents, hidden=h, dtype=torch.float64)


def run_all(mesh, in_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)          # two ranks a test worker: one thread each
    inputs = dict(np.load(in_path))
    out: dict = {"rank": mesh.rank, "fold_int": fold_host_key(5),
                 "fold_gen": torch.rand(3, generator=fold_host_key(
                     torch.Generator().manual_seed(5))).numpy()}

    # (a) the generic engine sharded: shapes, and the bench-mode total
    env = MpeEnv(scenarios.load("simple_spread"), max_steps=4, auto_reset=True, device="cpu")
    states, traj = sharded_rollout(env, 8, 3, mesh=mesh, return_trajectory=True)(
        torch.Generator().manual_seed(1))
    out["a.local_obs_shape"] = np.array(traj["obs"].shape)
    out["a.local_pos_shape"] = np.array(states.pos.shape)
    out["a.obs"] = mesh.gather(traj["obs"], axis=1).numpy()
    out["a.total"] = sharded_rollout(env, 8, 3, mesh=mesh)(torch.Generator().manual_seed(1))[1]
    out["a.local_total"] = build_rollout(env, 4, 3)(
        mesh.rank_key(torch.Generator().manual_seed(1)))[1]

    # (b) K2 sharded, gathered on the env axis
    for name in K2_NAMES:
        run = sharded_fused_rollout(name, mesh=mesh, device="cpu", **K2)
        for label, x in zip(("pos", "vel", "rew", "ocs"), run(5)):
            out[f"b.{name}.{label}"] = mesh.gather(x, axis=-1).numpy()

    # (c) K5 on the rank's lanes with its block offset, gathered
    ppo0 = params_from_numpy(unflatten(inputs, "ppo"), device="cpu")
    actor = {"l1": ppo0["l1"], "l2": ppo0["l2"], "out": ppo0["pi"]}
    local, block, offset = mesh.shard_envs(K5["n_envs"], K5["block_envs"])
    k5 = fused_policy_trajectory("simple_spread", actor, local, K5["n_steps"],
                                 horizon=K5["horizon"], block_envs=block, t_chunk=K5["t_chunk"],
                                 device="cpu")
    for label, x in zip(("obs", "act", "rew", "last_obs"), k5(7, actor, offset)):
        out[f"c.{label}"] = mesh.gather(x, axis=-1).numpy()

    # (d) K8 sharded, weights the same on every rank
    md = params_from_numpy(unflatten(inputs, "md"), device="cpu")
    run = sharded_fused_maddpg_trajectory("simple_spread", md["actor"], mesh=mesh, device="cpu",
                                          **K8)
    for label, x in zip(("obs", "act", "rew", "obs2"), run(3, md["actor"])):
        out[f"d.{label}"] = mesh.gather(x, axis=-1).numpy()

    # (e) data-parallel fused PPO and MAPPO, two iterations
    for kind, build in (("ppo", build_fused_ppo_step), ("mappo", build_fused_mappo_step)):
        step = build("simple_spread", mesh=mesh, device="cpu", **PPO)
        state = step.init_state(params_from_numpy(unflatten(inputs, kind), device="cpu"))
        before = mesh.reduces
        for seed in PPO_SEEDS:
            state, metrics = step(state, seed)
            for k, v in metrics.items():
                out[f"e.{kind}.{seed}.m.{k}"] = float(v)
            flatten(state[0], f"e.{kind}.{seed}.p", out)
        out[f"e.{kind}.reduces"] = mesh.reduces - before

    # (f) data-parallel fused MADDPG, two chunks on the JAX draws' indices
    dp_env = MpeEnv(scenarios.load("simple_spread"), max_steps=DP["horizon"], auto_reset=True,
                    device="cpu")
    dp = build_fused_maddpg_dp(dp_env, mesh=mesh, device="cpu", **DP)
    md = params_from_numpy(unflatten(inputs, "md"), device="cpu")
    targets = params_from_numpy(unflatten(inputs, "md"), device="cpu")
    state = (md, targets, dp.init_opt(md), dp.init_buffer())
    before = mesh.reduces
    for seed in DP_SEEDS:
        idx = inputs[f"idx.r{mesh.rank}.c{seed}"]
        state, metrics = dp(state, seed, indices=idx)
        for k, v in metrics.items():
            out[f"f.{seed}.m.{k}"] = float(v)
        flatten(state[0], f"f.{seed}.p", out)
    out["f.reduces"] = mesh.reduces - before
    out["f.ring"] = state[3].data.numpy()

    # (g) the generic-engine learners, float64
    genv = generic_env()
    steps = {"reinforce": build_train_step(genv, GENERIC["n_envs"], n_steps=4, lr=1e-2,
                                           mesh=mesh),
             "ppo": build_ppo_step(genv, GENERIC["n_envs"], n_steps=6, ppo_epochs=2, mesh=mesh),
             "mappo": build_mappo_step(genv, GENERIC["n_envs"], n_steps=6, ppo_epochs=2,
                                       mesh=mesh)}
    for kind, step in steps.items():
        params = generic_params(kind)
        state = params if kind == "reinforce" else step.init_state(params)
        for seed in GENERIC_SEEDS:
            state, m = step(state, torch.Generator().manual_seed(seed))
            metrics = {"loss": m} if kind == "reinforce" else m
            for k, v in metrics.items():
                out[f"g.{kind}.{seed}.m.{k}"] = float(v)
            flatten(state if kind == "reinforce" else state[0], f"g.{kind}.{seed}.p", out)

    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)


def fail_on_rank_1(mesh) -> None:
    if mesh.rank == 1:
        raise ValueError("rank 1 stops here on purpose")
    mesh.mean_([torch.zeros(1)])
