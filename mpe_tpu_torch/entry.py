"""Entry point of the port: the counterpart of ``__graft_entry__.entry``.

``entry()`` returns one batched simple_spread step (decode -> physics ->
obs -> reward -> auto-reset over 64 envs) and its inputs.
"""

from __future__ import annotations

import torch

from mpe_tpu_torch import scenarios
from mpe_tpu_torch._device import make_generator
from mpe_tpu_torch.envs.functional import MpeEnv


def entry(device=None):
    """-> (forward, (states, actions, generator)); ``forward`` returns
    (states, obs, reward, done). ``device=None`` means the card."""
    env = MpeEnv(scenarios.load("simple_spread"), max_steps=100, auto_reset=True, device=device)
    n_envs = 64

    def forward(states, actions, generator):
        states, obs, rew, done, _ = env.step(states, actions, generator)
        return states, obs, rew, done

    states, _ = env.reset(n_envs, make_generator(0, env.device))
    actions = torch.zeros((n_envs, env.n_agents, env.action_width), device=env.device)
    return forward, (states, actions, make_generator(1, env.device))


def _same_on_every_rank(mesh, label: str, tensors) -> None:
    """Raise unless each tensor is the same, bit for bit, on every rank."""
    flat = torch.cat([t.detach().reshape(1, -1).double() for t in tensors], dim=1)
    every = mesh.gather(flat, axis=0)
    if not bool((every == every[:1]).all()):
        raise AssertionError(f"{label} differ across ranks")


def _dryrun_rank(mesh) -> None:
    """One rank of ``dryrun_multichip``: the JAX package's dry-run sequence
    at its sizes (``__graft_entry__.dryrun_multichip``), on ``mesh``."""
    from mpe_tpu_torch.learner import build_fused_maddpg_dp, build_fused_ppo_step
    from mpe_tpu_torch.learner.maddpg import init_maddpg, maddpg_act_dim
    from mpe_tpu_torch.learner.optim import tree_leaves
    from mpe_tpu_torch.learner.pg import build_train_step, init_policy
    from mpe_tpu_torch.ops.fused_maddpg import (fused_maddpg_trajectory,
                                                sharded_fused_maddpg_trajectory)
    from mpe_tpu_torch.ops.fused_rollout import fused_rollout, sharded_fused_rollout
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario
    from mpe_tpu_torch.parallel.mesh import sharded_rollout

    n, dev = mesh.size, mesh.device
    scn = scenarios.load("simple_spread")
    env = MpeEnv(scn, max_steps=8, auto_reset=True, device=dev)

    # sharded rollout with trajectory emission (env axis over the ranks)
    _, traj = sharded_rollout(env, 2 * n, 4, mesh=mesh, return_trajectory=True)(
        make_generator(0, dev))
    assert traj["obs"].shape[1] == 2 and mesh.gather(traj["obs"], axis=1).shape[1] == 2 * n

    # data-parallel REINFORCE: the gradient averaged over the ranks
    params = {k: {q: v.to(dev) for q, v in layer.items()}
              for k, layer in init_policy(make_generator(1, "cpu"), scn.obs_width,
                                          env.action_width, hidden=8).items()}
    params, loss = build_train_step(env, 2 * n, 4, lr=1e-2, mesh=mesh)(params,
                                                                        make_generator(2, dev))
    assert bool(torch.isfinite(loss))
    _same_on_every_rank(mesh, "REINFORCE params", tree_leaves(params))

    # the fused rollout (K2) sharded: equal to the single-device run per lane
    got = sharded_fused_rollout("simple_spread", 16 * n, 3, mesh=mesh, horizon=8,
                                block_envs=16)(0)
    want = fused_rollout("simple_spread", 16 * n, 3, horizon=8, block_envs=16, device=dev)(0)
    for lbl, a, b in zip(("pos", "vel", "rew", "ocs"), got, want):
        if not torch.equal(mesh.gather(a, axis=-1), b):
            raise AssertionError(f"sharded fused rollout != single-device ({lbl})")

    # the fused PPO trainer (K5, K6) data-parallel
    step = build_fused_ppo_step("simple_spread", 16 * n, n_steps=4, horizon=4, hidden=16,
                                block_envs=16, t_chunk=2, mesh=mesh)
    state, metrics = step(step.init_state(step.init_params(make_generator(3, "cpu"))), 0)
    assert bool(torch.isfinite(metrics["loss"]))
    _same_on_every_rank(mesh, "fused PPO params", tree_leaves(state[0]))

    # the MADDPG collector (K8) sharded, weights the same on every rank
    md = init_maddpg(make_generator(4, "cpu"), scn.obs_width, maddpg_act_dim(env),
                     env.n_agents, hidden=8)
    md = {net: {k: {q: v.to(dev) for q, v in layer.items()} for k, layer in tree.items()}
          for net, tree in md.items()}
    kscn = kernel_scenario("simple_spread")
    got = sharded_fused_maddpg_trajectory(kscn, md["actor"], 16 * n, 4, mesh=mesh, horizon=4,
                                          block_envs=16, t_chunk=2)(0, md["actor"])
    want = fused_maddpg_trajectory(kscn, md["actor"], 16 * n, 4, horizon=4, block_envs=16,
                                   t_chunk=2, device=dev)(0, md["actor"])
    for lbl, a, b in zip(("obs", "act", "rew", "obs2"), got, want):
        if not torch.equal(mesh.gather(a, axis=-1), b):
            raise AssertionError(f"sharded fused MADDPG collect != single-device ({lbl})")

    # the data-parallel fused MADDPG trainer (K8, K9): local replay shards,
    # the gradient averaged, params the same on every rank
    dp = build_fused_maddpg_dp(env, 2 * n, mesh=mesh, horizon=4, updates_per_chunk=2,
                               cap_chunks=2, batch=16, block_envs=2, t_chunk=2, hidden=8)
    targets = {net: {k: dict(layer) for k, layer in tree.items()} for net, tree in md.items()}
    dstate, dm = dp((md, targets, dp.init_opt(md), dp.init_buffer()), 0)
    assert bool(torch.isfinite(dm["critic_loss"]))
    _same_on_every_rank(mesh, "DP MADDPG params",
                        [x for net in ("actor", "critic") for x in tree_leaves(dstate[0][net])])


def dryrun_multichip(n_ranks: int, device=None) -> None:
    """The JAX package's multi-device dry run (``__graft_entry__.py``) over
    ``n_ranks`` launched ranks (``parallel.launch``; ``device=None``: the
    card, nccl where each rank has a card of its own, else gloo): a sharded
    rollout with trajectories, a data-parallel REINFORCE step, the sharded
    fused rollout (K2) and MADDPG collector (K8) equal to their
    single-device runs per lane, a data-parallel fused PPO step (K5, K6) and
    a data-parallel fused MADDPG chunk (K8, K9) whose params stay the same on
    every rank. A failed assertion on any rank fails the launch. On the card
    the kernels are built here first, so the ranks load them."""
    from mpe_tpu_torch._device import resolve_device
    from mpe_tpu_torch.parallel.launch import launch

    if resolve_device(device).type == "cuda":
        from mpe_tpu_torch.ops import _build

        _build.build_all((8, 16))
    launch("mpe_tpu_torch.entry:_dryrun_rank", n_ranks, device=device)
