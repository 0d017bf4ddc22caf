"""Train any of the learners on any scenario (counterpart of
``examples/train.py``): envs split over this process's ranks
(``parallel.env_mesh``: one rank unless the caller launched more), gradients
averaged over them, all rollout compute on the device. Prints a
greedy-policy evaluation (reward per agent-step) at the end and optionally
checkpoints the trained parameters (in the JAX package's format).

    python -m mpe_tpu_torch.examples.train --algo mappo --scenario simple_spread --iters 600
    python -m mpe_tpu_torch.examples.train --algo maddpg --scenario simple --save p.npz

``reinforce``, ``ppo``, ``mappo`` and ``maddpg`` run on the generic engine
(no kernel); ``maddpg --fused-collect`` collects with kernel K8 and updates
with K9; ``fused_ppo`` runs K5 and K6, ``fused_mappo`` K5 and K7.
"""

import argparse

ALGOS = ("reinforce", "ppo", "mappo", "maddpg", "fused_ppo", "fused_mappo")


def per_env_logits(algo: str, params, obs):
    """obs ``[..., A, O]`` -> full-width action logits ``[..., A, W]`` of the
    algorithm's actor (comm logits only for the heads that have them)."""
    if algo == "maddpg":
        from mpe_tpu_torch.learner.maddpg import actor_logits
        return actor_logits(params["actor"], obs)
    if algo in ("mappo", "fused_mappo"):
        from mpe_tpu_torch.learner.ppo import actor_logits
        return actor_logits(params, obs)
    if algo in ("ppo", "fused_ppo"):
        from mpe_tpu_torch.learner.ppo import policy_value
        return policy_value(params, obs)[0]
    from mpe_tpu_torch.learner.pg import policy_logits
    return policy_logits(params, obs)


def greedy_eval(scn, algo, params, n_envs=128, n_steps=25, seed=123, device=None):
    """Reward per agent-step of the argmax (no-exploration) policy, rolled
    out on the generic engine on ``device`` (the methodology of the README
    learner table)."""
    import torch
    import torch.nn.functional as F

    from mpe_tpu_torch import make_generator
    from mpe_tpu_torch.envs import MpeEnv
    from mpe_tpu_torch.parallel import build_rollout

    env = MpeEnv(scn, device=device)
    a = env.n_agents
    mw = 2 * env.spec.dim_p + 1
    pad_c = env.action_width - mw

    def pol(obs, generator):
        logits = per_env_logits(algo, params, obs)
        parts = [F.one_hot(logits[..., :mw].argmax(-1), mw).to(env.dtype)]
        if logits.shape[-1] > mw:          # a comm head
            parts.append(F.one_hot(logits[..., mw:].argmax(-1),
                                   logits.shape[-1] - mw).to(env.dtype))
        elif pad_c:
            parts.append(parts[0].new_zeros(parts[0].shape[:-1] + (pad_c,)))
        return torch.cat(parts, dim=-1)

    with torch.no_grad():
        _, tot = build_rollout(env, n_envs, n_steps, policy=pol)(make_generator(seed, env.device))
    return float(tot) / (n_envs * n_steps * a)


def _maddpg(args, scn, n_envs, device, generator, log):
    """MADDPG: the per-step learner on the generic engine, or with
    ``--fused-collect`` replay chunks collected by K8 and updated by K9."""
    import numpy as np
    import torch

    from mpe_tpu_torch.convert import params_from_numpy
    from mpe_tpu_torch.envs import MpeEnv
    from mpe_tpu_torch.learner import (build_fused_collect, build_fused_update_chunk,
                                       build_maddpg, init_buffer, init_maddpg, maddpg_act_dim)

    env = MpeEnv(scn, max_steps=25, auto_reset=True, device=device)
    mw = maddpg_act_dim(env)   # move head + comm head if anyone speaks
    maddpg_envs = max(8, n_envs)
    capacity = maddpg_envs * 1600
    host = init_maddpg(torch.Generator().manual_seed(0), scn.obs_width, mw, env.n_agents)
    params, targets = (params_from_numpy(host, device=device) for _ in range(2))
    # scaled off --lr so flags take effect; defaults land on the swept
    # 1e-3/1e-3 config of the JAX package's study
    reset_fn, collect_fn, update_fn, init_opt = build_maddpg(
        env, n_envs=maddpg_envs, capacity=capacity, batch=1024, tau_polyak=0.01,
        actor_lr=args.lr / 3, critic_lr=args.lr / 3)
    opt_states = init_opt(params)
    buffer = init_buffer(capacity, env.n_agents, scn.obs_width, mw, device=device)
    # critic-only warmup scales with the run length
    actor_start = min(1000, max(1, args.iters // 3))
    if args.fused_collect:
        # one horizon-length chunk per iteration collected by K8, then
        # `horizon` K9 updates on batches gathered at once, which keeps the
        # per-transition update ratio of the per-step loop (maddpg_run runs
        # the same chunks for long runs)
        horizon = env.max_steps
        # the gate counts updates (it * horizon + k): the critic-only warmup
        # matches the per-step loop's 1000-update start
        actor_start = min(1000, max(1, args.iters * horizon // 3))
        collect = build_fused_collect(env, n_envs=maddpg_envs, n_steps=horizon,
                                      block_envs=min(1024, maddpg_envs), device=device)
        update_chunk = build_fused_update_chunk(env, horizon, batch=1024, tau_polyak=0.01,
                                                actor_lr=args.lr / 3, critic_lr=args.lr / 3,
                                                device=device)
        for i in range(max(1, 200 // horizon)):   # buffer warmup
            buffer, _ = collect(params["actor"], buffer, i)
        k = np.arange(horizon)
        for it in range(args.iters):
            buffer, mr = collect(params["actor"], buffer, 10_000 + it)
            # within-chunk parity, the per-step loop's cadence
            gates = (it * horizon + k >= actor_start) & (k % 2 == 0)
            params, targets, opt_states, m = update_chunk(params, targets, opt_states, buffer,
                                                          90_000 + it, gates)
            if it % 20 == 0 or it == args.iters - 1:
                log(it, {"reward/step": mr, "q": m["q"]})
    else:
        states, obs = reset_fn(generator)
        for _ in range(200):   # buffer warmup
            states, obs, buffer, _ = collect_fn(params, states, obs, buffer, generator)
        for it in range(args.iters):
            states, obs, buffer, mr = collect_fn(params, states, obs, buffer, generator)
            params, targets, opt_states, m = update_fn(
                params, targets, opt_states, buffer, generator,
                (it >= actor_start) and (it % 2 == 0))
            if it % 500 == 0 or it == args.iters - 1:
                log(it, {"reward/step": mr, "q": m["q"]})
    return params


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="simple_spread")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--n-envs", type=int, default=64)
    ap.add_argument("--n-steps", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--algo", default="reinforce", choices=ALGOS)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--save", default=None, metavar="PATH",
                    help="checkpoint trained params (npz) at the end")
    ap.add_argument("--fused-collect", action="store_true",
                    help="maddpg: collect replay chunks with the per-agent kernel K8 "
                         "(ops/fused_maddpg) and update with K9")
    args = ap.parse_args(argv)
    import torch

    from mpe_tpu_torch import make_generator, resolve_device, scenarios
    from mpe_tpu_torch.convert import params_from_numpy
    from mpe_tpu_torch.envs import MpeEnv
    from mpe_tpu_torch.learner import build_train_step, init_policy
    from mpe_tpu_torch.parallel import env_mesh

    device = resolve_device(args.device)
    scn = scenarios.load(args.scenario)
    env = MpeEnv(scn, device=device)
    mesh = env_mesh(device)
    # round down to a rank multiple, but never to zero
    n_envs = max(args.n_envs - args.n_envs % mesh.size, mesh.size)
    init = torch.Generator().manual_seed(0)     # host draws: the same params on any device
    generator = make_generator(1, device)
    last = {}

    def log(it, metrics):
        last.update({k: float(v) for k, v in metrics.items()})
        last["iter"] = it
        print(f"iter {it:5d}  " + "  ".join(f"{k} {v:+.4f}" for k, v in last.items()
                                            if k != "iter"), flush=True)

    if args.algo == "maddpg":
        params = _maddpg(args, scn, n_envs, device, generator, log)
    elif args.algo in ("fused_ppo", "fused_mappo"):
        # rollout collection inside kernel K5 (learner/fused_ppo)
        from mpe_tpu_torch.learner import build_fused_mappo_step, build_fused_ppo_step

        build = build_fused_mappo_step if args.algo == "fused_mappo" else build_fused_ppo_step
        n_steps = args.n_steps
        t_chunk = next(c for c in (8, 5, 4, 2, 1) if n_steps % c == 0)
        step = build(args.scenario, n_envs=max(n_envs, mesh.size), n_steps=n_steps,
                     horizon=25, t_chunk=t_chunk, lr=args.lr, anneal_iters=args.iters,
                     device=device, mesh=mesh)
        state = step.init_state(step.init_params(init))
        for it in range(args.iters):
            state, m = step(state, it)
            if it % 10 == 0 or it == args.iters - 1:
                log(it, {"reward/step": m["mean_reward"], "entropy": m["entropy"]})
        params = state[0]
    elif args.algo in ("ppo", "mappo"):
        mw = 2 * env.spec.dim_p + 1
        if args.algo == "mappo":
            from mpe_tpu_torch.learner import build_mappo_step, init_mappo

            params = init_mappo(init, scn.obs_width, mw, env.n_agents)
            build = build_mappo_step
        else:
            from mpe_tpu_torch.learner import build_ppo_step, init_ac

            params = init_ac(init, scn.obs_width, mw)
            build = build_ppo_step
        step = build(env, n_envs=max(n_envs, mesh.size), n_steps=args.n_steps, lr=args.lr,
                     anneal_iters=args.iters, mesh=mesh)
        state = step.init_state(params_from_numpy(params, device=device))
        for it in range(args.iters):
            state, m = step(state, generator)
            if it % 10 == 0 or it == args.iters - 1:
                log(it, {"reward/step": m["mean_reward"], "entropy": m["entropy"]})
        params = state[0]
    else:
        params = params_from_numpy(init_policy(init, scn.obs_width, env.action_width),
                                   device=device)
        train = build_train_step(env, n_envs=n_envs, n_steps=args.n_steps, lr=args.lr,
                                 mesh=mesh)
        for it in range(args.iters):
            params, loss = train(params, generator)
            if it % 10 == 0 or it == args.iters - 1:
                log(it, {"loss": loss})

    g = greedy_eval(scn, args.algo, params, device=device)
    print(f"greedy eval: reward per agent-step {g:+.3f}")
    if args.save:
        from mpe_tpu_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(args.save, params, step=args.iters)
        print(f"saved params -> {args.save}")
    return {"algo": args.algo, "scenario": args.scenario, "iters": args.iters,
            "last": last, "greedy": g}


if __name__ == "__main__":
    main()
