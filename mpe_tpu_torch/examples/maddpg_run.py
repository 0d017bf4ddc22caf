"""Fully fused MADDPG convergence runs (counterpart of
``examples/maddpg_run.py``).

The update:transition ratio of the reference result (1 update per n_envs
transitions, actor gated to every 2nd update after a 1000-update critic
warmup; tau 0.01, batch 1024, lr 1e-3, 24k updates) on the fused loop
(``learner.fused_loop``): replay chunks collected by kernel K8, each
chunk's updates by K9 on a packed state.

Prints progress per block and a final JSON line with the greedy
evaluation: aggregate + per-agent rewards (the per-role breakdown is
the meaningful read-out on competitive scenarios), a uniform-random
baseline, and on comm scenarios a muted-speaker ablation (comm head
forced to zeros at eval) showing how much of the reward rides the
learned communication channel.

    python -m mpe_tpu_torch.examples.maddpg_run --scenario simple_spread --updates 24000
    python -m mpe_tpu_torch.examples.maddpg_run --scenario simple_speaker_listener \\
        --updates 24000 --save sl.npz
"""

import argparse
import json


def greedy_eval(scn, params, n_envs=128, n_steps=25, seed=123, mute_comm=False,
                per_agent=False, device=None):
    """Reward per agent-step of the argmax policy (no exploration), rolled
    out on ``device``. ``mute_comm`` zeroes the comm head (the
    communication ablation); ``per_agent`` also returns the per-agent
    breakdown; ``params=None`` rolls out uniform-random actions (the
    untrained baseline)."""
    from mpe_tpu_torch.learner.eval import greedy_state_rollout

    _, rew = greedy_state_rollout(scn, params, n_envs=n_envs, n_steps=n_steps, seed=seed,
                                  mute_comm=mute_comm, device=device)
    per = rew.sum(axis=(0, 1)) / (n_envs * n_steps)       # [A]
    if not per_agent:
        return float(per.mean())
    return float(per.mean()), [round(float(x), 4) for x in per]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="simple_spread")
    ap.add_argument("--updates", type=int, default=24_000)
    ap.add_argument("--n-envs", type=int, default=64)
    ap.add_argument("--horizon", type=int, default=25)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--tau", type=float, default=0.01)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ent-coef", type=float, default=0.01)
    ap.add_argument("--eps", type=float, default=0.1)
    ap.add_argument("--actor-start", type=int, default=1000)
    ap.add_argument("--actor-period", default=None,
                    help="comma-separated per-agent actor periods for "
                         "two-timescale schedules, e.g. '1,1,4' "
                         "(default: every agent on every actor-gated update)")
    ap.add_argument("--block", type=int, default=40,
                    help="chunks between progress lines")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--save", default=None)
    args = ap.parse_args(argv)

    from mpe_tpu_torch import resolve_device, scenarios
    from mpe_tpu_torch.envs import MpeEnv
    from mpe_tpu_torch.learner.fused_loop import run_fused_maddpg
    from mpe_tpu_torch.learner.maddpg import maddpg_act_dim

    device = resolve_device(args.device)

    def progress(done, total, mr, cl):
        print(f"chunk {done:5d}/{total}  updates {done * args.horizon:6d}"
              f"  reward/step {mr:+.3f}  critic_loss {cl:.3f}", flush=True)

    params, info = run_fused_maddpg(
        args.scenario, updates=args.updates, n_envs=args.n_envs, horizon=args.horizon,
        batch=args.batch, tau=args.tau, lr=args.lr, ent_coef=args.ent_coef, eps=args.eps,
        actor_start=args.actor_start, block=args.block, seed=args.seed,
        actor_period=(None if args.actor_period is None else
                      tuple(int(p) for p in args.actor_period.split(","))),
        progress=progress, device=device)
    result = {k: info[k] for k in ("scenario", "updates", "n_envs", "batch", "tau", "lr",
                                   "seed", "actor_period")}

    scn = scenarios.load(args.scenario)
    env = MpeEnv(scn, device=device)
    aw = maddpg_act_dim(env)
    greedy, greedy_pa = greedy_eval(scn, params, per_agent=True, device=device)
    _, random_pa = greedy_eval(scn, None, per_agent=True, device=device)
    result.update(greedy=greedy, greedy_per_agent=greedy_pa, random_per_agent=random_pa)
    if aw > 2 * env.spec.dim_p + 1:
        muted, muted_pa = greedy_eval(scn, params, mute_comm=True, per_agent=True,
                                      device=device)
        result["greedy_muted_comm"] = muted
        result["greedy_muted_per_agent"] = muted_pa
    if args.save:
        from mpe_tpu_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(args.save, params, step=result["updates"])
        result["checkpoint"] = args.save
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
