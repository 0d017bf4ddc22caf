"""Batched rollout demo: the generic engine against the fused engine
(counterpart of ``examples/rollout.py``).

    python -m mpe_tpu_torch.examples.rollout --scenario simple_spread --n-envs 4096
    python -m mpe_tpu_torch.examples.rollout --fused        # kernel K2
"""

import argparse
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="simple_spread")
    ap.add_argument("--n-envs", type=int, default=4096)
    ap.add_argument("--n-steps", type=int, default=1000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--fused", action="store_true",
                    help="use the fused engine (kernel K2 on the card, its plain "
                         "version on the CPU)")
    args = ap.parse_args(argv)

    from mpe_tpu_torch import make_generator, resolve_device, scenarios
    from mpe_tpu_torch.envs import MpeEnv
    from mpe_tpu_torch.ops.fused_rollout import fused_rollout
    from mpe_tpu_torch.parallel import build_rollout

    device = resolve_device(args.device)
    if args.fused:
        run = fused_rollout(args.scenario, args.n_envs, args.n_steps, horizon=100,
                            block_envs=min(1024, args.n_envs), device=device)
        float(run(0)[2].sum())  # warm-up: the kernel's library loads at its first call
        t0 = time.perf_counter()
        rew = float(run(1)[2].sum())
        dt = time.perf_counter() - t0
    else:
        env = MpeEnv(scenarios.load(args.scenario), max_steps=100, auto_reset=True,
                     device=device)
        rollout = build_rollout(env, args.n_envs, args.n_steps, env_axis=-1)
        float(rollout(make_generator(0, device))[1])  # warm-up
        t0 = time.perf_counter()
        rew = float(rollout(make_generator(1, device))[1])
        dt = time.perf_counter() - t0
    steps = args.n_envs * args.n_steps
    print(f"{args.scenario}: {steps/dt/1e6:.1f} M env-steps/s "
          f"(reward sum {rew:.1f})")
    return {"scenario": args.scenario, "engine": "fused" if args.fused else "generic",
            "env_steps": steps, "seconds": dt, "env_steps_per_s": steps / dt,
            "reward_sum": rew}


if __name__ == "__main__":
    main()
