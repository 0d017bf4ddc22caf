"""Evolution-strategies training on the fused policy-evaluation kernel K4
(counterpart of ``examples/es_train.py``).

OpenAI-ES (Salimans et al. 2017): each generation draws antithetic
Gaussian perturbations of the policy, scores every member by rolling out
thousands of envs inside kernel K4 (obs -> MLP -> Gumbel-max sample ->
physics), one launch per member, and ascends the rank-weighted score
gradient. Common random numbers (the same kernel seed for all members of a
generation) cancel environment luck out of the member comparison.

    python -m mpe_tpu_torch.examples.es_train --scenario simple --gens 30
    python -m mpe_tpu_torch.examples.es_train --scenario simple_spread --pop 32 \\
        --n-envs 2048 --gens 100
"""

import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="simple")
    ap.add_argument("--gens", type=int, default=30)
    ap.add_argument("--pop", type=int, default=16)
    ap.add_argument("--sigma", type=float, default=0.05)
    ap.add_argument("--lr", type=float, default=0.03)
    ap.add_argument("--n-envs", type=int, default=1024)
    ap.add_argument("--n-steps", type=int, default=100)
    ap.add_argument("--horizon", type=int, default=25)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--save", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    import torch

    from mpe_tpu_torch import resolve_device
    from mpe_tpu_torch.convert import params_from_numpy
    from mpe_tpu_torch.learner import init_policy
    from mpe_tpu_torch.learner.es import build_es_step
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    device = resolve_device(args.device)
    k = kernel_scenario(args.scenario)
    dim_c = k.spec.dim_c if k.uses_comm else 0
    params = params_from_numpy(init_policy(torch.Generator().manual_seed(0), k.obs_w,
                                           5 + dim_c, hidden=args.hidden), device=device)
    step = build_es_step(k, params, args.n_envs, args.n_steps, args.horizon, args.pop,
                         args.sigma, args.lr, device=device)
    scores = {}
    for g in range(args.gens):
        params, mean_score = step(params, g)
        if g % 5 == 0 or g == args.gens - 1:
            scores[g] = float(mean_score)
            print(f"gen {g:4d}  mean return/episode {scores[g]:+.3f}", flush=True)
    if args.save:
        from mpe_tpu_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(args.save, params, step=args.gens)
        print(f"saved params -> {args.save}")
    return {"scenario": args.scenario, "generations": args.gens, "pop": args.pop,
            "mean_return_by_generation": scores}


if __name__ == "__main__":
    main()
