"""Policy evaluation on the fused engine: env + MLP inference + Gumbel-max
sampling in one kernel (K4 on the card; counterpart of
``examples/evaluate_policy.py``).

    python -m mpe_tpu_torch.examples.evaluate_policy --scenario simple_tag --n-envs 4096

Evaluate a policy trained by ``train`` (the REINFORCE head, the
architecture the kernel runs) instead of a random-init one:

    python -m mpe_tpu_torch.examples.train --scenario simple --iters 150 --save p.npz
    python -m mpe_tpu_torch.examples.evaluate_policy --scenario simple --load p.npz
"""

import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="simple_spread")
    ap.add_argument("--n-envs", type=int, default=1024)
    ap.add_argument("--n-steps", type=int, default=500)
    ap.add_argument("--horizon", type=int, default=100)
    ap.add_argument("--hidden", type=int, default=64,
                    help="MLP width (must match the checkpoint's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--load", default=None, metavar="PATH",
                    help="npz checkpoint from train --algo reinforce --save, of "
                         "either package (must match this scenario's obs/action "
                         "widths)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from mpe_tpu_torch import resolve_device
    from mpe_tpu_torch._device import to_host
    from mpe_tpu_torch.convert import params_from_numpy
    from mpe_tpu_torch.learner import init_policy
    from mpe_tpu_torch.ops.fused_policy import fused_policy_rollout
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    device = resolve_device(args.device)
    k = kernel_scenario(args.scenario)
    dim_c = k.spec.dim_c if k.uses_comm else 0
    params = init_policy(torch.Generator().manual_seed(0), k.obs_w, 5 + dim_c,
                         hidden=args.hidden)
    step = None
    if args.load:
        from mpe_tpu_torch.utils.checkpoint import load_checkpoint

        # the template mirrors the saved {'state': ...} payload
        payload, step, _ = load_checkpoint(args.load, {"state": params})
        loaded = payload["state"]
        for name, layer in params.items():   # width compatibility check
            if loaded[name]["w"].shape != layer["w"].shape:
                raise ValueError(
                    f"checkpoint layer {name!r}: {tuple(loaded[name]['w'].shape)} vs "
                    f"expected {tuple(layer['w'].shape)}: trained on a different "
                    "scenario or a non-REINFORCE head?")
        params = loaded
        print(f"loaded {args.load} (trained {step} iters)")
    params = params_from_numpy(params, device=device)
    run = fused_policy_rollout(k, params, n_envs=args.n_envs, n_steps=args.n_steps,
                               horizon=args.horizon, block_envs=min(1024, args.n_envs),
                               device=device)
    ret, pos, eps = run(0, params)
    eps = to_host(eps)
    per_ep = to_host(ret).sum(0) / np.maximum(eps[0], 1)
    print(f"{args.scenario}: mean return/episode "
          f"{per_ep.mean():+.2f} ± {per_ep.std():.2f} over "
          f"{int(eps.sum())} episodes")
    return {"scenario": args.scenario, "mean_return": float(per_ep.mean()),
            "std_return": float(per_ep.std()), "episodes": int(eps.sum()),
            "checkpoint_step": step}


if __name__ == "__main__":
    main()
