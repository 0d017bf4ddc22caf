"""Render a trained MADDPG policy headless (counterpart of
``examples/render_policy.py``).

Loads a checkpoint of either package (``maddpg_run --save``, ``train
--save``, or the JAX package's ``checkpoints/maddpg_*.npz``), rolls greedy
(argmax) episodes through the stateful env, and renders the frames with the
numpy rasterizer; ``--out`` writes them as an animated GIF (PIL), e.g. the
trained speaker/listener pair navigating by communication:

    python -m mpe_tpu_torch.examples.render_policy --scenario simple_speaker_listener \\
        --checkpoint checkpoints/maddpg_speaker_listener.npz --out speaker_listener.gif
"""

import argparse


def greedy_policy(env, params, mute_comm: bool = False):
    """Greedy ragged reference-format actions from the per-agent actors
    (``learner.maddpg.actor_logits_i``): a move one-hot iff movable, a comm
    one-hot iff speaking. ``policy(obs_n) -> action_n``; one copy of the obs
    rows to the device and one of the logits back per step."""
    import numpy as np
    import torch

    from mpe_tpu_torch._device import to_host
    from mpe_tpu_torch.learner.maddpg import actor_logits_i

    spec = env.world_spec
    mw = 2 * spec.dim_p + 1
    ow = env.scenario.obs_width
    actors = [{q: {w: x[i] for w, x in layer.items()} for q, layer in params["actor"].items()}
              for i in range(spec.n_agents)]
    cw = actors[0]["out"]["w"].shape[-1] - mw
    device = params["actor"]["l1"]["w"].device

    def policy(obs_n):
        # actors train on width-padded obs rows (trailing zeros)
        rows = np.zeros((spec.n_agents, ow), np.float32)
        for i, o in enumerate(obs_n):
            rows[i, :len(o)] = np.asarray(o, np.float32)
        rows = torch.as_tensor(rows, device=device)
        logits = to_host(torch.stack([actor_logits_i(p, rows[i]) for i, p in enumerate(actors)]))
        acts = []
        for i in range(spec.n_agents):
            segs = []
            if spec.movable[i]:
                mv = np.zeros(mw)
                mv[int(np.argmax(logits[i, :mw]))] = 1.0
                segs.append(mv)
            if not spec.silent[i]:
                cm = np.zeros(spec.dim_c)
                if cw and not mute_comm:
                    cm[int(np.argmax(logits[i, mw:]))] = 1.0
                segs.append(cm)
            acts.append(np.concatenate(segs))
        return acts

    return policy


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="simple_speaker_listener")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--out", default=None,
                    help="write the frames to this GIF (needs PIL); without it they are "
                         "rendered and counted only")
    ap.add_argument("--episodes", type=int, default=3)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mute-comm", action="store_true",
                    help="zero the comm head (the ablation, visibly worse on comm "
                         "scenarios)")
    ap.add_argument("--device", default=None,
                    help="torch device of the env and the actors (default: the CUDA card)")
    args = ap.parse_args(argv)
    import torch

    from mpe_tpu_torch import make_env, resolve_device
    from mpe_tpu_torch.convert import params_from_numpy
    from mpe_tpu_torch.learner.maddpg import init_maddpg, maddpg_act_dim
    from mpe_tpu_torch.render.video import record_episode, save_gif
    from mpe_tpu_torch.utils.checkpoint import load_checkpoint

    device = resolve_device(args.device)
    env = make_env(args.scenario, seed=args.seed, device=device)
    like = init_maddpg(torch.Generator().manual_seed(0), env.scenario.obs_width,
                       maddpg_act_dim(env.env), env.n)
    payload, step, _ = load_checkpoint(args.checkpoint, {"state": like})
    params = params_from_numpy(payload["state"], device=device)
    policy = greedy_policy(env, params, args.mute_comm)

    frames = []
    for _ in range(args.episodes):
        frames += record_episode(env, n_steps=args.steps, policy=policy)
        env.reset()
    if args.out:
        save_gif(frames, args.out)
        print(f"{len(frames)} frames (ckpt step {step}) -> {args.out}")
    else:
        print(f"{len(frames)} frames (ckpt step {step})")
    return {"scenario": args.scenario, "frames": len(frames), "checkpoint_step": step,
            "frame_shape": tuple(frames[0].shape), "out": args.out}


if __name__ == "__main__":
    main()
