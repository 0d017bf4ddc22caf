"""Interactive / demo episode runner (counterpart of
``mpe_tpu/interactive_cli.py``).

Reference-equivalent CLI (reference bin/interactive.py:10-39): loads a
scenario, builds a per-agent-viewer env, and loops keyboard policies ->
``env.step`` -> ``env.render``. Extensions for headless machines:
``--steps`` bounds the loop (the reference loops forever), ``--headless``
swaps keyboard input for random policies, and ``--save-frames DIR`` writes
rendered rgb frames to disk (with PIL). The env runs on the card unless
``--device`` names another (``--device cpu``); without a card it raises.
Installed as the ``mpe-interactive-torch`` console script; run it as

    python -m mpe_tpu_torch.interactive_cli --scenario simple --steps 5 --headless
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=None)
    parser.add_argument("-s", "--scenario", default="simple.py",
                        help="scenario name (legacy .py suffix accepted)")
    parser.add_argument("--steps", type=int, default=0,
                        help="number of steps (0 = loop forever, like the reference)")
    parser.add_argument("--headless", action="store_true",
                        help="random policies instead of keyboard input")
    parser.add_argument("--save-frames", default=None, metavar="DIR",
                        help="save rgb_array frames to DIR (needs PIL)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="torch device of the env (default: the CUDA card; 'cpu' runs "
                             "the plain PyTorch path)")
    args = parser.parse_args(argv)

    from mpe_tpu_torch import make_env
    from mpe_tpu_torch.policy import InteractivePolicy, RandomPolicy

    # one viewer per agent, like the reference (interactive.py:21)
    env = make_env(args.scenario, seed=args.seed, shared_viewer=False, device=args.device)
    env.render()
    if args.headless:
        policies = [RandomPolicy(env, i, seed=args.seed) for i in range(env.n)]
    else:
        policies = [InteractivePolicy(env, i) for i in range(env.n)]

    obs_n = env.reset()
    t = 0
    while args.steps <= 0 or t < args.steps:
        act_n = [policy.action(obs_n[i]) for i, policy in enumerate(policies)]
        obs_n, reward_n, done_n, _ = env.step(act_n)
        frames = env.render("rgb_array" if args.save_frames else "human")
        if args.save_frames:
            from PIL import Image

            os.makedirs(args.save_frames, exist_ok=True)
            for v, frame in enumerate(frames):
                Image.fromarray(frame).save(
                    os.path.join(args.save_frames, f"t{t:05d}_v{v}.png"))
        if args.steps > 0:
            print(f"t={t} rewards={[round(r, 3) for r in reward_n]}")
        t += 1
    env.close()


if __name__ == "__main__":
    main()
