"""Demonstrate a committed covert-communication policy (counterpart of
``examples/crypto_demo.py``): load a simple_crypto MADDPG checkpoint, print
Alice's codebook, and roll a few greedy episodes showing the message each
party reads.

    python -m mpe_tpu_torch.examples.crypto_demo
    python -m mpe_tpu_torch.examples.crypto_demo \\
        --checkpoint checkpoints/crypto_pbt_grace0_repro_s9_m3.npz
"""

import argparse
import os

DEFAULT_CHECKPOINT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "checkpoints", "crypto_pbt_grace_repro_s2_m5.npz")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=DEFAULT_CHECKPOINT)
    ap.add_argument("--episodes", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from mpe_tpu_torch import resolve_device, scenarios
    from mpe_tpu_torch.convert import params_from_numpy
    from mpe_tpu_torch.envs import MpeEnv
    from mpe_tpu_torch.examples._crypto import (ALICE, BOB, EVE, alice_logits,
                                                best_response_errs, eval_seed)
    from mpe_tpu_torch.learner.eval import greedy_state_rollout
    from mpe_tpu_torch.learner.maddpg import init_maddpg, maddpg_act_dim
    from mpe_tpu_torch.utils.checkpoint import load_checkpoint

    device = resolve_device(args.device)
    scn = scenarios.load("simple_crypto")
    env = MpeEnv(scn, device=device)
    like = {"state": init_maddpg(torch.Generator().manual_seed(0), scn.obs_width,
                                 maddpg_act_dim(env), env.n_agents)}
    params = params_from_numpy(load_checkpoint(args.checkpoint, like)[0]["state"],
                               device=device)

    r = eval_seed(scn, params, n_envs=256, device=device)
    cb = r["alice_codebook"]
    bob_best, eve_best = best_response_errs(cb)
    print(f"checkpoint: {args.checkpoint}\n")
    print("Alice's codebook  msg(goal, key):")
    for g in range(2):
        for k in range(2):
            print(f"  goal={g} key={k}  ->  msg={cb[f'goal{g}_key{k}']}")
    xor = all(cb[f"goal{g}_key{k}"] == cb[f"goal{1-g}_key{1-k}"]
              for g in range(2) for k in range(2))
    print(f"\nXOR-structured: {xor}"
          f"   optimal-eavesdropper err: {eve_best} (1.0 = secure)"
          f"   key-holding-decoder err: {bob_best} (0.0 = decodable)")
    print(f"trained Bob err: {r['bob_err']}   "
          f"Bob err with the key blinded: {r['bob_err_keyless']} "
          f"(chance = 1.0)")
    # how far the codebook is from a tie: the smallest margin of Alice's
    # chosen message over her next-best one
    top2 = np.sort(alice_logits(scn, params, device)[:, 2 * scn.spec.dim_p + 1:], -1)[:, -2:]
    gap = float((top2[:, 1] - top2[:, 0]).min())
    print(f"smallest gap between Alice's top two message logits: {gap:.4g}\n")

    # a few greedy episodes: who says what, who understands
    states, _ = greedy_state_rollout(scn, params, n_envs=args.episodes, n_steps=3, seed=7,
                                     device=device)
    comm = np.asarray(states.comm[-1])           # [n, A, 4] settled
    goal = np.asarray(states.goal[-1, :, 0])
    print("episodes (settled utterances; msg = argmax of the channel):")
    episodes = []
    for e in range(args.episodes):
        a_msg, b_msg, e_msg = (int(np.argmax(comm[e, i])) for i in (ALICE, BOB, EVE))
        episodes.append({"goal": int(goal[e]), "alice": a_msg, "bob": b_msg, "eve": e_msg})
        print(f"  goal={goal[e]}  alice says {a_msg}  |  "
              f"bob decodes -> {b_msg} "
              f"{'OK' if b_msg == goal[e] else 'WRONG'}  |  "
              f"eve guesses -> {e_msg} "
              f"{'(cracked)' if e_msg == goal[e] else '(fooled)'}")
    return {**r, "xor": xor, "alice_logit_gap": gap, "episodes": episodes}


if __name__ == "__main__":
    main()
