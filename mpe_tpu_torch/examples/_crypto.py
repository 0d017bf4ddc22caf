"""The covert-communication read-outs of simple_crypto (the port's own copy
of what ``examples/crypto_demo.py`` takes from ``tools/crypto_study.py``).

The game: Alice sees a goal color (one-hot over the 2 landmarks, embedded
in a dim_c=4 channel) and a random one-hot key shared with Bob; she
broadcasts a 4-wide message. Alice/Bob are rewarded when Bob's utterance
reconstructs the goal and eavesdropper Eve's does not. Under greedy
(argmax) evaluation:

  bob_err / eve_err      mean ||c - goal||^2 over the utterances (one-hot
                         outputs: 0 if right, 2 if wrong; chance for a
                         goal-blind guesser is 1.0)
  bob_err_keyless        Bob's error with his key observation zeroed: if
                         Bob uses the key, blinding it pushes him to chance
  alice_plaintext_frac   fraction of (goal, key) pairs where Alice's
                         message equals the raw goal color
  key_changes_msg_frac   fraction of goals where Alice's message differs
                         between the two key values
  eve_best_response_err  expected ||c-goal||^2 of an optimal eavesdropper
                         on Alice's codebook (1.0 = perfectly secure)
  bob_best_response_err  the same for an optimal key-holding decoder
                         (0.0 = decodable)
"""

from __future__ import annotations

import numpy as np

EVE, BOB, ALICE = 0, 1, 2


def best_response_errs(codebook):
    """Exact optimal-decoder errors from Alice's deterministic codebook
    ``{"goal{g}_key{k}": msg}`` with goal, key ~ U{0,1} -> ``(bob, eve)``.

    An optimal decoder outputs the one-hot of its posterior argmax over
    the 2 goal colors; each wrong guess costs ||e_i - e_j||^2 = 2, so
    the expected error is 2 * P(argmax posterior is wrong). Eve
    conditions on the message only; Bob on (message, key)."""
    pairs = [(g, k, codebook[f"goal{g}_key{k}"]) for g in range(2) for k in range(2)]

    def err(cond):
        # group the 4 equiprobable (g, k) worlds by the decoder's view
        groups = {}
        for g, k, m in pairs:
            groups.setdefault(cond(k, m), []).append(g)
        # per group: best guess = majority goal; wrong worlds cost 2
        wrong = sum(len(gs) - max(gs.count(0), gs.count(1)) for gs in groups.values())
        return 2 * wrong / len(pairs)

    return err(lambda k, m: (k, m)), err(lambda k, m: m)   # bob, eve


def codebook_pairs() -> list[tuple[int, int]]:
    return [(g, k) for g in range(2) for k in range(2)]


def alice_logits(scn, params, device=None):
    """Alice's actor logits ``[4, K]`` on the host for the four (goal, key)
    observations, in ``codebook_pairs`` order. Alice's obs = [goal_color(4),
    key_color(4)], zero-padded to obs_width; the move logits come first."""
    import torch

    from mpe_tpu_torch import resolve_device
    from mpe_tpu_torch._device import to_host
    from mpe_tpu_torch.learner.maddpg import actor_logits_i

    dim_c = scn.spec.dim_c
    pairs = codebook_pairs()
    obs = np.zeros((len(pairs), scn.obs_width), np.float32)
    for r, (g, k) in enumerate(pairs):
        obs[r, g] = 1.0
        obs[r, dim_c + k] = 1.0
    alice = {q: {w: x[ALICE] for w, x in layer.items()} for q, layer in params["actor"].items()}
    with torch.no_grad():
        return to_host(actor_logits_i(alice, torch.as_tensor(obs, device=resolve_device(device))))


def eval_seed(scn, params, n_envs=512, seed=123, device=None):
    """The read-outs above for one trained population (``params`` on
    ``device``), from greedy rollouts on the generic engine."""
    from mpe_tpu_torch.learner.eval import greedy_state_rollout

    dim_c = scn.spec.dim_c

    def errs(states):
        comm = states.comm[1:]                     # [T-1, n, A, 4]; step 0
        goal = states.goal[1:, :, 0]               # utterances are zeros
        goal_c = np.eye(dim_c, dtype=comm.dtype)[goal]      # [T-1, n, 4]

        def e(i):
            return float(np.sum(np.square(comm[:, :, i] - goal_c), -1).mean())

        return e(BOB), e(EVE)

    states, _ = greedy_state_rollout(scn, params, n_envs=n_envs, seed=seed, device=device)
    bob_err, eve_err = errs(states)

    # key ablation: zero Bob's key input (obs cols 0:4 of agent 1)
    mask = np.ones((3, scn.obs_width), np.float32)
    mask[BOB, :dim_c] = 0.0
    states_k, _ = greedy_state_rollout(scn, params, n_envs=n_envs, seed=seed, obs_mask=mask,
                                       device=device)
    bob_err_keyless, _ = errs(states_k)

    mw = 2 * scn.spec.dim_p + 1
    pairs = codebook_pairs()
    msg = alice_logits(scn, params, device)[:, mw:].argmax(-1)   # [4]
    plaintext = float(np.mean([m == g for m, (g, _) in zip(msg, pairs)]))
    key_changes = float(np.mean([msg[2 * i] != msg[2 * i + 1] for i in range(2)]))
    codebook = {f"goal{g}_key{k}": int(m) for m, (g, k) in zip(msg, pairs)}
    bob_best, eve_best = best_response_errs(codebook)
    return {"bob_err": round(bob_err, 4), "eve_err": round(eve_err, 4),
            "bob_err_keyless": round(bob_err_keyless, 4),
            "alice_plaintext_frac": plaintext,
            "key_changes_msg_frac": key_changes,
            "bob_best_response_err": bob_best,
            "eve_best_response_err": eve_best,
            "alice_codebook": codebook}
