"""Greedy (argmax) policy evaluation with role-aware diagnostics
(counterpart of ``mpe_tpu/learner/eval.py``).

The reference repo has no evaluation tooling at all (SURVEY.md §4); the
MADDPG paper's headline scenarios are *competitive*, where the aggregate
reward of a trained population is near zero by construction and the
meaningful read-outs are per-role. This module has the shared machinery:

  - ``build_greedy_policy``: argmax two-head (move + comm) policy over
    MADDPG actor params, with eval-time ablations — ``mute_comm`` zeroes
    the comm head (the speaker ablation), ``obs_mask`` zeroes chosen
    observation columns per agent (key ablation in crypto, leader-comm
    blinding in world_comm).
  - ``greedy_state_rollout``: a rollout on the batched generic engine that
    stacks the FULL ``WorldState`` per step, so metrics can read
    positions/utterances/goals directly instead of inferring them from
    rewards.
"""

from __future__ import annotations

import numpy as np
import torch

from mpe_tpu_torch._device import make_generator
from mpe_tpu_torch.envs.functional import MpeEnv
from mpe_tpu_torch.learner.maddpg import actor_logits


def build_greedy_policy(env: MpeEnv, params, mute_comm: bool = False, obs_mask=None):
    """Argmax policy ``pol(obs [n, A, O], generator) -> actions [n, A, W]``
    (env-leading layout) over stacked-agent MADDPG actor params.

    ``obs_mask`` is an optional ``[A, O]`` 0/1 array multiplied into the
    observation before the actor — the generic eval-time information
    ablation (zeroed inputs are what the reference's obs functions emit
    for hidden entities, e.g. forest-hidden positions in
    simple_world_comm.py:231-261, so masked obs stay in-distribution).
    """
    mw = 2 * env.spec.dim_p + 1
    pad_c = env.action_width - mw
    if obs_mask is not None:
        obs_mask = torch.as_tensor(np.asarray(obs_mask), dtype=env.dtype, device=env.device)

    def pol(obs, generator=None):
        if obs_mask is not None:
            obs = obs * obs_mask
        logits = actor_logits(params["actor"], obs)
        parts = [torch.nn.functional.one_hot(logits[..., :mw].argmax(-1), mw).to(env.dtype)]
        cw = logits.shape[-1] - mw
        if cw:
            comm = torch.nn.functional.one_hot(logits[..., mw:].argmax(-1), cw).to(env.dtype)
            parts.append(torch.zeros_like(comm) if mute_comm else comm)
        elif pad_c:
            parts.append(parts[0].new_zeros(parts[0].shape[:-1] + (pad_c,)))
        return torch.cat(parts, dim=-1)

    return pol


def greedy_state_rollout(scn, params, n_envs: int = 128, n_steps: int = 25, seed: int = 123,
                         mute_comm: bool = False, obs_mask=None, device=None):
    """Roll the argmax policy (uniform-random actions when ``params`` is
    None) on ``device`` and return ``(states, rew)`` as numpy, every
    ``states`` leaf stacked over time — ``pos [T, n, E, P]``, ``comm [T, n,
    A, C]``, ``goal [T, n, G]`` — and ``rew`` ``[T, n, A]``."""
    from mpe_tpu_torch.parallel.mesh import _uniform_actions

    env = MpeEnv(scn, device=device)
    pol = None if params is None else build_greedy_policy(env, params, mute_comm, obs_mask)
    generator = make_generator(seed, env.device)
    with torch.no_grad():
        states, obs = env.reset(n_envs, generator)
        traj, rews = [], []
        for _ in range(n_steps):
            actions = (_uniform_actions(env, generator, n_envs) if pol is None
                       else pol(obs, generator))
            states, obs, rew, _, _ = env.step(states, actions, generator)
            traj.append(states)
            rews.append(rew)
    stacked = traj[0].map(lambda *xs: torch.stack(xs).cpu().numpy(), *traj[1:])
    return stacked, torch.stack(rews).cpu().numpy()
