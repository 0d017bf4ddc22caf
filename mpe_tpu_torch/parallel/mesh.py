"""Batched on-device rollout (PyTorch counterpart of
``mpe_tpu/parallel/mesh.py::build_rollout`` on a single device).

``build_rollout`` loops over steps in Python; every step is the batched env
step on the env's device, so there is no host round trip inside the loop
(the uniform actions and the auto-reset states are drawn on the device).
The multi-device functions of the JAX module (``env_mesh``,
``sharded_rollout``, ``init_multihost``) are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from mpe_tpu_torch.core.actions import ActionMode
from mpe_tpu_torch.envs.functional import MpeEnv


def _uniform_actions(env: MpeEnv, generator: torch.Generator, n_envs: int,
                     env_axis: int = 0) -> torch.Tensor:
    """Uniform random canonical actions ``[n_envs, A, W]`` (env-leading),
    or ``[A, W, n_envs]`` for ``env_axis=-1``: drawn in the canonical
    shape either way, so both layouts hold the same values."""
    shape = (n_envs, env.n_agents, env.action_width)
    kw = dict(generator=generator, device=env.device)
    if env.action_mode is ActionMode.DISCRETE_INDEX:
        # column 0 is the move index in [0, 5), column 1 the comm index in
        # [0, dim_c)
        move = torch.randint(0, 2 * env.spec.dim_p + 1, shape[:2] + (1,), dtype=torch.int32, **kw)
        comm = torch.randint(0, max(env.spec.dim_c, 1), shape[:2] + (1,), dtype=torch.int32, **kw)
        acts = torch.cat([move, comm], dim=-1)
    else:
        acts = torch.rand(shape, dtype=env.dtype, **kw)
    return acts if env_axis == 0 else acts.movedim(0, -1)


def build_rollout(
    env: MpeEnv,
    n_envs: int,
    n_steps: int,
    policy: Callable | None = None,
    return_trajectory: bool = False,
    env_axis: int = 0,
):
    """Build ``rollout(generator) -> (states, out)``.

    ``policy(obs, generator) -> actions`` defaults to uniform random
    actions. With ``return_trajectory`` the steps' (obs, actions, reward,
    done) are stacked on a leading time axis; otherwise ``out`` is the sum
    of all rewards (bench mode). ``env_axis`` is 0 (env-leading) or -1
    (env-minor) for the states, obs, actions and trajectory, as in the JAX
    package; the step itself always runs env-leading.
    """
    if env_axis not in (0, -1):
        raise ValueError(f"env_axis must be 0 or -1, got {env_axis}")

    def to_layout(x):
        return x if env_axis == 0 else x.movedim(0, -1)

    def from_layout(x):
        return x if env_axis == 0 else x.movedim(-1, 0)

    def rollout(generator: torch.Generator):
        states, obs = env.reset(n_envs, generator)
        traj = {"obs": [], "actions": [], "reward": [], "done": []}
        total = torch.zeros((), dtype=env.dtype, device=env.device)
        for _ in range(n_steps):
            if policy is None:
                actions = _uniform_actions(env, generator, n_envs, env_axis)
            else:
                actions = policy(to_layout(obs), generator)
            states, obs, rew, done, _ = env.step(states, from_layout(actions), generator)
            if return_trajectory:
                for k, v in (("obs", obs), ("actions", actions), ("reward", rew), ("done", done)):
                    traj[k].append(v if k == "actions" else to_layout(v))
            else:
                total = total + rew.sum()
        out = ({k: torch.stack(v) for k, v in traj.items()} if return_trajectory else total)
        return states.map(to_layout), out

    return rollout
