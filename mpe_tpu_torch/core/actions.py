"""Batched action decoding (PyTorch counterpart of ``mpe_tpu/core/actions.py``).

Replicates ``MultiAgentEnv._set_action`` (reference environment.py:144-192)
on a canonical padded action layout with any number of leading batch axes:

  DISCRETE       [..., A, 5 + C] -- one-hot-ish move 5-vector, then comm;
                 u[0] = a[1] - a[2]; u[1] = a[3] - a[4] (environment.py:174-175)
  CONTINUOUS     [..., A, P + C] -- raw force vector, then comm
  DISCRETE_INDEX [..., A, 2] int -- (move index, comm index); move 0=noop,
                 1=-x, 2=+x, 3=-y, 4=+y. Index 1 is -x here while one-hot
                 entry 1 is +x: the reference's quirk, kept.

The move part is scaled by ``accel`` (5.0 when unset), zeroed for
non-movable agents; the comm part is zeroed for silent agents.
``force_discrete_action`` argmax-quantizes the move part first
(environment.py:169-172).
"""

from __future__ import annotations

import enum

import torch

from mpe_tpu_torch._device import device_table
from mpe_tpu_torch.core.state import ScenarioSpec


class ActionMode(enum.Enum):
    DISCRETE = "discrete"
    CONTINUOUS = "continuous"
    DISCRETE_INDEX = "discrete_index"


def action_width(spec: ScenarioSpec, mode: ActionMode) -> int:
    """Width of one canonical action row."""
    if mode is ActionMode.DISCRETE:
        return 2 * spec.dim_p + 1 + spec.dim_c
    if mode is ActionMode.CONTINUOUS:
        return spec.dim_p + spec.dim_c
    return 2


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an out-of-range index gives an all-zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def decode_actions(
    spec: ScenarioSpec,
    actions: torch.Tensor,
    mode: ActionMode = ActionMode.DISCRETE,
    dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Canonical ``[..., A, W]`` actions -> (u ``[..., A, P]``, c ``[..., A, C]``)."""
    a, p, dc = spec.n_agents, spec.dim_p, spec.dim_c
    dev = actions.device
    movable = device_table(spec.movable[:a], dtype, dev)[:, None]
    silent = device_table(spec.silent, device=dev)[:, None]
    sensitivity = device_table(spec.accel, dtype, dev)[:, None]

    if mode is ActionMode.DISCRETE_INDEX:
        actions = actions.to(torch.int32)
        move_idx = actions[..., 0]
        ux = (move_idx == 2).to(dtype) - (move_idx == 1).to(dtype)
        uy = (move_idx == 4).to(dtype) - (move_idx == 3).to(dtype)
        u = torch.stack([ux, uy], dim=-1)
        c = _one_hot(actions[..., 1], dc, dtype)
    else:
        actions = actions.to(dtype)
        if mode is ActionMode.DISCRETE:
            move = actions[..., : 2 * p + 1]
            if spec.force_discrete_action:
                move = _one_hot(move.argmax(-1), 2 * p + 1, dtype)
            u = move[..., 1::2] - move[..., 2::2]
            c = actions[..., 2 * p + 1:]
        else:
            move = actions[..., :p]
            if spec.force_discrete_action:
                move = _one_hot(move.argmax(-1), p, dtype)
            u = move
            c = actions[..., p:]

    u = u * sensitivity * movable
    c = torch.where(silent, torch.zeros((), dtype=dtype, device=dev), c)
    return u, c
