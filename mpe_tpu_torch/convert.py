"""Carry state between the JAX package and the port, as numpy arrays.

``state_from_numpy`` turns the leaves of a JAX ``WorldState`` (read out
with ``np.asarray``) into the port's env-leading ``WorldState``;
``state_to_numpy`` goes back. ``spec_fields`` lists a spec's tables so the
two packages' specs can be compared field by field. ``params_from_numpy``
and ``params_to_numpy`` carry learner parameters (``{layer: {"w": [in, out],
"b": [out]}}``, the same layout in both packages).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpe_tpu_torch._device import resolve_device
from mpe_tpu_torch.core.state import WorldState


def state_from_numpy(pos, vel, comm, goal, t, *, env_axis: int = 0,
                     device=None) -> WorldState:
    """Batched state from numpy leaves laid out with the env axis at
    ``env_axis`` (0, or -1 for the env-minor layout of
    ``build_rollout(env_axis=-1)``). Float leaves keep their dtype."""
    if env_axis not in (0, -1):
        raise ValueError(f"env_axis must be 0 or -1, got {env_axis}")
    device = resolve_device(device)

    def leaf(x):
        x = np.asarray(x)
        return torch.tensor(x if env_axis == 0 else np.moveaxis(x, -1, 0), device=device)

    return WorldState(pos=leaf(pos), vel=leaf(vel), comm=leaf(comm),
                      goal=leaf(goal).to(torch.int32), t=leaf(t).to(torch.int32))


def state_to_numpy(state: WorldState, env_axis: int = 0) -> tuple[np.ndarray, ...]:
    """(pos, vel, comm, goal, t) as numpy, env axis at ``env_axis``."""
    if env_axis not in (0, -1):
        raise ValueError(f"env_axis must be 0 or -1, got {env_axis}")
    leaves = (state.pos, state.vel, state.comm, state.goal, state.t)
    out = tuple(x.detach().cpu().numpy() for x in leaves)
    return out if env_axis == 0 else tuple(np.moveaxis(x, 0, -1) for x in out)


def spec_fields(spec) -> dict:
    """A spec's fields (either package's ``ScenarioSpec``) as a dict."""
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}


def params_from_numpy(tree, device=None, dtype=torch.float32) -> dict:
    """A params pytree of numpy arrays (``{layer: {"w", "b"}}``, e.g. a JAX
    ``init_ac`` read out with ``np.asarray``) -> the port's params."""
    device = resolve_device(device)
    return {k: {q: torch.tensor(np.asarray(x), dtype=dtype, device=device)
                for q, x in layer.items()} for k, layer in tree.items()}


def params_to_numpy(params) -> dict:
    """The port's params -> the same tree of numpy arrays."""
    return {k: {q: x.detach().cpu().numpy() for q, x in layer.items()}
            for k, layer in params.items()}
