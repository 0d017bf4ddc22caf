"""Carry state between the JAX package and the port, as numpy arrays.

``state_from_numpy`` turns the leaves of a JAX ``WorldState`` (read out
with ``np.asarray``) into the port's env-leading ``WorldState``;
``state_to_numpy`` goes back. ``spec_fields`` lists a spec's tables so the
two packages' specs can be compared field by field. ``params_from_numpy``
and ``params_to_numpy`` carry learner parameters (nested dicts of arrays:
``{layer: {"w": [in, out], "b": [out]}}``, or MADDPG's ``{"actor" |
"critic": {layer: {"w", "b"}}}`` with a leading agent axis; the same layout
in both packages). ``read_checkpoint_params`` reads the params tree of a
checkpoint written by ``mpe_tpu/utils/checkpoint.py`` with numpy alone.
"""

from __future__ import annotations

import ast
import dataclasses
import json

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


def _map_tree(fn, tree):
    """``fn`` over the leaves of nested dicts."""
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def params_from_numpy(tree, device=None, dtype=torch.float32) -> dict:
    """A params tree of numpy arrays (nested dicts, e.g. a JAX ``init_ac``
    or ``init_maddpg`` read out with ``np.asarray``) -> the port's params."""
    device = resolve_device(device)
    return _map_tree(lambda x: torch.tensor(np.asarray(x), dtype=dtype, device=device), tree)


def params_to_numpy(params) -> dict:
    """The port's params -> the same tree of numpy arrays."""
    return _map_tree(lambda x: x.detach().cpu().numpy(), params)


def read_checkpoint_params(path) -> dict:
    """The params tree of an ``.npz`` checkpoint of the JAX package
    (``mpe_tpu/utils/checkpoint.py::save_checkpoint``), as numpy arrays.

    The file holds ``leaf_0 .. leaf_{n-1}`` and a ``__meta__`` JSON whose
    ``treedef`` is the printed structure of ``{"state": params}``; JAX
    flattens dicts in sorted-key order, so the leaves are assigned in that
    order. Only a tree of dicts of arrays is read (the rest of a training
    state waits for ROADMAP A11); anything else raises ``ValueError``."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        leaves = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    text = meta["treedef"]
    if not (text.startswith("PyTreeDef(") and text.endswith(")")):
        raise ValueError(f"not a printed JAX treedef: {text[:80]!r}")
    try:
        structure = ast.literal_eval(text[len("PyTreeDef("):-1].replace("*", "None"))
    except (ValueError, SyntaxError) as e:
        raise ValueError(f"the checkpoint's tree is not a tree of dicts: {text[:120]!r}") from e
    if not isinstance(structure, dict) or set(structure) != {"state"}:
        raise ValueError(f"expected a {{'state': params}} payload, got {text[:120]!r}")
    it = iter(leaves)

    def fill(node):
        if node is None:
            return next(it)
        if not isinstance(node, dict):
            raise ValueError(f"the checkpoint's tree is not a tree of dicts: {text[:120]!r}")
        return {k: fill(node[k]) for k in sorted(node)}

    params = fill(structure["state"])
    if next(it, None) is not None:
        raise ValueError(f"{meta['n_leaves']} leaves for a tree with fewer")
    return params
