"""Checkpoint / resume in the JAX package's format (counterpart of
``mpe_tpu/utils/checkpoint.py``).

A checkpoint is one ``.npz``: the leaves of the payload ``{"state": state,
["key": key]}`` as ``leaf_0 .. leaf_{n-1}`` in JAX's flatten order (dict
keys sorted, tuples and lists in order, a ``WorldState``'s fields in
order), and ``__meta__``, a JSON of ``treedef`` (the payload's structure as
JAX prints a ``PyTreeDef``), ``n_leaves``, ``step`` and ``extra``. So the
two packages read each other's files where the nodes are ones they share
(dicts, tuples, lists, ``None``, ``WorldState``): a JAX env snapshot or
params tree loads into the port and the port's into JAX. The port's own
nodes print under their own names, and JAX refuses files that hold them:
``optim.AdamState`` and ``PackedState`` as ``CustomNode(namedtuple[Name],
[...])``, the replay ``Buffer`` as ``CustomNode(mpe_tpu_torch.Buffer[(A, O,
K)], [data, ptr, size])``, a ``torch.Generator`` as
``CustomNode(torch.Generator[device], [state])``. Host numbers (an Adam
count, a ring pointer) are 0-d leaves and come back as Python numbers.

A loader compares the saved structure with its template's, not only the
leaf count: a renamed or reordered field keeps the count but would assign
arrays to the wrong leaves.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from mpe_tpu_torch.core.state import WorldState

_SCALARS = (bool, int, float, np.generic)


def _norm_path(path: str) -> str:
    # np.savez appends ".npz" when the extension is missing; normalize in
    # both directions so save("/tmp/p") / load("/tmp/p") agree
    path = os.fspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def _node(tree):
    """(printed head, children, rebuild(children)) of a node, or None for a
    leaf. The head is JAX's ``PyTreeDef`` print up to the children."""
    from mpe_tpu_torch.learner.maddpg import Buffer

    if tree is None:
        return "None", [], lambda _: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", keys), [tree[k] for k in keys], lambda ch: dict(zip(keys, ch))
    if isinstance(tree, WorldState):
        return ("CustomNode(WorldState[()], [", "])"), [tree.pos, tree.vel, tree.comm, tree.goal,
                                                        tree.t], lambda ch: WorldState(*ch)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = type(tree)
        return ((f"CustomNode(namedtuple[{cls.__name__}], [", "])"), list(tree),
                lambda ch: cls(*ch))
    if isinstance(tree, tuple):
        return ("(", ",)" if len(tree) == 1 else ")"), list(tree), tuple
    if isinstance(tree, list):
        return ("[", "]"), list(tree), list
    if isinstance(tree, Buffer):
        meta = (tree.n_agents, tree.obs_dim, tree.act_dim)
        return ((f"CustomNode(mpe_tpu_torch.Buffer[{meta}], [", "])"),
                [tree.data, tree.ptr, tree.size],
                lambda ch: Buffer(ch[0], ch[1], ch[2], *meta))
    if isinstance(tree, torch.Generator):
        dev = tree.device

        def rebuild(ch):
            gen = torch.Generator(device=dev)
            gen.set_state(torch.as_tensor(ch[0], dtype=torch.uint8).cpu())
            return gen

        return (f"CustomNode(torch.Generator[{dev}], [", "])"), [tree.get_state()], rebuild
    if isinstance(tree, (torch.Tensor, np.ndarray) + _SCALARS):
        return None
    raise TypeError(f"a checkpoint cannot hold a {type(tree).__name__}")


def _print(tree, leaves: list | None = None) -> str:
    """JAX's print of ``tree``'s structure; appends its leaves to ``leaves``."""
    node = _node(tree)
    if node is None:
        if leaves is not None:
            leaves.append(tree)
        return "*"
    head, children, _ = node
    if head == "None":
        return head
    if head[0] == "dict":
        return "{" + ", ".join(f"{k!r}: {_print(c, leaves)}"
                               for k, c in zip(head[1], children)) + "}"
    return head[0] + ", ".join(_print(c, leaves) for c in children) + head[1]


def treedef(tree) -> str:
    """``tree``'s structure as ``str(jax.tree.structure(tree))`` prints it."""
    return f"PyTreeDef({_print(tree)})"


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fill(like, it):
    """A tree shaped like ``like`` with the leaves of ``it``: a tensor leaf
    takes the saved array on the template's device, a Python number the
    saved value, a numpy leaf the array."""
    node = _node(like)
    if node is None:
        arr = next(it)
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(like.device)
        if isinstance(like, _SCALARS) and not isinstance(like, np.generic):
            return type(like)(arr.item())
        return arr
    _, children, rebuild = node
    return rebuild([_fill(c, it) for c in children])


def save_checkpoint(path: str, state, key=None, step: int | None = None,
                    extra: dict | None = None) -> None:
    """Snapshot (state tree, key, step count) to ``path`` (.npz)."""
    path = _norm_path(path)
    payload = {"state": state}
    if key is not None:
        payload["key"] = key
    leaves: list = []
    structure = f"PyTreeDef({_print(payload, leaves)})"
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    meta = {"treedef": structure, "n_leaves": len(leaves), "step": step, "extra": extra or {}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def read_checkpoint(path: str) -> tuple[dict, list[np.ndarray]]:
    """(meta, leaves) of a checkpoint of either package, with numpy alone."""
    with np.load(_norm_path(path), allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        leaves = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    return meta, leaves


def load_checkpoint(path: str, like) -> tuple:
    """Load a snapshot. ``like`` has the structure of the saved ``{"state":
    ..., ["key": ...]}`` payload (e.g. a freshly reset state); returns
    ``(payload, step, extra)``. Raise ``ValueError`` when the saved
    structure is not the template's."""
    meta, leaves = read_checkpoint(path)
    structure = treedef(like)
    if meta["treedef"] != structure:
        raise ValueError("checkpoint structure mismatch:\n"
                         f"  saved:    {meta['treedef']}\n"
                         f"  template: {structure}")
    return _fill(like, iter(leaves)), meta["step"], meta["extra"]


def save_train_state(path: str, train_state, step: int | None = None,
                     extra: dict | None = None) -> None:
    """Snapshot a whole training state mid-run: any tree of the nodes above,
    e.g. MADDPG's ``{"params", "targets", "opt_states", "buffer"}`` or PPO's
    ``(params, opt_state)``. Loading it with ``load_train_state`` and going
    on with the same seeds repeats the interrupted run bit for bit."""
    save_checkpoint(path, train_state, step=step, extra=extra)


def load_train_state(path: str, like) -> tuple:
    """Load a training-state snapshot into the structure of ``like`` (e.g. a
    freshly initialized train state) -> ``(train_state, step, extra)``."""
    payload, step, extra = load_checkpoint(path, {"state": like})
    return payload["state"], step, extra
