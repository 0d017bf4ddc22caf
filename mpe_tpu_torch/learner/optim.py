"""The trainers' optimizers, written with optax's formulas in optax's order
so that the port can be held to them at 1e-12 in float64: the PPO
trainers' ``optax.chain(clip_by_global_norm(max_norm), adam(learning_rate))``
(``clip_adam``) and MADDPG's plain ``optax.adam(learning_rate)`` (``adam``):

- the global norm is ``sqrt`` of the sum over leaves (sorted keys) of each
  leaf's sum of squares, and the clip is ``where(norm < max_norm, g,
  g / norm * max_norm)``;
- Adam computes ``mu``, then ``nu``, increments its count, divides each by
  ``1 - b**count`` (computed in double, then cast) and returns
  ``mu_hat / (sqrt(nu_hat) + eps)``;
- the step is ``-lr * update``; a schedule is read at its own count, which
  starts at 0 and counts ``update`` calls, and is cast to the update's type.

``torch.optim.Adam`` rounds differently (it divides ``sqrt(nu)`` by
``sqrt(1 - b2**count)`` before adding eps) and is kept off this path.
Params and gradients are two-level dicts of tensors (``{layer: {w, b}}``);
the counts are host integers, so nothing here waits for the device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


def tree_map(fn, *trees):
    """``fn`` over the leaves of two-level dicts of the same structure."""
    return {k: {q: fn(*(t[k][q] for t in trees)) for q in trees[0][k]} for k in trees[0]}


def tree_leaves(tree) -> list[torch.Tensor]:
    """Leaves in JAX's flattening order (sorted keys at each level)."""
    return [tree[k][q] for k in sorted(tree) for q in sorted(tree[k])]


def tree_unflatten(like, leaves):
    """Leaves in ``tree_leaves`` order -> a two-level dict shaped like ``like``."""
    it = iter(leaves)
    return {k: {q: next(it) for q in sorted(like[k])} for k in sorted(like)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x * x) for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    trigger = norm < max_norm
    return tree_map(lambda g: torch.where(trigger, g, g / norm.to(g.dtype) * max_norm), grads)


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Callable:
    """``optax.linear_schedule``: ``init`` to ``end`` over ``transition_steps``
    update counts, then held. optax computes it in float32 (an int32 count
    over an int), whatever the params' type; so does this."""
    if transition_steps <= 0:
        return lambda count: init_value
    f32 = np.float32

    def schedule(count: int) -> float:
        count = min(max(count, 0), transition_steps)
        frac = f32(1) - f32(count) / f32(transition_steps)
        return float(f32(init_value - end_value) * frac + f32(end_value))

    return schedule


class AdamState(NamedTuple):
    count: int              # Adam's count of updates
    mu: dict
    nu: dict
    schedule_count: int     # the learning-rate schedule's own count


class Optimizer(NamedTuple):
    init: Callable          # params -> AdamState
    update: Callable        # (grads, state) -> (updates, state)


def _adam(learning_rate, transform, b1: float, b2: float, eps: float) -> Optimizer:
    """Adam scaled by ``-learning_rate`` (a float or a schedule of the update
    count), after ``transform`` of the gradients (the identity or a clip)."""

    def init(params) -> AdamState:
        zeros = tree_map(torch.zeros_like, params)
        return AdamState(0, zeros, tree_map(torch.zeros_like, params), 0)

    def update(grads, state: AdamState):
        g = transform(grads)
        mu = tree_map(lambda x, m: (1 - b1) * x + b1 * m, g, state.mu)
        nu = tree_map(lambda x, v: (1 - b2) * (x * x) + b2 * v, g, state.nu)
        count = state.count + 1
        bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count

        def adam(m, v):
            # divide by a 0-d tensor on the device: on CUDA, x / python_float is
            # x * (1 / float); torch.full, unlike torch.tensor, copies nothing
            # from the host and so does not wait for the device
            m_hat = m / torch.full((), bc1, dtype=m.dtype, device=m.device)
            v_hat = v / torch.full((), bc2, dtype=v.dtype, device=v.device)
            return m_hat / (torch.sqrt(v_hat) + eps)

        u = tree_map(adam, mu, nu)
        if callable(learning_rate):
            step = -1 * learning_rate(state.schedule_count)
            u = tree_map(lambda x: torch.full((), step, dtype=x.dtype, device=x.device) * x, u)
        else:
            u = tree_map(lambda x: -learning_rate * x, u)
        return u, AdamState(count, mu, nu, state.schedule_count + 1)

    return Optimizer(init, update)


def clip_adam(learning_rate, max_norm: float = 0.5, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8) -> Optimizer:
    """Global-norm clip, then Adam scaled by ``-learning_rate`` (a float or
    a schedule of the update count)."""
    return _adam(learning_rate, lambda g: clip_by_global_norm(g, max_norm), b1, b2, eps)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """``optax.adam``: Adam scaled by ``-learning_rate``, no clip."""
    return _adam(learning_rate, lambda g: g, b1, b2, eps)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
