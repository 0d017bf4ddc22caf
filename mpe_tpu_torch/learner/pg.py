"""REINFORCE learner (counterpart of ``mpe_tpu/learner/pg.py``). Ported so
far: the policy initializer; ``build_train_step`` is ROADMAP A9."""

from __future__ import annotations

import torch

from mpe_tpu_torch.learner._nets import dense_init


def init_policy(generator: torch.Generator, obs_dim: int, act_dim: int, hidden: int = 64,
                dtype=torch.float32) -> dict:
    """Two-hidden-layer MLP shared across agents: ``{l1, l2, out}``."""
    return {
        "l1": dense_init(generator, obs_dim, hidden, dtype),
        "l2": dense_init(generator, hidden, hidden, dtype),
        "out": dense_init(generator, hidden, act_dim, dtype),
    }
