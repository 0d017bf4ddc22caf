"""PPO learner (counterpart of ``mpe_tpu/learner/ppo.py``). Ported so far:
the initializers of the fused PPO and MAPPO trainers; the scan-based
``build_ppo_step``/``build_mappo_step`` are ROADMAP A9."""

from __future__ import annotations

import torch

from mpe_tpu_torch.learner._nets import dense_init


def init_ac(generator: torch.Generator, obs_dim: int, act_dim: int, hidden: int = 64,
            dtype=torch.float32) -> dict:
    """Actor-critic MLP: shared torso ``l1, l2``, policy head ``pi`` (scale
    0.01) and value head ``v``."""
    return {
        "l1": dense_init(generator, obs_dim, hidden, dtype),
        "l2": dense_init(generator, hidden, hidden, dtype),
        "pi": dense_init(generator, hidden, act_dim, dtype, scale=0.01),
        "v": dense_init(generator, hidden, 1, dtype),
    }


def init_mappo(generator: torch.Generator, obs_dim: int, act_dim: int, n_agents: int,
               hidden: int = 64, dtype=torch.float32) -> dict:
    """Decentralized actor ``a1, a2, pi`` (per-agent obs, shared params; pi
    at scale 0.01) and centralized critic ``c1, c2, v`` on the joint obs of
    all agents, drawn in that order from ``generator``."""
    return {
        "a1": dense_init(generator, obs_dim, hidden, dtype),
        "a2": dense_init(generator, hidden, hidden, dtype),
        "pi": dense_init(generator, hidden, act_dim, dtype, scale=0.01),
        "c1": dense_init(generator, obs_dim * n_agents, hidden, dtype),
        "c2": dense_init(generator, hidden, hidden, dtype),
        "v": dense_init(generator, hidden, 1, dtype),
    }
