"""Learners (counterpart of ``mpe_tpu/learner/``). Ported so far: the
initializers ``init_policy``, ``init_ac``, ``init_mappo`` and
``init_maddpg``, the optimizers of the fused trainers, the fused PPO and
MAPPO trainers and the fused MADDPG loop (centralized critic) on
simple_spread."""

from mpe_tpu_torch.learner.fused_loop import build_fused_maddpg_runner, run_fused_maddpg
from mpe_tpu_torch.learner.fused_ppo import build_fused_mappo_step, build_fused_ppo_step
from mpe_tpu_torch.learner.maddpg import (Buffer, build_fused_collect, build_fused_update,
                                          build_fused_update_chunk, init_buffer, init_maddpg,
                                          maddpg_act_dim)
from mpe_tpu_torch.learner.optim import adam, apply_updates, clip_adam, linear_schedule
from mpe_tpu_torch.learner.pg import init_policy
from mpe_tpu_torch.learner.ppo import init_ac, init_mappo

__all__ = ["Buffer", "adam", "apply_updates", "build_fused_collect", "build_fused_maddpg_runner",
           "build_fused_mappo_step", "build_fused_ppo_step", "build_fused_update",
           "build_fused_update_chunk", "clip_adam", "init_ac", "init_buffer", "init_maddpg",
           "init_mappo", "init_policy", "linear_schedule", "maddpg_act_dim", "run_fused_maddpg"]
