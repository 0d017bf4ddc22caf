"""Learners (counterpart of ``mpe_tpu/learner/``). Ported so far: the
initializers ``init_policy`` and ``init_ac``, the clip + Adam optimizer of
the PPO trainers, and the fused PPO trainer on simple_spread."""

from mpe_tpu_torch.learner.fused_ppo import build_fused_ppo_step
from mpe_tpu_torch.learner.optim import apply_updates, clip_adam, linear_schedule
from mpe_tpu_torch.learner.pg import init_policy
from mpe_tpu_torch.learner.ppo import init_ac

__all__ = ["apply_updates", "build_fused_ppo_step", "clip_adam", "init_ac", "init_policy",
           "linear_schedule"]
