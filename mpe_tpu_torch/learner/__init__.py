"""Learners (counterpart of ``mpe_tpu/learner/``): REINFORCE
(``build_train_step``), PPO and MAPPO on the generic engine
(``build_ppo_step``, ``build_mappo_step``), evolution strategies on kernel
K4 (``build_es_step``), greedy evaluation (``learner.eval``), the fused PPO
and MAPPO trainers, the fused MADDPG loop (centralized or local critics) on
the nine scenarios, the per-step MADDPG learner (``build_maddpg``), §4.3
policy ensembles (``build_ensemble_runner``) and §4.2 approximate other-agent
policies (``build_approx_runner``), their initializers and optimizers, and
the data-parallel fused MADDPG (``build_fused_maddpg_dp``). The fused and
generic PPO, MAPPO and REINFORCE builders take ``mesh=`` (a
``parallel.EnvMesh``) to train data-parallel."""

from mpe_tpu_torch.learner.approx_others import build_approx_runner, init_approx
from mpe_tpu_torch.learner.ensemble import build_ensemble_runner, init_ensemble
from mpe_tpu_torch.learner.es import build_es_step
from mpe_tpu_torch.learner.fused_loop import build_fused_maddpg_runner, run_fused_maddpg
from mpe_tpu_torch.learner.fused_ppo import build_fused_mappo_step, build_fused_ppo_step
from mpe_tpu_torch.learner.maddpg import (Buffer, build_fused_collect, build_fused_maddpg_dp,
                                          build_fused_update, build_fused_update_chunk,
                                          build_maddpg, init_buffer, init_maddpg, maddpg_act_dim)
from mpe_tpu_torch.learner.optim import adam, apply_updates, clip_adam, linear_schedule
from mpe_tpu_torch.learner.pg import build_train_step, init_policy, policy_logits, sample_actions
from mpe_tpu_torch.learner.ppo import (actor_logits, build_mappo_step, build_ppo_step,
                                       central_value, init_ac, init_mappo, policy_value)

__all__ = ["Buffer", "actor_logits", "adam", "apply_updates", "build_approx_runner",
           "build_ensemble_runner", "build_es_step", "build_fused_collect",
           "build_fused_maddpg_dp", "build_fused_maddpg_runner", "build_fused_mappo_step",
           "build_fused_ppo_step", "build_fused_update", "build_fused_update_chunk",
           "build_maddpg", "build_mappo_step", "build_ppo_step", "build_train_step",
           "central_value", "clip_adam", "init_ac", "init_approx", "init_buffer",
           "init_ensemble", "init_maddpg", "init_mappo", "init_policy", "linear_schedule",
           "maddpg_act_dim", "policy_logits", "policy_value", "run_fused_maddpg",
           "sample_actions"]
