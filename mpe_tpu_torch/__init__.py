"""mpe_tpu_torch: the PyTorch/CUDA port of ``mpe_tpu``.

The JAX package ``mpe_tpu`` stays the reference; this package imports
nothing of it (nor JAX). Module names follow the JAX package so each
counterpart is easy to find. It does all that the JAX package does:

- the nine scenarios (``scenarios``), the batched functional env
  ``MpeEnv`` and ``build_rollout``;
- multi-device over ``torch.distributed``, one process per rank
  (``parallel``: ``init_multihost``, ``env_mesh``, ``sharded_rollout``,
  ``parallel.launch``), the sharded fused rollouts and the data-parallel trainers
  (``mesh=``, ``learner.build_fused_maddpg_dp``);
- checkpoint and resume in the JAX package's format, profiling hooks
  (``utils``);
- the env API: spaces, ``make_env`` and the stateful ``MultiAgentEnv``,
  ``VecMultiAgentEnv``, the registry, the PettingZoo adapters
  (``envs.parallel_api``, ``envs.aec_api``) and the gymnasium shim
  (``envs.gym_compat``);
- the learners: REINFORCE, PPO and MAPPO on the generic engine, greedy
  evaluation, ES, and the fused PPO, MAPPO and MADDPG trainers;
- the side layers: the headless renderer (``render``; ``MultiAgentEnv.render``),
  the random and keyboard policies (``policy``), the interactive CLI
  (``python -m mpe_tpu_torch.interactive_cli``) and the example scripts
  (``python -m mpe_tpu_torch.examples.<name>``);
- all nine TPU kernels, written in CUDA for Hopper: the rollouts K1/K2
  (``ops/fused_parity``, ``ops/fused_rollout``; ``csrc/mpe_kernels.cu``),
  the trajectory K3 (``ops/fused_trajectory``; ``csrc/mpe_trajectory.cu``),
  the policy rollouts K4/K5 (``ops/fused_policy``; ``csrc/mpe_policy.cu``),
  the PPO and MAPPO updates K6/K7 (``ops/fused_update``;
  ``csrc/mpe_update.cu``) and MADDPG's collection and update K8/K9
  (``ops/fused_maddpg``, ``ops/fused_maddpg_update``;
  ``csrc/mpe_maddpg.cu``).

Entry points take ``device=None``, meaning the CUDA card; they raise when
no card is visible. Pass ``device="cpu"`` for the plain PyTorch path.
"""

from mpe_tpu_torch import scenarios
from mpe_tpu_torch._device import make_generator, resolve_device
from mpe_tpu_torch.core.actions import ActionMode
from mpe_tpu_torch.core.state import ScenarioSpec, WorldState, make_spec
from mpe_tpu_torch.entry import entry
from mpe_tpu_torch.envs.functional import MpeEnv
from mpe_tpu_torch.factory import make_env
from mpe_tpu_torch.learner import build_fused_ppo_step
from mpe_tpu_torch.ops.fused_parity import fused_det_rollout
from mpe_tpu_torch.ops.fused_policy import fused_policy_rollout, fused_policy_trajectory
from mpe_tpu_torch.ops.fused_rollout import fused_rollout, fused_spread_rollout
from mpe_tpu_torch.ops.fused_trajectory import fused_trajectory
from mpe_tpu_torch.parallel.mesh import (build_rollout, env_mesh, init_multihost,
                                         sharded_rollout)

__all__ = [
    "ActionMode", "MpeEnv", "ScenarioSpec", "WorldState", "build_fused_ppo_step",
    "build_rollout", "entry", "env_mesh", "fused_det_rollout", "fused_policy_rollout",
    "fused_policy_trajectory", "fused_rollout", "fused_spread_rollout", "fused_trajectory",
    "init_multihost", "make_env", "make_generator", "make_spec", "resolve_device", "scenarios",
    "sharded_rollout",
]
