"""mpe_tpu_torch: the PyTorch/CUDA port of ``mpe_tpu``.

The JAX package ``mpe_tpu`` stays the reference; this package imports
nothing of it (nor JAX). Module names follow the JAX package so each
counterpart is easy to find. Ported so far: the batched simple_spread path
(spec, actions, physics, scenario, ``MpeEnv``, ``build_rollout``), the
fused rollout kernels K1/K2 (``ops/fused_parity``, ``ops/fused_rollout``;
``csrc/mpe_kernels.cu``), and the fused PPO trainer
(``learner.build_fused_ppo_step``) with its policy kernels K4/K5
(``ops/fused_policy``; ``csrc/mpe_policy.cu``) and update kernel K6
(``ops/fused_update``; ``csrc/mpe_update.cu``), all written in CUDA for
Hopper.

Entry points take ``device=None``, meaning the CUDA card; they raise when
no card is visible. Pass ``device="cpu"`` for the plain PyTorch path.
"""

from mpe_tpu_torch import scenarios
from mpe_tpu_torch._device import make_generator, resolve_device
from mpe_tpu_torch.core.actions import ActionMode
from mpe_tpu_torch.core.state import ScenarioSpec, WorldState, make_spec
from mpe_tpu_torch.entry import entry
from mpe_tpu_torch.envs.functional import MpeEnv
from mpe_tpu_torch.learner import build_fused_ppo_step
from mpe_tpu_torch.ops.fused_parity import fused_det_rollout
from mpe_tpu_torch.ops.fused_policy import fused_policy_rollout, fused_policy_trajectory
from mpe_tpu_torch.ops.fused_rollout import fused_rollout, fused_spread_rollout
from mpe_tpu_torch.parallel.mesh import build_rollout

__all__ = [
    "ActionMode", "MpeEnv", "ScenarioSpec", "WorldState", "build_fused_ppo_step",
    "build_rollout", "entry", "fused_det_rollout", "fused_policy_rollout",
    "fused_policy_trajectory", "fused_rollout", "fused_spread_rollout", "make_generator",
    "make_spec", "resolve_device", "scenarios",
]
