"""Env-minor step math and the fused rollouts: plain PyTorch versions and
their CUDA kernels (``csrc/*.cu``, built by ``ops/_build.py``).

The builders named like their modules (``fused_rollout``,
``fused_trajectory``, ...) are exported by ``mpe_tpu_torch`` itself: bound
here, they would hide the submodules of the same name from
``from mpe_tpu_torch.ops import fused_rollout``.
"""

from mpe_tpu_torch.ops.batched import batched_spread_step
from mpe_tpu_torch.ops.fused_rollout import fused_spread_rollout, spread_step_block
from mpe_tpu_torch.ops.fused_trajectory import (fused_spread_trajectory, plain_trajectory,
                                                trajectory_cuda)
from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

__all__ = [
    "batched_spread_step", "fused_spread_rollout", "fused_spread_trajectory", "kernel_scenario",
    "plain_trajectory", "spread_step_block", "trajectory_cuda",
]
