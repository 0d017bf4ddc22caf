"""Rollout loops of the port (single device so far)."""

from mpe_tpu_torch.parallel.mesh import build_rollout

__all__ = ["build_rollout"]
