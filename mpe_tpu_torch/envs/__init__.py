"""Environment surfaces of the port (the functional batched env so far;
spaces and wrappers follow in later slices)."""

from mpe_tpu_torch.envs.functional import MpeEnv

__all__ = ["MpeEnv"]
