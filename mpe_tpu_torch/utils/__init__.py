"""Auxiliary subsystems (counterpart of ``mpe_tpu/utils``): checkpoint and
resume in the JAX package's format, profiling hooks."""

from mpe_tpu_torch.utils.checkpoint import (load_checkpoint, load_train_state, save_checkpoint,
                                            save_train_state)
from mpe_tpu_torch.utils.profiling import step_phase, trace

__all__ = ["load_checkpoint", "load_train_state", "save_checkpoint", "save_train_state",
           "step_phase", "trace"]
