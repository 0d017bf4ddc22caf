"""Environment surfaces of the port (counterpart of ``mpe_tpu/envs``): the
batched functional env ``MpeEnv``, the space descriptors, the stateful and
vectorized wrappers and the PettingZoo adapters. The gymnasium shim is
``envs.gym_compat``, imported on its own."""

from mpe_tpu_torch.envs import spaces
from mpe_tpu_torch.envs.aec_api import AECEnv, aec_env
from mpe_tpu_torch.envs.functional import MpeEnv
from mpe_tpu_torch.envs.parallel_api import ParallelEnv, parallel_env
from mpe_tpu_torch.envs.wrappers import MultiAgentEnv, VecMultiAgentEnv, pack_actions

# legacy alias for reference users (environment.py:288 BatchMultiAgentEnv)
BatchMultiAgentEnv = VecMultiAgentEnv

__all__ = ["AECEnv", "BatchMultiAgentEnv", "MpeEnv", "MultiAgentEnv", "ParallelEnv",
           "VecMultiAgentEnv", "aec_env", "pack_actions", "parallel_env", "spaces"]
