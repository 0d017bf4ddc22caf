"""Rollouts and env-axis sharding over ranks (counterpart of
``mpe_tpu/parallel``): one process per rank over ``torch.distributed``
(``torchrun``, or ``parallel.launch.launch``), ``init_multihost`` to start a
rank, ``EnvMesh`` its view of the run."""

from mpe_tpu_torch.parallel.mesh import (EnvMesh, build_rollout, env_mesh, fold_host_key,
                                         init_multihost, pick_backend, sharded_rollout)

__all__ = ["EnvMesh", "build_rollout", "env_mesh", "fold_host_key", "init_multihost",
           "pick_backend", "sharded_rollout"]
