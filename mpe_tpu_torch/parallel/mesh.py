"""Env-axis sharding over ranks (counterpart of ``mpe_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over an in-process device mesh
(``shard_map``, ``pmean``). The port runs one process per rank over
``torch.distributed`` (``torchrun --nproc-per-node N``, or
``parallel.launch``), and an ``EnvMesh`` is this process's view of it: its
rank, the world size, its device and the process group.

  - envs are embarrassingly parallel: a rank steps its ``n_envs / size``
    local envs, and the hot path has no collective;
  - a fused kernel on rank r draws the global RNG blocks ``[r * B, (r + 1) *
    B)`` of its local ``B`` (``EnvMesh.shard_envs``), so a sharded run equals
    the single-device run lane for lane, as ``shard_map``'s ``axis_index``
    does in JAX;
  - collectives appear only where JAX has them: the learners' gradient
    ``pmean`` (one ``all_reduce`` of one flat buffer per update, then a divide
    by the size: gloo has no average) and the metric means.

``init_multihost`` starts the process group: ``nccl`` where every rank of a
host has a card of its own, else ``gloo`` (the CPU, and ranks that share a
card: NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import os
from typing import Callable

import torch

from mpe_tpu_torch._device import resolve_device
from mpe_tpu_torch.core.actions import ActionMode
from mpe_tpu_torch.envs.functional import MpeEnv

_MASK = 0xFFFFFFFF
_FMIX = (0x85EBCA6B, 0xC2B2AE35)      # murmur3's finalizer, as the kernels' RNG hash


class EnvMesh:
    """A 1-D mesh over the env axis, seen from one rank.

    ``group`` is the process group, ``None`` for a one-rank mesh (nothing to
    reduce) or for a rank's view built by hand (``EnvMesh(r, size, device)``:
    it shards and draws as rank r of ``size`` does, in one process, and its
    collectives raise; the tests' one-process twins use it). ``reduces``
    counts the ``all_reduce`` calls made through the mesh. ``local`` and
    ``gather`` move the env axis of a tensor between its global and its
    per-rank form, as JAX's ``env_sharding`` places it on the mesh."""

    axis_name = "env"                 # the mesh axis, as named in the JAX package

    def __init__(self, rank: int, size: int, device, group=None, backend: str | None = None):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside a mesh of {size}")
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.group, self.backend = group, backend
        self.reduces = 0

    def __repr__(self) -> str:
        return (f"EnvMesh(rank={self.rank}, size={self.size}, device={self.device}, "
                f"backend={self.backend})")

    def local_envs(self, n_envs: int) -> int:
        """This rank's share of ``n_envs`` (they must divide evenly)."""
        if n_envs % self.size:
            raise ValueError(f"n_envs {n_envs} is not divisible by {self.size} ranks")
        return n_envs // self.size

    def shard_envs(self, n_envs: int, block_envs: int) -> tuple[int, int, int]:
        """(local envs, local RNG block size, this rank's block offset) of a
        fused kernel. Raise unless the local block size equals the
        single-device run's, the precondition of sharded == single per lane."""
        from mpe_tpu_torch.ops.fused_rollout import pick_block_envs

        local = self.local_envs(n_envs)
        block, single = pick_block_envs(local, block_envs), pick_block_envs(n_envs, block_envs)
        if block != single:
            raise ValueError(f"a rank's {local} envs take RNG blocks of {block}, the "
                             f"single-device run of {n_envs} blocks of {single}: the sharded "
                             "run would not equal it lane for lane; pick block_envs dividing "
                             f"{local}")
        return local, block, self.rank * (local // block)

    def rank_key(self, key):
        """The key this rank draws with: ``key`` itself on one rank, else
        ``fold_host_key(key, rank)``."""
        return key if self.size == 1 else fold_host_key(key, self.rank)

    def _all_reduce_(self, tensors, mean: bool) -> list[torch.Tensor]:
        tensors = list(tensors)
        if self.size == 1:
            if self.group is None:
                return tensors
        elif self.group is None:
            raise RuntimeError(f"{self!r} has no process group: a rank's view cannot reduce")
        import torch.distributed as dist

        dtype = tensors[0].dtype
        for t in tensors[1:]:
            dtype = torch.promote_types(dtype, t.dtype)
        flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        self.reduces += 1
        if mean:
            flat = flat / torch.full((), self.size, dtype=dtype, device=flat.device)
        # back into each tensor's own storage: the consumer then reads the
        # layout it would read unreduced (torch's sums round by layout and
        # alignment, so a fresh tensor could sum differently)
        i = 0
        for t in tensors:
            t.copy_(flat[i:i + t.numel()].reshape(t.shape))
            i += t.numel()
        return tensors

    def mean_(self, tensors) -> list[torch.Tensor]:
        """Replace each tensor by its mean over the ranks, in place, by one
        ``all_reduce`` of their concatenation (SUM, then a divide by the
        size); returns them. Nothing changes on a one-rank mesh."""
        return self._all_reduce_(tensors, mean=True)

    def sum_(self, tensors) -> list[torch.Tensor]:
        """Replace each tensor by its sum over the ranks, in place, by one
        ``all_reduce``; returns them."""
        return self._all_reduce_(tensors, mean=False)

    def local(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This rank's slice of the env axis ``axis`` of a global tensor."""
        n = self.local_envs(x.shape[axis])
        return x.narrow(axis, self.rank * n, n)

    def gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The ranks' slices ``x`` joined along ``axis``, on every rank (on
        the device with ``nccl``; ``gloo`` gathers host copies, which come
        back on ``x``'s device)."""
        if self.group is None:
            if self.size > 1:
                raise RuntimeError(f"{self!r} has no process group: a rank's view cannot gather")
            return x
        import torch.distributed as dist

        src = x.contiguous() if self.backend == "nccl" else x.detach().cpu().contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim=axis).to(x.device)


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def env_mesh(device=None) -> EnvMesh:
    """The mesh of this process: the running process group
    (``init_multihost``), or one rank without one. ``device=None`` is the
    card, ``cuda:LOCAL_RANK`` modulo the cards visible; raise without one."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank() % torch.cuda.device_count())
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return EnvMesh(dist.get_rank(), dist.get_world_size(), dev, dist.group.WORLD,
                       dist.get_backend())
    return EnvMesh(0, 1, dev)


def pick_backend(device, ranks_on_host: int) -> str:
    """``init_multihost``'s backend: ``nccl`` when ``device`` is a card and
    the host's ranks fit one card each, else ``gloo``."""
    fits = torch.device(device).type == "cuda" and ranks_on_host <= torch.cuda.device_count()
    return "nccl" if fits else "gloo"


def _fold(seed: int, rank: int) -> int:
    h = (int(seed) * 7919 + int(rank) * 104729) & _MASK
    for c in _FMIX:
        h ^= h >> 16
        h = (h * c) & _MASK
    return (h ^ (h >> 16)) & 0x7FFFFFFF


def _process_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def fold_host_key(key, rank: int | None = None):
    """A key stream of its own for ``rank`` (this process's rank by default):
    an int seed gives an int seed in [0, 2**31), from the murmur3 finalizer
    of ``seed * 7919 + rank * 104729`` mod 2**32 (the kernels' block mixing);
    a ``torch.Generator`` gives a new generator on its device, seeded with
    the fold of one draw from it (which advances it alike on every rank)."""
    rank = _process_rank() if rank is None else int(rank)
    if isinstance(key, torch.Generator):
        seed = int(torch.randint(0, 2 ** 31, (), generator=key, device=key.device))
        return torch.Generator(device=key.device).manual_seed(_fold(seed, rank))
    return _fold(int(key), rank)


def _uniform_actions(env: MpeEnv, generator: torch.Generator, n_envs: int,
                     env_axis: int = 0) -> torch.Tensor:
    """Uniform random canonical actions ``[n_envs, A, W]`` (env-leading),
    or ``[A, W, n_envs]`` for ``env_axis=-1``: drawn in the canonical
    shape either way, so both layouts hold the same values."""
    shape = (n_envs, env.n_agents, env.action_width)
    kw = dict(generator=generator, device=env.device)
    if env.action_mode is ActionMode.DISCRETE_INDEX:
        # column 0 is the move index in [0, 5), column 1 the comm index in
        # [0, dim_c)
        move = torch.randint(0, 2 * env.spec.dim_p + 1, shape[:2] + (1,), dtype=torch.int32, **kw)
        comm = torch.randint(0, max(env.spec.dim_c, 1), shape[:2] + (1,), dtype=torch.int32, **kw)
        acts = torch.cat([move, comm], dim=-1)
    else:
        acts = torch.rand(shape, dtype=env.dtype, **kw)
    return acts if env_axis == 0 else acts.movedim(0, -1)


def build_rollout(
    env: MpeEnv,
    n_envs: int,
    n_steps: int,
    policy: Callable | None = None,
    return_trajectory: bool = False,
    env_axis: int = 0,
    mesh: EnvMesh | None = None,
):
    """Build ``rollout(generator) -> (states, out)``.

    ``policy(obs, generator) -> actions`` defaults to uniform random
    actions. With ``return_trajectory`` the steps' (obs, actions, reward,
    done) are stacked on a leading time axis; otherwise ``out`` is the sum
    of all rewards (bench mode). ``env_axis`` is 0 (env-leading) or -1
    (env-minor) for the states, obs, actions and trajectory, as in the JAX
    package; the step itself always runs env-leading.

    With ``mesh`` the rank steps its ``n_envs / size`` envs with
    ``mesh.rank_key(generator)``: states and trajectory are its slice of the
    env axis (``mesh.gather`` joins them) and the bench-mode
    sum is over every rank's envs (one ``all_reduce``). On one rank it is
    the rollout without a mesh.
    """
    if env_axis not in (0, -1):
        raise ValueError(f"env_axis must be 0 or -1, got {env_axis}")
    n_local = n_envs if mesh is None else mesh.local_envs(n_envs)

    def to_layout(x):
        return x if env_axis == 0 else x.movedim(0, -1)

    def from_layout(x):
        return x if env_axis == 0 else x.movedim(-1, 0)

    def rollout(generator: torch.Generator):
        if mesh is not None:
            generator = mesh.rank_key(generator)
        states, obs = env.reset(n_local, generator)
        traj = {"obs": [], "actions": [], "reward": [], "done": []}
        total = torch.zeros((), dtype=env.dtype, device=env.device)
        for _ in range(n_steps):
            if policy is None:
                actions = _uniform_actions(env, generator, n_local, env_axis)
            else:
                actions = policy(to_layout(obs), generator)
            states, obs, rew, done, _ = env.step(states, from_layout(actions), generator)
            if return_trajectory:
                for k, v in (("obs", obs), ("actions", actions), ("reward", rew), ("done", done)):
                    traj[k].append(v if k == "actions" else to_layout(v))
            else:
                total = total + rew.sum()
        if return_trajectory:
            out = {k: torch.stack(v) for k, v in traj.items()}
        else:
            out = total if mesh is None else mesh.sum_([total])[0]
        return states.map(to_layout), out

    return rollout


def sharded_rollout(env: MpeEnv, n_envs: int, n_steps: int, mesh: EnvMesh | None = None,
                    **kwargs):
    """``build_rollout`` over a mesh (by default this process's, ``env_mesh``
    on the env's device). It adds nothing to ``build_rollout(mesh=)`` and
    stays as the JAX package's name for the sharded rollout."""
    mesh = mesh if mesh is not None else env_mesh(env.device)
    return build_rollout(env, n_envs, n_steps, mesh=mesh, **kwargs)


def init_multihost(init_method: str | None = None, world_size: int | None = None,
                   rank: int | None = None, device=None) -> EnvMesh:
    """Start this process's rank of a multi-process run and return its mesh.

    ``init_method`` (``"file:///path"``, ``"tcp://host:port"``), ``world_size``
    and ``rank`` go to ``torch.distributed.init_process_group``; under
    ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) all may be omitted
    (``env://``). With nothing given and nothing set, no process group
    starts: a one-rank mesh. The backend is ``pick_backend``'s for the
    host's ranks (``LOCAL_WORLD_SIZE``, else the world size); it is printed,
    and nothing retries another after a failure. Call once per process, before building rollouts."""
    import torch.distributed as dist

    if dist.is_initialized():
        return env_mesh(device)
    from_env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if init_method is None and world_size is None and rank is None and not from_env:
        return env_mesh(device)
    world_size = int(os.environ["WORLD_SIZE"] if world_size is None else world_size)
    rank = int(os.environ["RANK"] if rank is None else rank)
    dev = resolve_device(device)
    backend = pick_backend(dev, int(os.environ.get("LOCAL_WORLD_SIZE", world_size)))
    if backend == "nccl":
        torch.cuda.set_device(_local_rank())
    print(f"mpe_tpu_torch: rank {rank} of {world_size}, backend {backend}, device "
          f"{dev.type}", flush=True)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return env_mesh(device)
