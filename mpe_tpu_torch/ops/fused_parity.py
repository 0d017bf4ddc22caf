"""Deterministic fused rollout: kernel K1 and its plain PyTorch version
(counterpart of ``mpe_tpu/ops/fused_parity.py``).

The initial state is an input, per-step moves come from the stateless
hash ``hash_uniform_2d`` of (step, agent, row, lane within the block), and
nothing resets (the reference never terminates, environment.py:132-135).
Without an RNG stream to reproduce, the kernel can be held against the
plain version value for value on the card, and the plain version against
the JAX kernel's interpret run on the CPU.

On CUDA tensors ``fused_det_rollout`` launches ``det_rollout_kernel<S, G>``
(``csrc/mpe_kernels.cu``, one instantiation per scenario struct of
``csrc/scenario_blocks.cuh`` and group G of threads per env lane,
``det_group``); on CPU tensors it runs ``plain_det_rollout_blocked``.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from mpe_tpu_torch._device import resolve_device
from mpe_tpu_torch.ops.fused_rollout import GROUPS, _MASK, _fmix_unit, _flat_index, pick_block_envs

_GOLDEN_DET = 0x9E3779B9     # hash_uniform_2d's salt multiplier (int32 -1640531527)


def hash_uniform_2d(salt: int, shape, device=None, dtype=torch.float32) -> torch.Tensor:
    """Bit-exact port of the JAX ``hash_uniform_2d``: U[0, 1) from the hash
    of ``row * shape[1] + col + salt * 0x9E3779B9`` (mod 2**32)."""
    if len(shape) != 2:
        raise ValueError(f"hash_uniform_2d takes 2-D shapes, got {shape}")
    s = (int(salt) * _GOLDEN_DET) & _MASK
    return _fmix_unit((_flat_index(tuple(shape), device) + s) & _MASK, dtype)


def det_moves(spec, step: int, n: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Per-step moves [A, 2P+1, n]: agent ``i`` hashes salt
    ``step * 131071 + 7 * i + 3``."""
    mw = 2 * spec.dim_p + 1
    return torch.stack([hash_uniform_2d(step * 131071 + 7 * i + 3, (mw, n), device, dtype)
                        for i in range(spec.n_agents)])


def _resolve(scenario):
    from mpe_tpu_torch.ops.kernel_scenarios import KernelScenario, kernel_scenario

    return scenario if isinstance(scenario, KernelScenario) else kernel_scenario(scenario)


def make_det_rollout(kscn, n_steps: int, block_envs: int | None = None):
    """Plain deterministic rollout ``(pos0, vel0, comm0, goal0) -> (pos,
    vel, rew_sum, rew_last, obs_last)`` over the kernel blocks. The move
    hash indexes lanes within an RNG block of ``block_envs`` lanes (the
    whole input when ``None``), so every block draws the same moves."""
    spec = kscn.spec
    has_goal = len(tuple(kscn.goal_choices or ())) > 0
    has_comm = bool(kscn.uses_comm and spec.dim_c)

    def rollout(pos0, vel0, comm0, goal0):
        n = pos0.shape[-1]
        blk = n if block_envs is None else block_envs
        if n % blk:
            raise ValueError(f"{n} lanes are not a multiple of block_envs={blk}")
        comm = comm0 if has_comm else None
        goal = goal0 if has_goal else None
        pos, vel = pos0, vel0
        rew_sum = torch.zeros((kscn.reward_rows, n), dtype=torch.float32, device=pos0.device)
        rew = rew_sum
        obs = torch.zeros((spec.n_agents, kscn.obs_w, n), dtype=torch.float32, device=pos0.device)
        for step in range(n_steps):
            move = det_moves(spec, step, blk, pos0.device).repeat(1, 1, n // blk)
            pos, vel = kscn.physics(pos, vel, move)
            rew, obs = kscn.reward_obs(pos, vel, comm, goal)
            rew_sum = rew_sum + rew
        return pos, vel, rew_sum, rew, obs

    return rollout


def det_input_shapes(kscn, n_envs: int):
    """Input shapes (width-1 dummies where a scenario has no comm/goals)."""
    spec = kscn.spec
    a, e, p = spec.n_agents, spec.n_entities, spec.dim_p
    dim_c = kscn.n_comm
    n_goals = len(tuple(kscn.goal_choices or ()))
    return ((e, p, n_envs), (e, p, n_envs), (a, max(dim_c, 1), n_envs), (max(n_goals, 1), n_envs))


def make_det_inputs(scenario, n_envs: int, seed: int = 0, device=None):
    """Deterministic inputs drawn with a numpy generator: positions uniform
    in the reset ranges, small velocities on movable entities (exercising
    the speed clamp), silent-masked utterances, valid goal indices.
    -> (pos0, vel0, comm0 float32, goal0 int32) on ``device``."""
    kscn = _resolve(scenario)
    spec = kscn.spec
    a = spec.n_agents
    device = resolve_device(device)
    sp, sv, sc, _ = det_input_shapes(kscn, n_envs)
    rng = np.random.default_rng(seed)
    ar, lr = kscn.reset_ranges()
    scale = np.concatenate([np.full((a, 1, 1), ar), np.full((spec.n_landmarks, 1, 1), lr)])
    pos0 = rng.uniform(-1.0, 1.0, sp) * scale
    vel0 = rng.uniform(-0.5, 0.5, sv) * spec.movable.reshape(-1, 1, 1)
    comm0 = rng.uniform(0.0, 1.0, sc) * (1.0 - spec.silent[:a].reshape(-1, 1, 1))
    choices = tuple(kscn.goal_choices or ()) or (1,)
    goal0 = np.stack([rng.integers(0, k, n_envs) for k in choices])

    def dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    return dev(pos0, torch.float32), dev(vel0, torch.float32), dev(comm0, torch.float32), \
        dev(goal0, torch.int32)


def plain_det_rollout(scenario, n_steps: int):
    """The plain rollout over one RNG block spanning all lanes (the
    counterpart of the JAX ``xla_det_rollout``)."""
    return make_det_rollout(_resolve(scenario), n_steps)


def plain_det_rollout_blocked(scenario, n_steps: int, block_envs: int):
    """The plain rollout with the move hash indexed within blocks of
    ``block_envs`` lanes, as the kernel grid draws it (the counterpart of
    the JAX ``xla_det_rollout_blocked``)."""
    return make_det_rollout(_resolve(scenario), n_steps, block_envs)


# K1 splits an env lane while the card holds at most about 16 warps per SM
# (132 SMs x 16 warps x 32 lanes = 67,584 threads)
DET_MAX_THREADS = 65_536


def det_group(kscn, n_envs: int) -> int:
    """K1's threads per env lane, G: the collide pairs where there are any
    (their contact-force chain is the step's longest, and one pair stays on
    one rank), else the movable agents (their move draws split), rounded up
    to a power of two, at most 8 and at most ``DET_MAX_THREADS / n_envs``.
    K1 sums no obs per step, so unlike K2 (``rollout_group``) it gains from
    splitting the move draws alone. Measured on an H100 at 4096 x 10,000
    (PERF.md §6, PR 9): simple_spread 4, simple_tag and simple_world_comm 8,
    simple_adversary 4, simple_reference 2; simple, simple_speaker_listener
    (one movable agent), simple_push (one pair) and simple_crypto (none
    movable) 1; simple_spread at 65,536 envs 1 (at 16,384, where the rule
    gives 4, G = 1, 2 and 4 lie within the run-to-run noise)."""
    from mpe_tpu_torch.ops.kernel_scenarios import collide_pairs

    spec = kscn.spec
    pairs = len(tuple(collide_pairs(spec)))
    split = pairs if pairs else int(spec.movable[:spec.n_agents].sum())
    cap = max(1, DET_MAX_THREADS // n_envs)
    group = 1
    while group < split and group < 8 and 2 * group <= cap:
        group *= 2
    return group


def det_rollout_cuda(kscn, n_steps: int, block_envs: int, pos0, vel0, comm0, goal0,
                     group: int | None = None):
    """Launch kernel K1 (``det_rollout_kernel<S, G>``) on CUDA inputs with
    ``group`` threads per env lane (``None`` takes ``det_group``); the same
    outputs as ``plain_det_rollout_blocked`` for every group. Counts its
    launches in ``det_rollout_cuda.launches`` and, by scenario name, in
    ``.launches_by``."""
    from mpe_tpu_torch.ops import _build

    n = pos0.shape[-1]
    shapes = det_input_shapes(kscn, n)
    dtypes = (torch.float32, torch.float32, torch.float32, torch.int32)
    for name, x, shape, dtype in zip(("pos0", "vel0", "comm0", "goal0"),
                                     (pos0, vel0, comm0, goal0), shapes, dtypes):
        if x.device != pos0.device or x.device.type != "cuda":
            raise ValueError(f"{name} must be on the same CUDA device as pos0, got {x.device}")
        if tuple(x.shape) != shape or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {shape}, "
                             f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    if n_steps < 0 or n % block_envs:
        raise ValueError(f"need n_steps >= 0 and n={n} a multiple of block_envs={block_envs}")
    group = det_group(kscn, n) if group is None else group
    if group not in GROUPS:
        raise ValueError(f"group must be one of {GROUPS}, got {group}")
    scenario, params = _build.kernel_params(kscn)
    spec = kscn.spec
    out = dict(dtype=torch.float32, device=pos0.device)
    pos = torch.empty_like(pos0)
    vel = torch.empty_like(vel0)
    rew_sum = torch.empty((kscn.reward_rows, n), **out)
    rew = torch.empty((kscn.reward_rows, n), **out)
    obs = torch.empty((spec.n_agents, kscn.obs_w, n), **out)
    with torch.cuda.device(pos0.device):
        stream = torch.cuda.current_stream(pos0.device).cuda_stream
        rc = _build.library().mpe_det_rollout(
            scenario, ctypes.byref(params), *(x.data_ptr() for x in (
                pos0, vel0, comm0, goal0, pos, vel, rew_sum, rew, obs)),
            n, block_envs, n_steps, group, stream)
    if rc != 0:
        raise RuntimeError(f"det_rollout_kernel launch failed: {_build.error_string(rc)}")
    det_rollout_cuda.launches += 1
    det_rollout_cuda.launches_by[spec.name] += 1
    return pos, vel, rew_sum, rew, obs


det_rollout_cuda.launches = 0
det_rollout_cuda.launches_by = collections.Counter()


def fused_det_rollout(scenario, n_envs: int, n_steps: int, block_envs: int = 1024, device=None,
                      group: int | None = None):
    """``run(pos0, vel0, comm0, goal0) -> (pos, vel, rew_sum, rew_last,
    obs_last)`` over RNG blocks of ``block_envs`` lanes. Inputs must lie on
    ``device`` (``None`` = the card): CUDA inputs launch kernel K1 with
    ``group`` threads per env lane (``None``: ``det_group``; the outputs do not
    depend on it), CPU inputs run ``plain_det_rollout_blocked``."""
    kscn = _resolve(scenario)
    device = resolve_device(device)
    block_envs = pick_block_envs(n_envs, block_envs)
    plain = make_det_rollout(kscn, n_steps, block_envs)

    def run(pos0, vel0, comm0, goal0):
        if pos0.device.type != device.type or pos0.shape[-1] != n_envs:
            raise ValueError(f"expected {n_envs} lanes on {device}, got {tuple(pos0.shape)} "
                             f"on {pos0.device}")
        if pos0.is_cuda:
            return det_rollout_cuda(kscn, n_steps, block_envs, pos0, vel0, comm0, goal0, group)
        return plain(pos0, vel0, comm0, goal0)

    run.block_envs = block_envs
    return run
