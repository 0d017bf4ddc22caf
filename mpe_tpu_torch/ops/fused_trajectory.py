"""Fused trajectory: kernel K3 and its plain PyTorch version (counterpart of
``mpe_tpu/ops/fused_trajectory.py``).

The rollout of ``fused_rollout`` that streams the learner's batch: per step
the obs ``[A, OW, N]``, the actions ``[A, 5 + C, N]`` (the raw uniform move
draw, then the silent-masked comm draw) and the reward rows ``[R, N]``,
the obs and reward taken after the step's physics and before its reset.
On a CUDA device ``fused_trajectory`` launches ``trajectory_kernel<S>``
(``csrc/mpe_trajectory.cu``, instantiated for each of the nine scenarios); on the CPU it runs ``plain_trajectory``, the
body of the JAX kernel ``_traj_kernel`` as a torch loop over steps.

The RNG is the JAX kernel's interpret-mode stream. Its grid is (env blocks,
time chunks) and the stream salts with the chunk, so a draw at global step
``t`` uses chunk ``t // t_chunk`` and step ``t % t_chunk``: ``t_chunk`` is
part of the stream's definition, as ``block_envs`` is.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from mpe_tpu_torch._device import resolve_device
from mpe_tpu_torch.ops.fused_rollout import _MASK, make_samplers, make_uniform, pick_block_envs


def plain_trajectory(kscn, n_envs: int, n_steps: int, horizon: int, block_envs: int,
                     t_chunk: int, seed: int, block_offset: int = 0, device=None):
    """The JAX ``_traj_kernel`` over all RNG blocks at once -> (obs
    [T, A, OW, N], act [T, A, 5 + C, N], rew [T, R, N], pos [E, P, N], vel
    [E, P, N]), float32, on ``device``. The block's first chunk draws the
    initial state on call ids 0/1 (goals 8 + 2 + g); moves are id 2, comm
    id 16, reset candidates ids 3/4 (goals 24 + 2 + g)."""
    spec = kscn.spec
    a, e, p = spec.n_agents, spec.n_entities, spec.dim_p
    dim_c = kscn.n_comm
    n_blocks = n_envs // block_envs
    f32 = torch.float32
    obs_out = torch.empty((n_steps, a, kscn.obs_w, n_envs), dtype=f32, device=device)
    act_out = torch.empty((n_steps, a, 2 * p + 1 + dim_c, n_envs), dtype=f32, device=device)
    rew_out = torch.empty((n_steps, kscn.reward_rows, n_envs), dtype=f32, device=device)
    t = torch.zeros((1, n_envs), dtype=torch.int32, device=device)
    zero = torch.zeros((), dtype=f32, device=device)

    def draws(chunk):
        uniform = make_uniform(seed, block_offset, n_blocks, block_envs, chunk, device=device)
        return (uniform, *make_samplers(kscn, uniform))

    uniform, sample_state, sample_goal, sample_comm = draws(0)
    pos = sample_state(0, 0)
    vel = torch.zeros((e, p, n_envs), dtype=f32, device=device)
    goal = sample_goal(0, 8)
    for chunk in range(n_steps // t_chunk):
        if chunk:
            uniform, sample_state, sample_goal, sample_comm = draws(chunk)
        for step in range(t_chunk):
            ts = chunk * t_chunk + step
            move = uniform((a, 2 * p + 1), step, 2)
            pos, vel = kscn.physics(pos, vel, move)
            comm = sample_comm(step, 16)
            rew_out[ts], obs_out[ts] = kscn.reward_obs(pos, vel, comm, goal)
            act_out[ts] = move if comm is None else torch.cat([move, comm], dim=1)
            t = t + 1
            done = t >= horizon
            pos = torch.where(done[None], sample_state(step, 3), pos)
            vel = torch.where(done[None], zero, vel)
            t = torch.where(done, torch.zeros_like(t), t)
            if goal is not None:
                goal = torch.where(done, sample_goal(step, 24), goal)
    return obs_out, act_out, rew_out, pos, vel


def _check_sizes(n_envs: int, n_steps: int, horizon, block_envs: int, t_chunk: int):
    if horizon is None or horizon < 1:
        raise ValueError(f"the trajectory resets every lane at its horizon; need horizon >= 1, "
                         f"got {horizon}")
    if t_chunk < 1 or n_steps < 0 or n_steps % t_chunk:
        raise ValueError(f"n_steps={n_steps} must be a multiple of t_chunk={t_chunk}")
    if n_envs <= 0 or n_envs % block_envs:
        raise ValueError(f"n_envs={n_envs} must be a positive multiple of block_envs={block_envs}")


def trajectory_cuda(kscn, n_envs: int, n_steps: int, horizon: int, block_envs: int,
                    t_chunk: int, seed: int, block_offset: int = 0, device=None):
    """Launch kernel K3 (``trajectory_kernel<S>``) on ``device``, a CUDA
    device: the outputs of ``plain_trajectory``. Counts its launches in
    ``trajectory_cuda.launches`` and, by scenario name, in
    ``trajectory_cuda.launches_by``."""
    from mpe_tpu_torch.ops import _build

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"trajectory_cuda needs a CUDA device, got {device}")
    _check_sizes(n_envs, n_steps, horizon, block_envs, t_chunk)
    scenario, params = _build.kernel_params(kscn)
    spec = kscn.spec
    a, e, p = spec.n_agents, spec.n_entities, spec.dim_p
    dim_c = kscn.n_comm
    f32 = torch.float32
    obs = torch.empty((n_steps, a, kscn.obs_w, n_envs), dtype=f32, device=device)
    act = torch.empty((n_steps, a, 2 * p + 1 + dim_c, n_envs), dtype=f32, device=device)
    rew = torch.empty((n_steps, kscn.reward_rows, n_envs), dtype=f32, device=device)
    pos = torch.empty((e, p, n_envs), dtype=f32, device=device)
    vel = torch.empty((e, p, n_envs), dtype=f32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _build.library("mpe_trajectory.cu").mpe_trajectory(
            scenario, ctypes.byref(params), obs.data_ptr(), act.data_ptr(), rew.data_ptr(),
            pos.data_ptr(), vel.data_ptr(), n_envs, block_envs, n_steps // t_chunk, t_chunk,
            horizon, int(seed) & _MASK, int(block_offset) & _MASK, stream)
    if rc != 0:
        raise RuntimeError(f"trajectory_kernel launch failed: {_build.error_string(rc)}")
    trajectory_cuda.launches += 1
    trajectory_cuda.launches_by[spec.name] += 1
    return obs, act, rew, pos, vel


trajectory_cuda.launches = 0
trajectory_cuda.launches_by = collections.Counter()


def fused_trajectory(scenario, n_envs: int, n_steps: int, horizon: int = 100,
                     block_envs: int = 1024, t_chunk: int = 8, device=None):
    """Build ``run(seed, block_offset=0) -> (obs [T, A, OW, N], act
    [T, A, 5 + C, N], rew [T, R, N], pos [E, P, N], vel [E, P, N])``,
    env-minor trajectory batches for a scenario with kernel blocks. On CUDA
    it launches kernel K3, on the CPU it runs ``plain_trajectory``;
    ``run.plain`` is the plain version on the same device."""
    from mpe_tpu_torch.ops.kernel_scenarios import KernelScenario, kernel_scenario

    kscn = scenario if isinstance(scenario, KernelScenario) else kernel_scenario(scenario)
    device = resolve_device(device)
    block_envs = pick_block_envs(n_envs, block_envs)
    _check_sizes(n_envs, n_steps, horizon, block_envs, t_chunk)
    args = (kscn, n_envs, n_steps, horizon, block_envs, t_chunk)

    def plain(seed, block_offset=0):
        return plain_trajectory(*args, seed, block_offset, device)

    def run(seed, block_offset=0):
        if device.type == "cuda":
            return trajectory_cuda(*args, seed, block_offset, device)
        return plain(seed, block_offset)

    run.plain = plain
    run.n_blocks = n_envs // block_envs
    run.block_envs = block_envs
    return run


def fused_spread_trajectory(spec, n_envs: int, n_steps: int, horizon: int = 100,
                            block_envs: int = 1024, t_chunk: int = 8, device=None):
    """The simple_spread instance of ``fused_trajectory``."""
    from mpe_tpu_torch.ops.kernel_scenarios import KernelSpread

    return fused_trajectory(KernelSpread(spec), n_envs, n_steps, horizon=horizon,
                            block_envs=block_envs, t_chunk=t_chunk, device=device)
