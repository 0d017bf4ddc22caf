"""Fused multi-step rollout: kernel K2 and its plain PyTorch version
(counterpart of ``mpe_tpu/ops/fused_rollout.py``).

On a CUDA device ``fused_rollout``/``fused_spread_rollout`` launch K2
(``csrc/mpe_kernels.cu``: ``scenario_rollout_kernel<S>``, instantiated for
each of the nine scenarios): one thread per env lane runs the whole rollout
with its state in registers. On the CPU they
run ``plain_rollout``, the body of the JAX kernel ``_generic_rollout_kernel``
written as a torch loop over steps.

The RNG is the JAX kernel's interpret-mode stream: the stateless murmur
hash ``_hash_uniform`` of (salt, index within the RNG block), salted with
``make_uniform``'s mixing of (seed, global block id, step, call id). The
RNG block (``block_envs``) is therefore part of the stream's definition;
it is a wrapper argument, independent of the CUDA thread-block size. The
JAX interpret run, the plain version and the kernel draw the same bits.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from mpe_tpu_torch._device import resolve_device
from mpe_tpu_torch.core.physics import logaddexp0
from mpe_tpu_torch.core.state import ScenarioSpec

_MASK = 0xFFFFFFFF
_GOLDEN_ROLLOUT = 0x9E3779B1     # 2654435761: _hash_uniform's salt multiplier
_FMIX = (0x85EBCA6B, 0xC2B2AE35)


# ---------------------------------------------------------------------------
# kernel blocks (plain, env-minor)
# ---------------------------------------------------------------------------

def spread_step_block(spec: ScenarioSpec, apos, avel, lpos, move):
    """One simple_spread step on an env-minor block: apos/avel [A, P, N],
    lpos [L, P, N], move [A, 5, N] -> (apos, avel, reward [1, N] shared,
    obs [A, 18, N])."""
    apos, avel = spread_physics_block(spec, apos, avel, move)
    reward, obs = spread_reward_obs_block(spec, apos, avel, lpos)
    return apos, avel, reward, obs


def spread_physics_block(spec: ScenarioSpec, apos, avel, move):
    """Decode + agent-agent forces + integration (core.py:117-169);
    -> (apos, avel)."""
    a = spec.n_agents
    tiny = torch.finfo(apos.dtype).tiny
    u = torch.stack([move[:, 2 * k + 1] - move[:, 2 * k + 2] for k in range(spec.dim_p)], dim=1)
    accel = [float(x) for x in spec.accel]
    u = u * accel[0] if len(set(accel)) == 1 else torch.stack([u[i] * accel[i] for i in range(a)])

    k = float(spec.contact_margin)
    k_div = torch.tensor(k, dtype=apos.dtype, device=apos.device)   # see generic_physics_block
    cf = float(spec.contact_force)
    rows = [u[i] for i in range(a)]
    for i in range(a):
        for j in range(i + 1, a):
            if not (spec.collide[i] and spec.collide[j]):
                continue
            delta = apos[i] - apos[j]                            # [P, N]
            d2 = delta.square().sum(0, keepdim=True)
            inv = torch.rsqrt(d2.clamp_min(tiny))
            dist = d2 * inv
            x = -(dist - float(spec.size[i] + spec.size[j])) / k_div
            pen = logaddexp0(x) * k
            f = (cf * pen) * inv * delta
            rows[i] = rows[i] + f
            rows[j] = rows[j] - f
    force = torch.stack(rows)                                    # [A, P, N]

    damping = float(spec.damping)
    dt = float(spec.dt)
    masses = [float(m) for m in spec.initial_mass[:a]]
    if len(set(masses)) == 1 and masses[0] == 1.0:
        avel = avel * (1.0 - damping) + force * dt
    else:
        mass = torch.tensor(masses, dtype=avel.dtype, device=avel.device)[:, None, None]
        avel = avel * (1.0 - damping) + force / mass * dt
    if np.isfinite(spec.max_speed[:a]).any():
        speed = avel.square().sum(1, keepdim=True).sqrt()
        clamped = []
        for i in range(a):
            ms = float(spec.max_speed[i])
            if np.isfinite(ms):
                clamped.append(torch.where(speed[i] > ms, avel[i] / speed[i].clamp_min(1e-30) * ms,
                                           avel[i]))
            else:
                clamped.append(avel[i])
        avel = torch.stack(clamped)
    return apos + avel * dt, avel


def spread_reward_obs_block(spec: ScenarioSpec, apos, avel, lpos):
    """simple_spread reward + obs of a post-step state -> (reward [1, N]
    shared, obs [A, 18, N]). Pairs are counted twice and the constant
    self-collision term is ``-A`` (simple_spread.py:72-82 summed over
    agents, environment.py:99-102)."""
    a, l = spec.n_agents, spec.n_landmarks
    n = apos.shape[-1]
    zeros = apos.new_zeros((1, n))

    base = zeros
    for j in range(l):
        dj = None
        for i in range(a):
            d = (apos[i] - lpos[j]).square().sum(0, keepdim=True).sqrt()
            dj = d if dj is None else torch.minimum(dj, d)
        base = base - dj
    coll_total = zeros
    for i in range(a):
        for j in range(i + 1, a):
            if spec.collide[i] and spec.collide[j]:
                d2 = (apos[i] - apos[j]).square().sum(0, keepdim=True)
                thresh2 = float(spec.size[i] + spec.size[j]) ** 2
                coll_total = coll_total + 2.0 * (d2 < thresh2).to(apos.dtype)
    reward = a * base - coll_total - float(a)

    obs_rows = []
    for i in range(a):
        parts = [avel[i], apos[i]] + [lpos[j] - apos[i] for j in range(l)]
        parts += [apos[j] - apos[i] for j in range(a) if j != i]
        parts.append(apos.new_zeros(((a - 1) * spec.dim_c, n)))
        obs_rows.append(torch.cat(parts, dim=0))
    return reward, torch.stack(obs_rows)


# ---------------------------------------------------------------------------
# RNG: the interpret-mode hash stream of the JAX kernels
# ---------------------------------------------------------------------------

def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for int64 ``h`` in [0, 2**32) and a constant
    ``c`` in [0, 2**32), without int64 overflow (split into 16-bit halves)."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _MASK


def _fmix_unit(h: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64, then the top 24
    bits as U[0, 1). Shifts are logical because the values are
    non-negative; every multiply is masked to 32 bits."""
    for c in _FMIX:
        h = h ^ (h >> 16)
        h = _mul32(h, c)
    h = h ^ (h >> 16)
    return (h >> 8).to(dtype) * 2.0 ** -24


def _flat_index(shape, device) -> torch.Tensor:
    n = int(np.prod(shape))
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def _hash_uniform(salt: int, shape, device=None, dtype=torch.float32) -> torch.Tensor:
    """Bit-exact port of the JAX ``_hash_uniform``: U[0, 1) from the hash
    of ``salt * 0x9E3779B1 + flat index`` (row-major over ``shape``)."""
    s = (int(salt) * _GOLDEN_ROLLOUT) & _MASK
    return _fmix_unit((_flat_index(shape, device) + s) & _MASK, dtype)


def make_uniform(seed: int, block_offset: int, n_blocks: int, block_envs: int, *extra_salts,
                 device=None):
    """The stream of ``make_uniform``'s interpret branch over ``n_blocks``
    RNG blocks at once: ``uniform(shape, step, call_id)`` returns
    ``shape + (n_blocks * block_envs,)`` where lane ``b * block_envs + l``
    holds element ``(..., l)`` of global block ``b + block_offset``'s draw.
    The salt is ``seed*7919 + block*104729 + sum_i extra_i*(15485863 + 2i)
    + step*64 + call_id`` (mod 2**32); the policy trajectory salts with its
    time-chunk index as the one extra."""
    blocks = torch.arange(n_blocks, dtype=torch.int64, device=device)
    mixed = int(seed) * 7919 + sum(int(x) * (15485863 + 2 * i) for i, x in enumerate(extra_salts))
    mixed = (mixed + (blocks + int(block_offset)) * 104729) & _MASK              # [n_blocks]
    index_cache: dict[tuple, torch.Tensor] = {}

    def uniform(shape, step: int, call_id: int) -> torch.Tensor:
        shape = tuple(shape)
        if shape not in index_cache:
            index_cache[shape] = _flat_index(shape + (block_envs,), device).unsqueeze(-2)
        salt = _mul32((mixed + (int(step) * 64 + int(call_id))) & _MASK, _GOLDEN_ROLLOUT)
        h = (index_cache[shape] + salt[:, None]) & _MASK                 # [..., n_blocks, block]
        return _fmix_unit(h).reshape(shape + (n_blocks * block_envs,))

    return uniform


def make_samplers(kscn, uniform):
    """Reset samplers of the fused rollouts: ``(sample_state, sample_goal,
    sample_comm)``, each a function of ``(step, call_id)`` drawing entity
    positions in the scenario's reset ranges, per-lane goal indices and
    silent-masked utterances (``None`` where the scenario has none)."""
    spec = kscn.spec
    a, l, p = spec.n_agents, spec.n_landmarks, spec.dim_p
    goal_choices = tuple(kscn.goal_choices or ())
    dim_c = kscn.n_comm
    ar, lr = kscn.reset_ranges()

    def sample_state(step, call_id):
        apos = uniform((a, p), step, call_id) * (2.0 * ar) - ar
        lpos = uniform((l, p), step, call_id + 1) * (2.0 * lr) - lr
        return torch.cat([apos, lpos], dim=0)

    def sample_goal(step, call_id):
        if not goal_choices:
            return None
        rows = [torch.floor(uniform((1,), step, call_id + 2 + gi) * float(k)).to(torch.int32)
                for gi, k in enumerate(goal_choices)]
        return torch.cat(rows, dim=0)

    def sample_comm(step, call_id):
        if not dim_c:
            return None
        c = uniform((a, dim_c), step, call_id)
        if not spec.silent.any():
            return c
        return torch.stack([c[i] * (0.0 if spec.silent[i] else 1.0) for i in range(a)])

    return sample_state, sample_goal, sample_comm


def make_lane_reset(kscn, uniform):
    """Block init and per-lane reset draws of the stateful policy kernels
    (``make_lane_reset`` of the JAX package): ``(init, fresh)``.
    ``init()`` draws the initial state on call ids 0/1 (goals 8+2+g) with
    zero velocity and comm -> ``(pos0, vel0, obs0, goal0, comm0)``;
    ``fresh(step, vel)`` draws reset candidates on call ids 3/4 (goals
    24+2+g) -> ``(pos_f, obs_f, goal_f)``, the obs computed at zero
    velocity."""
    spec = kscn.spec
    sample_state, sample_goal, _ = make_samplers(kscn, uniform)
    a = spec.n_agents
    dim_c = kscn.n_comm

    def zero_comm(like):
        return like.new_zeros((a, dim_c, like.shape[-1])) if dim_c else None

    def init():
        pos0 = sample_state(0, 0)
        vel0 = torch.zeros_like(pos0)
        goal0 = sample_goal(0, 8)
        comm0 = zero_comm(pos0)
        _, obs0 = kscn.reward_obs(pos0, vel0, comm0, goal0)
        return pos0, vel0, obs0, goal0, comm0

    def fresh(step, vel):
        pos_f = sample_state(step, 3)
        goal_f = sample_goal(step, 24)
        _, obs_f = kscn.reward_obs(pos_f, torch.zeros_like(vel), zero_comm(pos_f), goal_f)
        return pos_f, obs_f, goal_f

    return init, fresh


def pick_block_envs(n_envs: int, requested: int = 1024) -> int:
    """Largest divisor of ``n_envs`` not exceeding ``requested``."""
    b = max(1, min(requested, n_envs))
    while n_envs % b:
        b -= 1
    return b


# ---------------------------------------------------------------------------
# the rollout: plain version and kernel K2
# ---------------------------------------------------------------------------

def plain_rollout(kscn, n_envs: int, n_steps: int, horizon: int | None, block_envs: int,
                  seed: int, block_offset: int = 0, device=None):
    """The JAX ``_generic_rollout_kernel`` body as a torch loop over all RNG
    blocks at once: -> (pos [E, P, N], vel, rew_sum [R, N], obs_checksum
    [1, N]), float32, on ``device``."""
    spec = kscn.spec
    a, e, p = spec.n_agents, spec.n_entities, spec.dim_p
    if n_envs % block_envs:
        raise ValueError(f"n_envs={n_envs} is not a multiple of block_envs={block_envs}")
    uniform = make_uniform(seed, block_offset, n_envs // block_envs, block_envs, device=device)
    sample_state, sample_goal, sample_comm = make_samplers(kscn, uniform)
    f32 = torch.float32

    pos = sample_state(0, 0)
    vel = torch.zeros((e, p, n_envs), dtype=f32, device=device)
    t = torch.zeros((1, n_envs), dtype=torch.int32, device=device)
    rew_acc = torch.zeros((kscn.reward_rows, n_envs), dtype=f32, device=device)
    obs_acc = torch.zeros((1, n_envs), dtype=f32, device=device)
    goal = sample_goal(0, 8)
    for step in range(n_steps):
        move = uniform((a, 2 * p + 1), step, 2)
        pos, vel = kscn.physics(pos, vel, move)
        comm = sample_comm(step, 16)
        rew, obs = kscn.reward_obs(pos, vel, comm, goal)
        rew_acc = rew_acc + rew
        obs_acc = obs_acc + obs.sum(0).sum(0, keepdim=True)
        t = t + 1
        if horizon is not None:
            done = t >= horizon
            pos = torch.where(done[None], sample_state(step, 3), pos)
            vel = torch.where(done[None], torch.zeros((), dtype=f32, device=device), vel)
            t = torch.where(done, torch.zeros_like(t), t)
            if goal is not None:
                goal = torch.where(done, sample_goal(step, 24), goal)
    return pos, vel, rew_acc, obs_acc


def rollout_cuda(kscn, n_envs: int, n_steps: int, horizon: int | None, block_envs: int,
                 seed: int, block_offset: int = 0, device=None):
    """Launch kernel K2 (``scenario_rollout_kernel<S>``, the instantiation of
    the kernel scenario) on ``device``, a CUDA device: the outputs of
    ``plain_rollout``. Raises on a spec outside what the instantiations
    compute (``_build.kernel_params``), a bad argument or a failed launch.
    Counts its launches in ``rollout_cuda.launches`` and, by scenario name,
    in ``rollout_cuda.launches_by``."""
    from mpe_tpu_torch.ops import _build

    scenario, params = _build.kernel_params(kscn)
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"rollout_cuda needs a CUDA device, got {device}")
    if n_envs % block_envs or n_envs <= 0:
        raise ValueError(f"n_envs={n_envs} must be a positive multiple of block_envs={block_envs}")
    if n_steps < 0 or (horizon is not None and horizon < 1):
        raise ValueError(f"need n_steps >= 0 and horizon >= 1 or None, got {n_steps}, {horizon}")
    spec = kscn.spec
    e, p = spec.n_entities, spec.dim_p
    f32 = torch.float32
    pos = torch.empty((e, p, n_envs), dtype=f32, device=device)
    vel = torch.empty((e, p, n_envs), dtype=f32, device=device)
    rew = torch.empty((kscn.reward_rows, n_envs), dtype=f32, device=device)
    obs_sum = torch.empty((1, n_envs), dtype=f32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _build.library().mpe_scenario_rollout(
            scenario, ctypes.byref(params), pos.data_ptr(), vel.data_ptr(), rew.data_ptr(),
            obs_sum.data_ptr(), n_envs, block_envs, n_steps, 0 if horizon is None else horizon,
            int(seed) & _MASK, int(block_offset) & _MASK, stream)
    if rc != 0:
        raise RuntimeError(f"rollout kernel K2 launch failed: {_build.error_string(rc)}")
    rollout_cuda.launches += 1
    rollout_cuda.launches_by[spec.name] += 1
    return pos, vel, rew, obs_sum


rollout_cuda.launches = 0
rollout_cuda.launches_by = collections.Counter()


def fused_rollout(scenario, n_envs: int, n_steps: int, horizon: int | None = 100,
                  block_envs: int = 1024, device=None):
    """Fused rollout for a scenario with kernel blocks:
    ``run(seed, block_offset=0) -> (pos [E, P, N], vel, rew_sum [R, N],
    obs_checksum [1, N])``, env-minor. On CUDA it launches kernel K2, on
    the CPU it runs ``plain_rollout``; ``run.plain`` is the plain version
    on the same device (for holding the kernel against it)."""
    from mpe_tpu_torch.ops.kernel_scenarios import KernelScenario, kernel_scenario

    kscn = scenario if isinstance(scenario, KernelScenario) else kernel_scenario(scenario)
    device = resolve_device(device)
    block_envs = pick_block_envs(n_envs, block_envs)
    args = (kscn, n_envs, n_steps, horizon, block_envs)

    def plain(seed, block_offset=0):
        return plain_rollout(*args, seed, block_offset, device)

    def run(seed, block_offset=0):
        if device.type == "cuda":
            return rollout_cuda(*args, seed, block_offset, device)
        return plain(seed, block_offset)

    run.plain = plain
    run.n_blocks = n_envs // block_envs
    run.block_envs = block_envs
    return run


def fused_spread_rollout(spec: ScenarioSpec, n_envs: int, n_steps: int,
                         horizon: int | None = 100, block_envs: int = 1024, device=None):
    """Fused rollout for simple_spread (the benchmark scenario). The obs
    checksum keeps observation assembly live, so the kernel measures the
    full step: decode + physics + reward + obs."""
    from mpe_tpu_torch.ops.kernel_scenarios import KernelSpread

    return fused_rollout(KernelSpread(spec), n_envs, n_steps, horizon=horizon,
                         block_envs=block_envs, device=device)
