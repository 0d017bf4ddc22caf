"""Pair physics of the fused kernels at ``MIN_MXU_PAIRS`` collide pairs or
more, as plain env-minor PyTorch (counterpart of ``mpe_tpu/ops/mxu_physics.py``).

The JAX block packs the pair math for the TPU's matrix unit: one ±1 matmul
gathers the K pair deltas, the per-pair math runs on sublane-packed
``[K, N]`` rows, and one ±1 matmul scatters the pair forces back to the
movable entities; its constant matrices are built from iotas because a
Mosaic kernel holds no array constant. Those are layout tricks of the TPU
and are not carried over. This block computes the same function directly,
in the order of the packed form's arithmetic, so that it rounds as the JAX
block does:

  - the pair deltas by indexing (a ±1 row of the gather adds exact zeros);
  - each entity's pair forces summed in pair order from zero, then the
    action force added: ``v = vel * (1 - damping) + (force + u) * (dt / m)``,
    with ``dt / m`` computed in double and rounded once;
  - the speed clamp ``v * (1 + (factor - 1))`` with ``factor = max_speed *
    rsqrt(s2)`` where ``s2 > max_speed ** 2``, the square taken in the
    working dtype; ``factor - 1`` is exact only for factor >= 1/2, so above
    twice the limit this differs from ``v * factor`` in the last bit;
  - ``pos + v * dt``.

``generic_physics_block`` (``ops/kernel_scenarios.py``) rounds otherwise: it
adds the pair forces onto ``u``, multiplies by ``dt / m`` inside and squares
``max_speed`` in double. Each matches its JAX counterpart, and the CUDA
kernels take whichever order their scenario's JAX kernel takes
(``csrc/scenario_blocks.cuh``).
"""

from __future__ import annotations

import numpy as np
import torch

from mpe_tpu_torch.core.physics import logaddexp0
from mpe_tpu_torch.core.state import ScenarioSpec


MIN_MXU_PAIRS = 4     # below it the JAX kernels take generic_physics_block


def collide_pairs(spec: ScenarioSpec) -> list[tuple[int, int]]:
    """(i, j) entity pairs that exert contact forces: both collide, at
    least one movable (core.py:151-169)."""
    return [(i, j)
            for i in range(spec.n_entities) for j in range(i + 1, spec.n_entities)
            if spec.collide[i] and spec.collide[j] and (spec.movable[i] or spec.movable[j])]


def mxu_physics_block(spec: ScenarioSpec, pos, vel, move):
    """One core.py:117-169 step: pos/vel ``[E, P, N]``, move ``[A, 5, N]`` ->
    (pos, vel), in the packed form's order (module docstring). Below
    ``MIN_MXU_PAIRS`` collide pairs it is ``generic_physics_block``, as in
    the JAX package."""
    from mpe_tpu_torch.ops.kernel_scenarios import decode_move_block, generic_physics_block

    pairs = collide_pairs(spec)
    if len(pairs) < MIN_MXU_PAIRS:
        return generic_physics_block(spec, pos, vel, move)

    a, e = spec.n_agents, spec.n_entities
    dtype, dev = pos.dtype, pos.device
    tiny = torch.finfo(dtype).tiny
    k = float(spec.contact_margin)
    # a tensor divisor: PyTorch divides by a Python scalar on CUDA as a
    # multiply by its reciprocal, which rounds differently from x / k
    k_div = torch.full((), k, dtype=dtype, device=dev)
    cf = float(spec.contact_force)
    damping, dt = float(spec.damping), float(spec.dt)

    u = decode_move_block(spec, move)                                # [A, P, N]
    force = [None] * e
    for i, j in pairs:
        delta = pos[i] - pos[j]                                      # [P, N]
        d2 = delta.square().sum(0, keepdim=True)
        inv = torch.rsqrt(d2.clamp_min(tiny))
        dist = d2 * inv
        x = -(dist - float(spec.size[i] + spec.size[j])) / k_div
        f = ((cf * (logaddexp0(x) * k)) * inv) * delta
        if spec.movable[i]:
            force[i] = f if force[i] is None else force[i] + f
        if spec.movable[j]:
            force[j] = -f if force[j] is None else force[j] - f

    new_pos, new_vel = [], []
    for i in range(e):
        if not spec.movable[i]:
            new_pos.append(pos[i])
            new_vel.append(vel[i])
            continue
        f = force[i]
        if i < a:
            f = u[i] if f is None else f + u[i]
        elif f is None:
            f = torch.zeros_like(vel[i])
        v = vel[i] * (1.0 - damping) + f * (dt / float(spec.initial_mass[i]))
        ms = float(spec.max_speed[i])
        if np.isfinite(ms):
            s2 = v.square().sum(0, keepdim=True)
            inv_s = torch.rsqrt(s2.clamp_min(tiny))
            ms2 = torch.tensor(ms, dtype=dtype).square().item()      # squared in dtype
            factor = torch.where(s2 > ms2, inv_s * ms, torch.ones((), dtype=dtype, device=dev))
            v = v * (1.0 + (factor - 1.0))
        new_vel.append(v)
        new_pos.append(pos[i] + v * dt)
    return torch.stack(new_pos), torch.stack(new_vel)
