"""Batched point-mass physics step (PyTorch counterpart of
``mpe_tpu/core/physics.py``; reference multiagent/core.py:117-196).

  apply_action_force      -> masked add of the [..., A, P] action force
  apply_environment_force -> one [..., E, E, P] pairwise soft-collision
                             tensor, masked and summed over partners
  integrate_state         -> damping, F/m*dt, speed clamp, x += v*dt
  update_agent_state      -> masked comm write

As in the JAX package: damping is applied before the force, the masked
diagonal and an exact overlap of two colliders give a zero force instead
of the reference's NaN, non-movable entities are frozen, silent agents'
comm is zeroed, and noise is gated per agent by ``u_noise``/``c_noise > 0``.
"""

from __future__ import annotations

import torch

from mpe_tpu_torch._device import device_table
from mpe_tpu_torch.core.state import ScenarioSpec, WorldState


def logaddexp0(x: torch.Tensor) -> torch.Tensor:
    """``logaddexp(0, x)`` as ``max(x, 0) + log1p(exp(-|x|))``, the form of
    ``jnp.logaddexp`` and of the CUDA kernels: finite for the |x| in the
    thousands that a 1e-3 contact margin gives."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def collision_forces(spec: ScenarioSpec, pos: torch.Tensor) -> torch.Tensor:
    """Pairwise soft-collision forces summed per entity: ``[..., E, P]``.

    penetration = logaddexp(0, -(dist - dist_min)/k) * k;
    force_ab = contact_force * delta/dist * penetration (core.py:180-196).
    """
    dtype, dev = pos.dtype, pos.device
    e = spec.n_entities
    delta = pos[..., :, None, :] - pos[..., None, :, :]          # [..., E, E, P]
    dist2 = delta.square().sum(-1)                               # [..., E, E]
    collide = device_table(spec.collide, device=dev)
    pair_mask = (collide[:, None] & collide[None, :]
                 & ~torch.eye(e, dtype=torch.bool, device=dev))
    safe_dist = torch.where(dist2 > 0, dist2, torch.ones((), dtype=dtype, device=dev)).sqrt()
    dist_min = device_table(spec.size[:, None] + spec.size[None, :], dtype, dev)
    k = device_table(spec.contact_margin, dtype, dev)
    x = -(safe_dist - dist_min) / k
    penetration = logaddexp0(x) * k
    coeff = torch.where(pair_mask & (dist2 > 0),
                        spec.contact_force * penetration / safe_dist,
                        torch.zeros((), dtype=dtype, device=dev))
    return (delta * coeff[..., None]).sum(-2)


def step_world(
    spec: ScenarioSpec,
    state: WorldState,
    u: torch.Tensor,
    c: torch.Tensor,
    generator: torch.Generator | None = None,
    normals: tuple[torch.Tensor | None, torch.Tensor | None] | None = None,
) -> WorldState:
    """One physics step: action forces ``u`` [..., A, P] and comm ``c``
    [..., A, C] in, next WorldState out.

    Noise (only where the spec sets ``u_noise``/``c_noise``) uses standard
    normals drawn from ``generator``, or the ``normals = (for_u, for_c)``
    given, so a test can inject the values JAX drew. Without either, no
    noise is added (the JAX step without a key).
    """
    dtype, dev = state.pos.dtype, state.pos.device
    a = spec.n_agents
    u = u.to(dtype)
    c = c.to(dtype)
    noisy = generator is not None or normals is not None
    n_u, n_c = normals if normals is not None else (None, None)

    if noisy and (spec.u_noise > 0).any():
        if n_u is None:
            n_u = torch.randn(u.shape, generator=generator, dtype=dtype, device=dev)
        gate = device_table(spec.u_noise, dtype, dev)[:, None]
        u = u + n_u.to(dtype) * gate
    agent_movable = device_table(spec.movable[:a], dtype, dev)[:, None]
    force = torch.zeros_like(state.pos)
    force[..., :a, :] = u * agent_movable

    force = force + collision_forces(spec, state.pos)

    mass = device_table(spec.initial_mass, dtype, dev)[:, None]
    vel = state.vel * (1 - spec.damping)
    vel = vel + force / mass * spec.dt
    speed = vel.square().sum(-1, keepdim=True).sqrt()
    max_speed = device_table(spec.max_speed, dtype, dev)[:, None]
    over = speed > max_speed                                     # inf => never
    safe_speed = torch.where(speed > 0, speed, torch.ones((), dtype=dtype, device=dev))
    vel = torch.where(over, vel / safe_speed * max_speed, vel)
    movable = device_table(spec.movable, device=dev)[:, None]
    vel = torch.where(movable, vel, state.vel)
    pos = torch.where(movable, state.pos + vel * spec.dt, state.pos)

    if noisy and (spec.c_noise > 0).any():
        if n_c is None:
            n_c = torch.randn(c.shape, generator=generator, dtype=dtype, device=dev)
        gate = device_table(spec.c_noise, dtype, dev)[:, None]
        c = c + n_c.to(dtype) * gate
    silent = device_table(spec.silent, device=dev)[:, None]
    comm = torch.where(silent, torch.zeros((), dtype=dtype, device=dev), c)

    return state.replace(pos=pos, vel=vel, comm=comm, t=state.t + 1)
